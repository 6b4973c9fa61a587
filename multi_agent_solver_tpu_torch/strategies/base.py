"""Strategy infrastructure: stacking homogeneous agents into one batched solve.

Counterpart of ``multi_agent_solver_tpu/strategies/base.py``.  Agents that
share their problem functions and dimensions differ only in their tensors
(initial state, warm start, bounds); their specs stack along a leading
batch axis, so a Nash sweep is ONE batched solver call with every agent a
batch lane.  Agents of mixed types are padded to one stack
(``strategies/hetero.py``) or, where they cannot be, solved one by one in
a host loop.
"""

from __future__ import annotations

import re
from typing import Dict

import torch

from ..multi_agent import MultiAgentProblem
from ..ocp import OCP, OCPSpec
from ..solution import Solution
from ..solvers.base import SolverBase
from ..types import SolverParams, resolve_device


def _statics(ocp: OCP) -> tuple:
    """What the JAX package's spec tree structure compares: the problem
    functions, dimensions, and which bounds -- input and state -- are set."""
    return (ocp.dynamics, ocp.stage_cost, ocp.terminal_cost, ocp.objective_function,
            ocp.equality_constraints, ocp.inequality_constraints,
            ocp.dynamics_state_jacobian, ocp.dynamics_control_jacobian,
            ocp.state_dim, ocp.control_dim, ocp.horizon_steps, float(ocp.dt),
            ocp.derivative_mode, ocp.input_lower_bounds is None, ocp.input_upper_bounds is None,
            ocp.state_lower_bounds is None, ocp.state_upper_bounds is None)


def agents_are_homogeneous(problem: MultiAgentProblem) -> bool:
    """True when all agents share problem functions and dimensions, so their
    specs differ only in tensors and stack into batch lanes."""
    if not problem.blocks:
        problem.compute_offsets()
    keys = [_statics(b.agent.ocp) for b in problem.blocks]
    return bool(keys) and all(k == keys[0] for k in keys[1:])


def stack_agent_specs(problem: MultiAgentProblem, device=None) -> OCPSpec:
    """Agent i's spec leaves as lane i of one spec, on ``device`` (default:
    where they are)."""
    specs = [b.agent.ocp.spec() for b in problem.blocks]
    dev = specs[0].initial_state.device if device is None else resolve_device(device)

    def stack(name):
        if getattr(specs[0], name) is None:
            return None
        return torch.stack([getattr(s, name).to(dev) for s in specs])

    return specs[0].replace(**{name: stack(name) for name in (
        "initial_state", "initial_controls", "input_lower_bounds", "input_upper_bounds")})


def scatter_stacked_results(problem: MultiAgentProblem, states, controls, costs) -> None:
    """Write lane i of the stacked result back into agent i's OCP.

    Each stacked tensor is fetched to the host ONCE: indexing a device
    tensor per agent would cost one device round trip per agent.
    """
    states, controls = states.cpu(), controls.cpu()
    costs = costs.cpu().tolist()
    for i, block in enumerate(problem.blocks):
        block.agent.ocp.set_result(states[i], controls[i], costs[i])


def collect_solution(problem: MultiAgentProblem) -> Solution:
    """Gather the agents' best trajectories and costs; the total is summed
    as host floats."""
    sol = Solution()
    total = 0.0
    for block in problem.blocks:
        ocp = block.agent.ocp
        sol.states.append(ocp.best_states)
        sol.controls.append(ocp.best_controls)
        sol.costs.append(ocp.best_cost)
        total += float(ocp.best_cost)
    sol.total_cost = total
    return sol


_STRATEGIES: Dict[str, type] = {}


def register_strategy(cls):
    _STRATEGIES[cls.name] = cls
    return cls


_STRATEGY_ALIASES = {
    "centralized": "centralized",
    "centralised": "centralized",
    "sequential": "sequential",
    "sequentialnash": "sequential",
    "linesearch": "linesearch",
    "linesearchnash": "linesearch",
    "trustregion": "trustregion",
    "trustregionnash": "trustregion",
}


def canonical_strategy_name(name: str) -> str:
    key = re.sub(r"[^a-z0-9]", "", name.lower())
    if key not in _STRATEGY_ALIASES:
        raise ValueError(f"Unknown strategy '{name}'.")
    return _STRATEGY_ALIASES[key]


def available_strategy_names():
    return sorted(_STRATEGIES.keys())


def make_strategy(name: str, solver: SolverBase, params: SolverParams, max_outer: int):
    """The strategy ``name`` over ``solver`` with ``params``: the centralized
    strategy takes the solver with its params set (``max_outer`` unused),
    the Nash strategies ``max_outer`` sweeps."""
    canonical = canonical_strategy_name(name)
    cls = _STRATEGIES[canonical]
    if canonical == "centralized":
        solver.set_params(params)
        return cls(solver)
    return cls(max_outer, solver, params)


def solve(strategy, problem: MultiAgentProblem) -> Solution:
    """Free-function visitor."""
    return strategy(problem)
