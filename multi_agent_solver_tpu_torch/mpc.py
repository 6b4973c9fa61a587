"""Receding-horizon MPC: warm-started repeated solves, closed loop.

PyTorch counterpart of ``multi_agent_solver_tpu/mpc.py``:

* :func:`mpc_step` -- one receding-horizon step: solve from the measured
  state with the shifted previous plan as warm start, return the first
  control and the next warm start;
* :func:`run_mpc` -- one problem's closed loop;
* :func:`run_mpc_batched` -- a fleet's closed loop, each step ONE batched
  solve (``solve_ilqr_batched``: the fused loop's kernels on the card);
* :func:`run_mpc_nash` -- a coupled Nash game in closed loop, each step a
  full call of the strategy's sweeps.

A Python loop replaces ``lax.scan``.  The carry (state, warm start) and the
outputs stay on the spec's device, and the loop itself makes no host sync
(the solves make their own, once an iteration); the outputs are stacked
once, at the end.  The plant step is :func:`integrators.integrate_rk4`,
mapped over a batch with ``torch.func.vmap``, so a plant written for one
problem drives a fleet, as JAX's ``vmap`` makes it.  The warm-start shift
``u_warm = [u_1..u_{T-1}, u_{T-1}]`` (repeat-last) is the standard
receding-horizon initialization.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.func import vmap

from .integrators import integrate_rk4
from .ocp import OCPSpec
from .solvers.base import SolveResult
from .types import Tensor


class MPCStep(NamedTuple):
    control: Tensor          # u_0 applied to the plant [nu]
    next_warm_start: Tensor  # shifted plan for the next step [T, nu]
    result: SolveResult      # full solver output (predicted trajectory etc.)


def shift_warm_start(controls: Tensor, fill: str = "repeat") -> Tensor:
    """Shift the plan ``[..., T, nu]`` one step: drop u_0, append a fill
    control (``"repeat"``: u_{T-1}; ``"zero"``: zeros)."""
    if fill == "repeat":
        tail = controls[..., -1:, :]
    elif fill == "zero":
        tail = torch.zeros_like(controls[..., -1:, :])
    else:
        raise ValueError(f"unknown fill '{fill}'")
    return torch.cat([controls[..., 1:, :], tail], dim=-2)


def mpc_step(
    spec: OCPSpec,
    solve_fn: Callable[[OCPSpec], SolveResult],
    x_measured: Tensor,
    u_warm: Tensor,
    fill: str = "repeat",
) -> MPCStep:
    """One receding-horizon step."""
    result = solve_fn(spec.replace(initial_state=x_measured, initial_controls=u_warm))
    return MPCStep(
        control=result.controls[0],
        next_warm_start=shift_warm_start(result.controls, fill),
        result=result,
    )


class MPCTrace(NamedTuple):
    states: Tensor      # closed-loop plant states [N+1, nx]
    controls: Tensor    # applied controls [N, nu]
    costs: Tensor       # solver cost per step [N]
    iterations: Tensor  # solver iterations per step [N]


def _plant_step(plant, dt: float):
    """RK4 step of ``plant`` over a batch of (state, control) rows."""
    return vmap(lambda x, u: integrate_rk4(x, u, dt, plant))


def run_mpc(
    spec: OCPSpec,
    solve_fn: Callable[[OCPSpec], SolveResult],
    n_steps: int,
    x0: Optional[Tensor] = None,
    plant_dynamics: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    plant_dt: Optional[float] = None,
    fill: str = "repeat",
) -> MPCTrace:
    """One problem's closed loop of ``n_steps`` steps.

    ``plant_dynamics`` defaults to the model dynamics (perfect-model MPC);
    pass a different function to simulate model mismatch.
    """
    x0 = spec.initial_state if x0 is None else x0
    plant = plant_dynamics or spec.dynamics
    dt = spec.dt if plant_dt is None else plant_dt
    x, u_warm = x0, spec.initial_controls
    xs, us, costs, iters = [x0], [], [], []
    for _ in range(n_steps):
        step = mpc_step(spec, solve_fn, x, u_warm, fill)
        x = integrate_rk4(x, step.control, dt, plant)
        u_warm = step.next_warm_start
        xs.append(x)
        us.append(step.control)
        costs.append(step.result.cost)
        iters.append(step.result.iterations)
    return MPCTrace(states=torch.stack(xs), controls=torch.stack(us),
                    costs=torch.stack(costs), iterations=torch.stack(iters))


def run_mpc_batched(
    specs: OCPSpec,
    batched_solve_fn: Callable[[OCPSpec], SolveResult],
    n_steps: int,
    plant_dynamics: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    plant_dt: Optional[float] = None,
    fill: str = "repeat",
) -> MPCTrace:
    """A fleet's closed loop: ``specs`` carries a leading batch axis
    ``[B, ...]`` and ``batched_solve_fn`` solves the whole batch in one call
    (e.g. ``solve_ilqr_batched``), so each step is ONE batched solve.
    Returns step-major leaves: states ``[N+1, B, nx]``, controls
    ``[N, B, nu]``, costs and iterations ``[N, B]``."""
    plant = _plant_step(plant_dynamics or specs.dynamics,
                        specs.dt if plant_dt is None else plant_dt)
    x0 = specs.initial_state                                   # [B, nx]
    x, u_warm = x0, specs.initial_controls                     # [B, T, nu]
    xs, us, costs, iters = [x0], [], [], []
    for _ in range(n_steps):
        result = batched_solve_fn(specs.replace(initial_state=x, initial_controls=u_warm))
        u0 = result.controls[:, 0]                             # [B, nu]
        u_warm = shift_warm_start(result.controls, fill)
        x = plant(x, u0)
        xs.append(x)
        us.append(u0)
        costs.append(result.cost)
        iters.append(result.iterations)
    return MPCTrace(states=torch.stack(xs), controls=torch.stack(us),
                    costs=torch.stack(costs), iterations=torch.stack(iters))


def run_mpc_nash(
    problem,
    strategy,
    n_steps: int,
    plant_dynamics: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
    plant_dt: Optional[float] = None,
    fill: str = "repeat",
) -> MPCTrace:
    """A coupled Nash game in closed loop: each step runs the strategy's
    sweeps (coupling contexts refreshed from the agents' newest plans) from
    the measured joint state, applies every agent's first control to its
    plant and shifts the warm starts.

    ``problem``: a homogeneous ``MultiAgentProblem`` (optionally with
    ``inter_agent_cost``); ``strategy``: a Nash strategy of
    ``strategies.make_strategy`` -- ``sequential``, ``linesearch`` or
    ``trustregion``; each step runs its ``_run_stacked`` (the line search's
    backtracking and the trust regions' radii start afresh every step, as
    in the JAX package).  Returns step-major leaves: states
    ``[n_steps+1, N, nx]``, controls ``[n_steps, N, nu]``, costs
    ``[n_steps, N]``, and zero iterations ``[n_steps]``.
    """
    from .strategies.base import stack_agent_specs

    if not problem.blocks:
        problem.compute_offsets()
    specs = stack_agent_specs(problem, strategy.solver_proto.device)
    specs = strategy._prepare(problem, specs)
    plant = _plant_step(plant_dynamics or specs.dynamics,
                        specs.dt if plant_dt is None else plant_dt)
    x0 = specs.initial_state                                   # [N, nx]
    x, warm = x0, specs.initial_controls
    xs, us, costs = [x0], [], []
    for _ in range(n_steps):
        _, controls, step_costs = strategy._run_stacked(
            specs.replace(initial_state=x, initial_controls=warm))
        u0 = controls[:, 0]                                    # [N, nu]
        warm = shift_warm_start(controls, fill)
        x = plant(x, u0)
        xs.append(x)
        us.append(u0)
        costs.append(step_costs)
    return MPCTrace(states=torch.stack(xs), controls=torch.stack(us), costs=torch.stack(costs),
                    iterations=torch.zeros(n_steps, dtype=torch.int32, device=x0.device))
