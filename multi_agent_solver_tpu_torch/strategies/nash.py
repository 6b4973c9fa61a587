"""Nash best-response strategies over stacked agent lanes.

Counterpart of ``multi_agent_solver_tpu/strategies/nash.py``.  A Jacobi
sweep is ONE batched solver call over the agents stacked as batch lanes
(the fused loop's kernels on the card); the outer loop over sweeps is a
Python loop.

* ``sequential`` -- ``max_outer`` unconditional Jacobi sweeps: solve every
  agent from its warm start, then warm-start every agent from its new
  plan.

**Coupled games.**  With ``MultiAgentProblem.inter_agent_cost`` set, each
agent's stage cost gains ``sum_j inter_agent_cost(x_i, x_j, t)`` against
the other agents' current plans, delivered as the spec's per-stage
``context`` (``[N, T, K, nx]``: all N-1 others, or the K nearest by
``coupling_distance_dims`` when ``coupling_neighbors`` is set) and
refreshed every sweep.  The strategy finds the cost's structure once per
call and hands it to every sweep's solve -- the counterpart of the JAX
strategy tracing its whole sweep loop once.

Heterogeneous agents and the host loop are not ported yet and raise
``NotImplementedError``; so do ``linesearch`` and ``trustregion``
(``strategies.make_strategy``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..multi_agent import MultiAgentProblem
from ..ocp import OCPSpec, with_context_cost
from ..solution import Solution
from ..solvers.base import SolverBase
from ..types import SolverParams, coupled_device_fn, device_fn_of
from .base import (
    agents_are_homogeneous,
    collect_solution,
    register_strategy,
    scatter_stacked_results,
    stack_agent_specs,
)


@functools.lru_cache(maxsize=None)
def make_coupled_stage(base_stage, inter):
    """Stage cost plus the summed pairwise coupling against a per-stage
    context ``ctx [..., K, nx]`` (the K other agents' states).

    Memoized on (base_stage, inter) identity so that every consumer gets
    the same function object.  The pair costs are summed in index order,
    as the CUDA ``Coupled`` device function sums them.  When both parts
    carry a device-function tag, so does the result.
    """

    def coupled_stage(x, u, t, ctx):
        tk = t[..., None] if torch.is_tensor(t) and t.dim() > 0 else t
        pair = inter(x[..., None, :], ctx, tk)           # [..., K]
        total = pair.new_zeros(pair.shape[:-1])
        for k in range(pair.shape[-1]):
            total = total + pair[..., k]
        return base_stage(x, u, t) + total

    base_tag, pair_tag = device_fn_of(base_stage), device_fn_of(inter)
    if base_tag is not None and pair_tag is not None:
        coupled_stage.device_fn = coupled_device_fn(base_tag, pair_tag)
    return coupled_stage


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: queue 1, multi-agent -- {item})")


class _NashBase:
    name = "nash"

    def __init__(self, max_outer: int, solver_proto: SolverBase, params: SolverParams):
        self.max_outer = int(max_outer)
        self.solver_proto = solver_proto
        self.params = dict(params)
        self._config = type(solver_proto).config_cls.from_params(self.params)

    # -- solver hook ----------------------------------------------------
    def _batched_solve(self, specs: OCPSpec, structure):
        return self.solver_proto._solve_batched_fn(specs, self._config, structure)

    # -- coupling machinery ---------------------------------------------
    def _prepare(self, problem: MultiAgentProblem, specs: OCPSpec) -> OCPSpec:
        """Set up the context builder for this agent count; returns the
        specs with the coupled stage cost."""
        n = specs.initial_state.shape[0]
        inter = problem.inter_agent_cost
        self._coupled = inter is not None
        if not self._coupled:
            self._ctx_for = None
            return specs

        k_neighbors = problem.coupling_neighbors
        if k_neighbors is not None and k_neighbors >= n - 1:
            k_neighbors = None   # all pairs is cheaper than a KNN of everyone
        dev = specs.initial_state.device

        if k_neighbors is None:
            others = torch.as_tensor(np.array(
                [[j for j in range(n) if j != i] for i in range(n)], np.int64).reshape(n, n - 1),
                device=dev)                                   # [N, N-1]

            def ctx_for(states):  # [N, T+1, nx] -> [N, T, N-1, nx]
                return states[others][:, :, :-1, :].transpose(1, 2)
        else:
            K = int(k_neighbors)
            dims = torch.as_tensor(problem.coupling_distance_dims, device=dev)
            T = specs.horizon_steps

            def ctx_for(states):  # [N, T+1, nx] -> [N, T, K, nx]
                st = states[:, :T, :]                                 # [N, T, nx]
                pos = st[:, :, dims]                                  # [N, T, d]
                d2 = ((pos[:, None] - pos[None, :]) ** 2).sum(-1)     # [N, N, T]
                eye = torch.eye(n, dtype=d2.dtype, device=dev)
                d2 = d2 + 1e30 * eye[:, :, None]                      # no self
                # The K nearest others per (agent, t); a stable sort keeps
                # the lower index first at a tie, as lax.top_k does.
                order = torch.sort(d2.permute(0, 2, 1), dim=-1, stable=True).indices
                idx = order[..., :K]                                  # [N, T, K]
                ts = torch.arange(T, device=dev)[None, :, None]
                return st[idx, ts]                                    # [N, T, K, nx]

        self._ctx_for = ctx_for
        return with_context_cost(specs, make_coupled_stage(specs.stage_cost, inter))

    def _objective(self, specs: OCPSpec, controls, context):
        """Per-agent cost of rolled-out controls (context-aware): ``([N], states)``."""
        xs = specs.rollout(controls)
        s = specs.replace(context=context) if self._coupled else specs
        return s.cost(xs, controls), xs

    def _initial_states(self, specs: OCPSpec):
        return specs.rollout(specs.initial_controls)

    def _initial_state_costs(self, specs: OCPSpec):
        xs0 = self._initial_states(specs)
        ctx0 = self._ctx_for(xs0) if self._coupled else None
        costs0, _ = self._objective(specs, specs.initial_controls, ctx0)
        return xs0, costs0

    def _sweep_specs(self, specs: OCPSpec, warm, states) -> OCPSpec:
        s = specs.replace(initial_controls=warm)
        if self._coupled:
            s = s.replace(context=self._ctx_for(states))
        return s

    def _finalize(self, specs: OCPSpec, states, controls):
        """Final per-agent costs against the FINAL joint plans."""
        ctx = self._ctx_for(states) if self._coupled else None
        costs, _ = self._objective(specs, controls, ctx)
        return states, controls, costs

    # -- template method -------------------------------------------------
    def _run_stacked(self, specs: OCPSpec):
        raise NotImplementedError

    def __call__(self, problem: MultiAgentProblem) -> Solution:
        if not problem.blocks:
            problem.compute_offsets()
        if not agents_are_homogeneous(problem):
            raise _not_ported("agents with differing problem functions or dimensions "
                              "(padded heterogeneous stacking, the host loop)",
                              "heterogeneous agents")
        specs = stack_agent_specs(problem, self.solver_proto.device)
        specs = self._prepare(problem, specs)
        states, controls, costs = self._run_stacked(specs)
        scatter_stacked_results(problem, states, controls, costs)
        return collect_solution(problem)


@register_strategy
class SequentialNashStrategy(_NashBase):
    """``max_outer`` unconditional Jacobi sweeps."""

    name = "sequential"

    def _run_stacked(self, specs: OCPSpec):
        warm, states = specs.initial_controls, self._initial_states(specs)
        structure = None
        for sweep in range(self.max_outer):
            sweep_specs = self._sweep_specs(specs, warm, states)
            if sweep == 0:
                structure = self.solver_proto.resolve_structure(sweep_specs, self._config)
            results = self._batched_solve(sweep_specs, structure)
            warm, states = results.controls, results.states
        return self._finalize(specs, states, warm)

