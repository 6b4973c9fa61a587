"""Nash best-response strategies over stacked agent lanes.

Counterpart of ``multi_agent_solver_tpu/strategies/nash.py``.  A Jacobi
sweep is ONE batched solver call over the agents stacked as batch lanes
(the fused loop's kernels on the card); the outer loop over sweeps is a
Python loop.

* ``sequential`` -- ``max_outer`` unconditional Jacobi sweeps: solve every
  agent from its warm start, then warm-start every agent from its new
  plan.  Despite the name it is parallel Jacobi, not Gauss-Seidel.
* ``linesearch`` -- after a sweep that raises the total cost, backtrack one
  global alpha over 0.5, 0.25, ... 0.5^9 (> 1e-3), blending
  ``u = old + alpha (candidate - old)`` for every agent at once, and keep
  the first alpha that lowers the total, else the old plans.  The nine
  trials are costed in one batched call (an alpha axis in front of the
  agents); in a coupled game each trial's contexts come from its own
  rollouts.
* ``trustregion`` -- a radius per agent (1.0 at first): a candidate step
  longer than its radius is scaled back to it and costed against the
  pre-sweep plans of the others, a shorter one keeps the solver's own
  trajectory and cost; an improving candidate is kept and its radius
  grows 1.5x, else the old plan stays and the radius halves.

**Coupled games.**  With ``MultiAgentProblem.inter_agent_cost`` set, each
agent's stage cost gains ``sum_j inter_agent_cost(x_i, x_j, t)`` against
the other agents' current plans, delivered as the spec's per-stage
``context`` (``[N, T, K, nx]``: all N-1 others, or the K nearest by
``coupling_distance_dims`` when ``coupling_neighbors`` is set) and
refreshed every sweep.  Each stacked strategy finds the cost's structure
once per call and hands it to every sweep's solve -- the counterpart of
the JAX strategy tracing its whole sweep loop once.

**Mixed agent types** run on the same stacked path, padded with
type-indicator states (``strategies/hetero.py``); a mix that cannot be
padded (differing horizon, dt, derivative mode or objective) runs the host
loop ``_run_host``, one single-problem solve an agent, uncoupled only.
"""

from __future__ import annotations

import functools
from typing import List

import numpy as np
import torch

from ..multi_agent import MultiAgentProblem
from ..ocp import OCPSpec, rollout_and_cost, with_context_cost
from ..solution import Solution
from ..solvers.base import SolverBase, make_solver_like
from ..types import SolverParams, coupled_device_fn, device_fn_of
from .base import (
    agents_are_homogeneous,
    collect_solution,
    register_strategy,
    scatter_stacked_results,
    stack_agent_specs,
)
from .hetero import scatter_padded_results, stack_agent_specs_padded


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

    def _sweeper(self, specs: OCPSpec):
        """``sweep(warm, states)``: one Jacobi sweep, the batched solve of
        every agent from ``warm`` with contexts from ``states``.  The cost
        structure is resolved at the first sweep and handed to the others."""
        structure = []

        def sweep(warm, states):
            sweep_specs = self._sweep_specs(specs, warm, states)
            if not structure:
                structure.append(self.solver_proto.resolve_structure(sweep_specs, self._config))
            return self._batched_solve(sweep_specs, structure[0])

        return sweep

    # -- coupling machinery ---------------------------------------------
    def _prepare(self, problem: MultiAgentProblem, specs: OCPSpec) -> OCPSpec:
        """Set up the context builder for this agent count; returns the
        specs with the coupled stage cost.  The builder takes states
        ``[..., N, T+1, nx]`` with any leading axes (the line search's
        trials) and gives ``[..., N, T, K, nx]``."""
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

            def ctx_for(states):  # [..., N, T+1, nx] -> [..., N, T, N-1, nx]
                return states[..., others, :-1, :].transpose(-3, -2)
        else:
            K = int(k_neighbors)
            dims = torch.as_tensor(problem.coupling_distance_dims, device=dev)
            T = specs.horizon_steps

            def ctx_for(states):  # [..., N, T+1, nx] -> [..., N, T, K, nx]
                st = states[..., :T, :]                               # [..., N, T, nx]
                pos = st[..., dims]                                   # [..., N, T, d]
                d2 = ((pos[..., :, None, :, :] - pos[..., None, :, :, :]) ** 2).sum(-1)
                eye = torch.eye(n, dtype=d2.dtype, device=dev)
                d2 = d2 + 1e30 * eye[:, :, None]                      # [..., N, N, T], no self
                # The K nearest others per (agent, t); a stable sort keeps
                # the lower index first at a tie, as lax.top_k does.
                order = torch.sort(d2.transpose(-1, -2), dim=-1, stable=True).indices
                idx = order[..., :K].transpose(-3, -2)                # [..., T, N, K]
                flat = idx.reshape(idx.shape[:-2] + (-1, 1))          # [..., T, N K, 1]
                near = torch.take_along_dim(st.transpose(-3, -2), flat, dim=-2)
                return near.reshape(idx.shape + (st.shape[-1],)).transpose(-4, -3)

        self._ctx_for = ctx_for
        return with_context_cost(specs, make_coupled_stage(specs.stage_cost, inter))

    def _objective(self, specs: OCPSpec, controls, context, states=None):
        """Per-agent cost of controls ``[..., N, T, nu]`` rolled out (or of
        the given ``states``), context-aware: ``([..., N], states)``."""
        xs = specs.rollout(controls) if states is None else states
        s = specs.replace(context=context) if self._coupled else specs
        return s.cost(xs, controls), xs

    def _initial_states(self, specs: OCPSpec):
        return specs.rollout(specs.initial_controls)

    def _initial_state_costs(self, specs: OCPSpec):
        xs0 = self._initial_states(specs)
        ctx0 = self._ctx_for(xs0) if self._coupled else None
        costs0, _ = self._objective(specs, specs.initial_controls, ctx0, xs0)
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

    def _run_host(self, problem: MultiAgentProblem) -> None:
        raise NotImplementedError

    def __call__(self, problem: MultiAgentProblem) -> Solution:
        if not problem.blocks:
            problem.compute_offsets()
        meta = None
        device = self.solver_proto.device
        if agents_are_homogeneous(problem):
            specs = stack_agent_specs(problem, device)
        else:
            # Mixed agent types: padded to uniform dims with type-indicator
            # states (strategies/hetero.py), so a sweep stays one batched
            # solve.
            specs, meta = stack_agent_specs_padded(problem, device)
        if specs is not None:
            specs = self._prepare(problem, specs)
            states, controls, costs = self._run_stacked(specs)
            if meta is None:
                scatter_stacked_results(problem, states, controls, costs)
            else:
                scatter_padded_results(problem, meta, states, controls, costs)
        else:
            if problem.inter_agent_cost is not None:
                raise NotImplementedError(
                    "inter-agent coupling requires agents stackable by padding (equal "
                    "horizon and dt, AD mode, default objective)")
            self._run_host(problem)
        return collect_solution(problem)

    def _make_host_solvers(self, problem: MultiAgentProblem) -> List[SolverBase]:
        """One solver an agent, of the prototype's type and device, with the
        strategy's params."""
        solvers = []
        for _ in problem.blocks:
            s = make_solver_like(self.solver_proto)
            s.set_params(self.params)
            solvers.append(s)
        return solvers


@register_strategy
class SequentialNashStrategy(_NashBase):
    """``max_outer`` unconditional Jacobi sweeps."""

    name = "sequential"

    def _run_stacked(self, specs: OCPSpec):
        sweep = self._sweeper(specs)
        warm, states = specs.initial_controls, self._initial_states(specs)
        for _ in range(self.max_outer):
            results = sweep(warm, states)
            warm, states = results.controls, results.states
        return self._finalize(specs, states, warm)

    def _run_host(self, problem: MultiAgentProblem) -> None:
        solvers = self._make_host_solvers(problem)
        for _ in range(self.max_outer):
            for solver, block in zip(solvers, problem.blocks):   # Jacobi: solve all
                solver.solve(block.agent.ocp)
            for block in problem.blocks:                          # then update all
                block.agent.update_initial_with_best()


@register_strategy
class LineSearchNashStrategy(_NashBase):
    """Jacobi sweeps with global-alpha backtracking."""

    name = "linesearch"
    # 0.5 .. 0.5^9 ~ 0.002, the alphas above 1e-3.
    ALPHAS = tuple(0.5**k for k in range(1, 10))

    def _run_stacked(self, specs: OCPSpec):
        x0 = specs.initial_state
        alphas = torch.tensor(self.ALPHAS, dtype=x0.dtype, device=x0.device)[:, None, None, None]
        # The trials' specs: the agents' initial states under the alpha axis.
        trial_specs = specs.replace(initial_state=x0.expand((len(self.ALPHAS),) + x0.shape))
        sweep = self._sweeper(specs)
        best_x, best_costs = self._initial_state_costs(specs)
        best_u, base_cost = specs.initial_controls, best_costs.sum()
        for _ in range(self.max_outer):
            results = sweep(best_u, best_x)
            new_cost = results.cost.sum()
            if bool(new_cost < base_cost):
                best_u, best_x, best_costs = results.controls, results.states, results.cost
                base_cost = new_cost
                continue
            # Backtrack: the nine trials at once, alpha the leading axis.
            us = best_u + alphas * (results.controls - best_u)        # [9, N, T, nu]
            xs = ctx = None
            if self._coupled:
                xs = trial_specs.rollout(us)
                ctx = self._ctx_for(xs)
            costs, xs = self._objective(trial_specs, us, ctx, xs)
            totals = costs.sum(-1)
            ok = totals < base_cost
            if bool(ok.any()):
                i = int(torch.argmax(ok.to(torch.int8)))             # the first, largest alpha
                best_u, best_x, best_costs, base_cost = us[i], xs[i], costs[i], totals[i]
        return self._finalize(specs, best_x, best_u)

    def _run_host(self, problem: MultiAgentProblem) -> None:
        solvers = self._make_host_solvers(problem)
        blocks = problem.blocks
        base_cost = sum(float(b.agent.ocp.best_cost) for b in blocks)
        for _ in range(self.max_outer):
            old = [(b.agent.ocp.best_controls, b.agent.ocp.best_states, b.agent.ocp.best_cost)
                   for b in blocks]
            for solver, block in zip(solvers, blocks):
                solver.solve(block.agent.ocp)
            for block in blocks:
                block.agent.update_initial_with_best()
            new_cost = sum(float(b.agent.ocp.best_cost) for b in blocks)
            if new_cost < base_cost:
                base_cost = new_cost
                continue
            cand = [b.agent.ocp.best_controls for b in blocks]
            accepted = False
            for alpha in self.ALPHAS:
                trials = []
                for (old_u, _, _), cand_u, block in zip(old, cand, blocks):
                    u = old_u + alpha * (cand_u - old_u)
                    xs, c = rollout_and_cost(block.agent.ocp.spec(), u)
                    trials.append((u, xs, float(c)))
                total = sum(c for _, _, c in trials)
                if total < base_cost:
                    for (u, xs, c), block in zip(trials, blocks):
                        block.agent.ocp.set_result(xs, u, c)
                        block.agent.update_initial_with_best()
                    base_cost = total
                    accepted = True
                    break
            if not accepted:
                for (old_u, old_x, old_c), block in zip(old, blocks):
                    block.agent.ocp.set_result(old_x, old_u, old_c)
                    block.agent.update_initial_with_best()


@register_strategy
class TrustRegionNashStrategy(_NashBase):
    """A trust region per agent."""

    name = "trustregion"

    def _run_stacked(self, specs: OCPSpec):
        sweep = self._sweeper(specs)
        best_x, best_costs = self._initial_state_costs(specs)
        best_u = specs.initial_controls
        radii = torch.ones(best_u.shape[0], dtype=best_u.dtype, device=best_u.device)
        for _ in range(self.max_outer):
            results = sweep(best_u, best_x)
            delta = results.controls - best_u
            norms = torch.sqrt((delta**2).sum((1, 2)))
            over = norms > radii
            scale = torch.where(over, radii / torch.clamp_min(norms, 1e-30),
                                torch.ones_like(norms))
            cand_u = best_u + scale[:, None, None] * delta
            # Costed against the pre-sweep (frozen) plans of the others.
            ctx = self._ctx_for(best_x) if self._coupled else None
            cand_costs, cand_x = self._objective(specs, cand_u, ctx)
            # Unscaled steps keep the solver's own trajectory and cost.
            cand_u = torch.where(over[:, None, None], cand_u, results.controls)
            cand_x = torch.where(over[:, None, None], cand_x, results.states)
            cand_costs = torch.where(over, cand_costs, results.cost)
            accept = cand_costs < best_costs
            best_u = torch.where(accept[:, None, None], cand_u, best_u)
            best_x = torch.where(accept[:, None, None], cand_x, best_x)
            best_costs = torch.where(accept, cand_costs, best_costs)
            radii = torch.where(accept, radii * 1.5, radii * 0.5)
        return self._finalize(specs, best_x, best_u)

    def _run_host(self, problem: MultiAgentProblem) -> None:
        solvers = self._make_host_solvers(problem)
        radii = [1.0] * len(problem.blocks)
        for _ in range(self.max_outer):
            for i, (solver, block) in enumerate(zip(solvers, problem.blocks)):
                ocp = block.agent.ocp
                old_u, old_x, old_c = ocp.best_controls, ocp.best_states, ocp.best_cost
                solver.solve(ocp)
                cand_u, cand_x, cand_c = ocp.best_controls, ocp.best_states, ocp.best_cost
                delta = cand_u - old_u
                norm = float(torch.linalg.norm(delta))
                if norm > radii[i]:
                    cand_u = old_u + (radii[i] / norm) * delta
                    cand_x, cand_c = rollout_and_cost(ocp.spec(), cand_u)
                    cand_c = float(cand_c)
                if cand_c < old_c:
                    ocp.set_result(cand_x, cand_u, cand_c)
                    radii[i] *= 1.5
                else:
                    ocp.set_result(old_x, old_u, old_c)
                    radii[i] *= 0.5
                block.agent.update_initial_with_best()
