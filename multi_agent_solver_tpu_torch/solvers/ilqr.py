"""Batched iLQR -- the lane-resident fused loop and the kernel-per-phase
(non-fused) path -- and the single-problem solve.

PyTorch counterpart of ``multi_agent_solver_tpu/solvers/ilqr.py``
(``ILQRConfig``, the cost-structure probe -- run once per problem
structure, as the JAX package's trace runs it --, ``_solve_ilqr_batched_fused``
with its lane AL machinery, the scan functions ``compute_merit``,
``_linearize``, ``_cost_hessians``, ``_add_al_terms``, ``_backward_pass``,
``_forward_pass``, ``solve_ilqr``, the router and non-fused body of
``solve_ilqr_batched``, and the ``ILQR`` solver class).

**The fused loop.**  Per solve it launches K2's rollout mode
(``ops/forward_select.rollout_cost``) once for the initial rollout and
cost, then by the cost structure that :func:`resolve_cost_structure` finds:

* stationary quadratic (the main path): K3's hoist mode
  (``ops/linearize.linearize_hessians``) once on one stage to hoist the
  time-constant Hessians; per iteration K1
  (``ops/riccati.riccati_fusedlin``) -- or, with
  ``stationary_fusedlin=False``, K3 (``ops/linearize.linearize``) without
  Hessians and K4 (``ops/riccati.riccati_backward``) on one-stage Hessian
  blocks;
* quadratic, time-varying: K3's hoist mode once over the horizon to hoist
  the per-stage Hessians; per iteration K3 without Hessians and K4;
* general: per iteration K3 with Hessians and K4;

and per iteration K2 in select mode.  ``bound_mode="boxqp"`` runs the
box-QP stage solve (K5) inside K1 or K4 on the delta bounds around the
current controls.  ``jacobian_mode="continuous"`` runs K1 and K3 in their
continuous-Jacobian mode.

A spec with a per-stage ``context`` (a coupled Nash game's view of the
other agents) packs it once per solve to ``[T, K, C, B]`` float32 and hands
it to the initial rollout, the quadratic hoist, every K3 and every K2
select (their context modes); a context cost is never stationary, so K1
does not run.

A spec with path constraints (``eq_dim`` / ``ineq_dim`` > 0) is solved by
the augmented Lagrangian of the reference's iLQR: per problem the
multipliers ``[T, m, B]`` and a penalty ``rho [B]`` (from
``config.penalty``) are carried.  Each iteration takes the constraint
values and Jacobians at the current trajectory (``torch.func.jvp``
against basis tangents), the merit (the objective plus the AL terms under
the current multipliers), and folds the AL terms into the cost-derivative
stacks before K4; K2 runs in its AL mode (K6), adding the same terms to
every candidate's stage cost.  After the select the true objective of the
kept trajectory, the multiplier updates and the penalty schedule
(``rho * penalty_increase`` while a violation norm exceeds
``constraint_tolerance``) follow; a problem converges once its merit stops
improving and both violation norms are below the tolerance, and is then
frozen.  An AL problem is never stationary, so K1 does not run.  With a
context too (a constrained agent of a coupled game), K2 runs its AL and
context modes at once and the objective reads the context.  State is
carried batch-innermost (``[T, dim, B]``,
``[dim, B]``), the counterpart of the TPU lane layout; it is converted
once on entry and once on exit.

**The non-fused path** carries batch-first ``[B, T, ...]`` state in the
spec's dtype: the initial rollout (K2 through ``rollout_select``, or
torch), then per iteration the merit, the stage derivatives (the
``torch.func.vmap``-ed derivative oracles with the Hessians hoisted for a
quadratic cost, or K7, ``linearize="pallas"``), the AL terms folded in,
the backward pass (K4's explicit-terminal mode through
``riccati_backward_pallas``, or the torch scan :func:`_backward_pass`), the
forward pass (K2 / K6 through ``forward_select_pallas``, or the torch
:func:`_forward_pass`), the true objective, the dual updates, the penalty
schedule and per-problem freeze masks.  The router of
:func:`solve_ilqr_batched` follows the JAX package's; where JAX asks
whether its Pallas kernels can trace a problem, the port asks whether its
kernels take it -- on the CPU any torch callable (the plain versions), on
the card callables that carry ``DeviceFn`` tags.  JAX's CPU is the
port's CPU: ``fused="auto"`` fuses context and AL solves on the card only.

:func:`solve_ilqr` is the single problem's loop over the same functions
(stop at convergence, or when ``enforce_max_ms``'s host-clock deadline has
passed).  The ``ddp``, ``differentiable`` and ``assoc`` branches raise
``NotImplementedError`` naming the ROADMAP item that brings them;
``derivative_mode="fd"`` runs the non-fused path on the reference's
finite-difference oracles (``finite_differences.py``), as in JAX.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable

import numpy as np
import torch
from torch.func import jvp

from ..constraints import eval_constraints_horizon
from ..derivatives import map_leading
from ..integrators import integrate_rk4
from ..ocp import OCPSpec
from ..ops import forward_select as _k2
from ..ops import linearize as _k3
from ..ops import riccati as _k1
from ..ops.boxqp import boxqp_gains
from ..ops.forward_pallas import kernels_take, spec_supports_lane_forward
from ..ops.small import leading_minors_positive, psd_solve_with_escalation, reg_levels
from ..types import SolverParams, get_param, param_flag, resolve_device
from .base import SolveResult, SolverBase, register_solver


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Solver configuration; the fields are the JAX ``ILQRConfig``'s, so a
    config carries across (``utils/carry.config_from_dict``).

    ``lane_fold`` and ``time_unroll`` are TPU-layout knobs (sublane folding
    of batch tiles; time steps per sequential grid step) with no effect on
    CUDA, where every kernel runs one problem per thread and the time loop
    inside it.  ``penalty``, ``penalty_increase``, ``constraint_tolerance``
    and ``inequality_activation_tolerance`` drive the AL machinery of
    constrained problems; ``state_bounds_al`` is read by the JAX package's
    single-problem ``solve`` (not ported: batched callers apply
    ``ocp.with_state_bound_constraints`` themselves).  The ddp,
    differentiable and non-fused fields select branches that raise
    ``NotImplementedError`` here (see :func:`solve_ilqr_batched`).
    """

    max_iterations: int = 50
    tolerance: float = 1e-6
    penalty: float = 10.0
    penalty_increase: float = 5.0
    constraint_tolerance: float = 1e-4
    inequality_activation_tolerance: float = 1e-6
    alpha_min: float = 1e-3
    # Forward-pass candidates (None = the reference ladder 1, 1/2, ... down
    # to alpha_min).  The largest improving candidate is accepted.
    alpha_ladder: tuple = None
    # k > 0: the first k iterations use the full reference ladder, later
    # ones alpha_ladder.
    alpha_warmup: int = 0
    lane_fold: int = 0
    max_ms: float = 0.0
    enforce_max_ms: bool = False
    reg_init: float = 1e-6
    reg_factor: float = 10.0
    reg_levels: int = 16
    jacobian_mode: str = "discrete"
    bound_mode: str = "clamp"
    ddp: bool = False
    # Tri-state cost structure: None = probe, True = verified assertion,
    # False = off (see resolve_cost_structure).
    quadratic_cost: "bool | None" = None
    stationary_cost: "bool | None" = None
    # True: stop once every problem has converged (a host check once per
    # iteration); False: always run max_iterations, converged problems frozen.
    early_exit: bool = True
    stationary_fusedlin: bool = True
    time_unroll: int = 0
    fused: str = "auto"
    differentiable: bool = False
    state_bounds_al: bool = False
    debug: bool = False

    @classmethod
    def from_params(cls, params: SolverParams) -> "ILQRConfig":
        """Reference key names; max_iterations and tolerance are required."""
        return cls(
            max_iterations=int(get_param(params, "max_iterations")),
            tolerance=get_param(params, "tolerance"),
            penalty=get_param(params, "penalty", 10.0),
            penalty_increase=get_param(params, "penalty_increase", 5.0),
            constraint_tolerance=get_param(params, "constraint_tolerance", 1e-4),
            inequality_activation_tolerance=get_param(
                params, "inequality_activation_tolerance", 1e-6
            ),
            jacobian_mode=(
                "continuous" if param_flag(params, "continuous_jacobians") else "discrete"
            ),
            bound_mode="boxqp" if param_flag(params, "boxqp") else "clamp",
            ddp=param_flag(params, "ddp"),
            quadratic_cost=(
                param_flag(params, "quadratic_cost") if "quadratic_cost" in params else None
            ),
            stationary_cost=(
                param_flag(params, "stationary_cost") if "stationary_cost" in params else None
            ),
            early_exit=get_param(params, "early_exit", 1.0) > 0.5,
            fused=(
                "auto" if "fused" not in params
                else ("on" if param_flag(params, "fused") else "off")
            ),
            time_unroll=int(get_param(params, "time_unroll", 0.0)),
            differentiable=param_flag(params, "differentiable"),
            state_bounds_al=param_flag(params, "state_bounds_al"),
            max_ms=get_param(params, "max_ms", 0.0),
            enforce_max_ms=param_flag(params, "enforce_max_ms"),
            debug=param_flag(params, "debug"),
        )


def _alpha_ladder_floats(alpha_min: float):
    """Python-float candidates 1, 1/2, 1/4, ... down to alpha_min."""
    alphas = []
    alpha = 1.0
    while alpha >= alpha_min:
        alphas.append(alpha)
        alpha *= 0.5
    return tuple(alphas)


def probe_cost_structure(spec: OCPSpec) -> "tuple[bool, bool]":
    """Probe of the cost Hessians' structure -> ``(quadratic, stationary)``.

    Evaluates the AD Hessians ``lxx/luu/lux`` at two pseudo-random
    ``(x, u)`` points (the JAX probe's ``RandomState(0xC057)`` draws) for
    t = 0 and t = T-1, and the terminal ``phixx`` at both points.
    ``quadratic``: the blocks match across points at both t and the
    terminal Hessian matches; ``stationary``: they also match across t.
    Non-finite values compare unequal.  A context cost (``spec.context``
    ``[T, ...]``) is probed with one random context per stage index, drawn
    from the same stream after the points; it may be quadratic but is never
    stationary (the context varies over t).
    """
    d = spec.derivs
    nx, nu, T = spec.state_dim, spec.control_dim, spec.horizon_steps
    has_ctx = spec.context is not None
    rng = np.random.RandomState(0xC057)
    dev = spec.initial_state.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    x_pts = [f32(rng.standard_normal(nx)) for _ in range(2)]
    u_pts = [f32(rng.standard_normal(nu)) for _ in range(2)]
    ctx = [f32(rng.standard_normal(tuple(spec.context.shape[1:]))) if has_ctx else None
           for _ in range(2)]

    def blocks(x, u, t, c):
        args = (x, u, torch.tensor(t, dtype=torch.int32, device=dev)) + ((c,) if has_ctx else ())
        return tuple(f(*args).detach().cpu().double().numpy() for f in (d.lxx, d.luu, d.lux))

    def match(a, b):
        return all(
            np.all(np.isfinite(p)) and np.all(np.isfinite(q))
            and np.allclose(p, q, rtol=1e-4, atol=1e-6)
            for p, q in zip(a, b)
        )

    q00 = blocks(x_pts[0], u_pts[0], 0, ctx[0])
    q01 = blocks(x_pts[1], u_pts[1], 0, ctx[0])
    q10 = blocks(x_pts[0], u_pts[0], T - 1, ctx[1])
    q11 = blocks(x_pts[1], u_pts[1], T - 1, ctx[1])
    p_terms = tuple((d.phixx(x).detach().cpu().double().numpy(),) for x in x_pts)
    quadratic = match(q00, q01) and match(q10, q11) and match(*p_terms)
    stationary = quadratic and not has_ctx and match(q00, q10)
    return quadratic, stationary


# The probe's answers, one per problem structure: what the JAX package's
# trace (and so its jit cache) is keyed by -- the derivative bundle and the
# dynamics / stage / terminal callables, the derivative mode, nx, nu, T and
# the context's per-stage shape (None without one).  The key holds the
# callables themselves (strong references, never ``id()``, which a
# collected callable may hand on), so a hit is never stale.  Oldest entry
# out first beyond PROBE_CACHE_SIZE.
PROBE_CACHE_SIZE = 64
_PROBE_CACHE: "collections.OrderedDict[tuple, tuple[bool, bool]]" = collections.OrderedDict()


@dataclasses.dataclass
class ProbeStats:
    """Counts of :func:`cached_cost_structure`: probes run, cache hits."""

    probes: int = 0
    hits: int = 0

    def reset(self) -> None:
        self.probes = 0
        self.hits = 0


PROBE_STATS = ProbeStats()


def _structure_key(spec: OCPSpec) -> tuple:
    ctx = None if spec.context is None else tuple(spec.context.shape[1:])
    return (spec.derivs, spec.dynamics, spec.stage_cost, spec.terminal_cost,
            spec.derivative_mode, spec.state_dim, spec.control_dim, spec.horizon_steps, ctx)


def cached_cost_structure(spec: OCPSpec) -> "tuple[bool, bool]":
    """:func:`probe_cost_structure` once per problem structure: later calls
    with the same structure (a closed loop's steps, a benchmark's warm
    calls) take the kept answer."""
    key = _structure_key(spec)
    found = _PROBE_CACHE.get(key)
    if found is not None:
        _PROBE_CACHE.move_to_end(key)
        PROBE_STATS.hits += 1
        return found
    found = probe_cost_structure(spec)
    PROBE_STATS.probes += 1
    _PROBE_CACHE[key] = found
    if len(_PROBE_CACHE) > PROBE_CACHE_SIZE:
        _PROBE_CACHE.popitem(last=False)
    return found


def resolve_cost_structure(spec: OCPSpec, config: ILQRConfig) -> "tuple[bool, bool]":
    """Concrete ``(quadratic, stationary)`` from the tri-state config fields:
    None = probe, True = assertion verified against the probe (ValueError
    on mismatch), False = off.  The probe runs once per problem structure
    (:func:`cached_cost_structure`); the assertions are checked against its
    answer on every call."""
    want_q, want_s = config.quadratic_cost, config.stationary_cost
    if want_q is False:
        return False, False
    if spec.derivative_mode != "ad":
        quad = bool(want_q)
        return quad, quad and bool(want_s)
    probe_q, probe_s = cached_cost_structure(spec)
    if want_q and not probe_q:
        raise ValueError(
            "quadratic_cost=1 was set but the stage/terminal cost Hessians "
            "differ between probe points -- the cost is not quadratic in (x, u)"
        )
    if want_s and not probe_s:
        raise ValueError(
            "stationary_cost=1 was set but the cost Hessians at t=0 and t=T-1 differ"
        )
    quad = probe_q if want_q is None else bool(want_q)
    stationary = quad and (probe_s if want_s is None else bool(want_s))
    return quad, stationary


@dataclasses.dataclass(frozen=True)
class KernelOps:
    """The kernel operations of both paths: the fused loop's (layout
    ``[T, ..., B]``) and the non-fused path's batch-first wrappers."""

    rollout: Callable
    linearize: Callable
    linearize_hessians: Callable   # K3's hoist mode
    riccati: Callable            # K1, in-kernel linearization
    riccati_backward: Callable   # K4, precomputed stacks
    select: Callable
    rollout_select: Callable            # K2 rollout, batch-first
    forward_select_pallas: Callable     # K2 / K6 select, batch-first
    riccati_backward_pallas: Callable   # K4 explicit-terminal, batch-first
    linearize_pallas: Callable          # K7


# The wrappers: CUDA kernels on CUDA tensors, plain versions on CPU tensors.
KERNEL_OPS = KernelOps(_k2.rollout_cost, _k3.linearize, _k3.linearize_hessians,
                       _k1.riccati_fusedlin, _k1.riccati_backward, _k2.forward_select,
                       _k2.rollout_select, _k2.forward_select_pallas,
                       _k1.riccati_backward_pallas, _k3.linearize_pallas)
# The plain PyTorch versions on any device: the reference the kernels are
# held against on the card (chip_smoke.py).
PLAIN_OPS = KernelOps(
    _k2.rollout_cost_plain, _k3.linearize_plain, _k3.linearize_hessians_plain,
    _k1.riccati_fusedlin_plain, _k1.riccati_backward_plain, _k2.forward_select_plain,
    functools.partial(_k2.rollout_select, rollout=_k2.rollout_cost_plain),
    functools.partial(_k2.forward_select_pallas, select=_k2.forward_select_plain),
    functools.partial(_k1.riccati_backward_pallas, explicit=_k1.riccati_backward_explicit_plain),
    _k3.linearize_pallas_plain)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


@dataclasses.dataclass(frozen=True)
class Route:
    """The router's decision for one batched solve."""

    fused: bool
    backward: str = "pallas"        # non-fused: "pallas" (K4) or "scan" (torch)
    lane_forward: bool = False      # non-fused: K2 rollout and select
    lane_linearize: bool = False    # non-fused: K7


def route(specs: OCPSpec, config: ILQRConfig, backward: str = "auto", linearize: str = "xla",
          fused="auto", device_type: str = "cuda") -> Route:
    """The JAX router of ``solve_ilqr_batched`` (ilqr.py:1351-1510 of the
    JAX package), run before the solve on ``device_type``'s terms: JAX's
    ``interpret`` (the CPU) is the port's CPU.  Raises for the branches that
    are not ported.

    The lane kernels take a problem where ``ops/forward_pallas.py::
    spec_supports_lane_forward`` says so -- JAX's check, its bound on a
    per-stage context (512 floats a stage) included.  Context and AL
    solves, apart or together, fuse under ``fused="auto"`` on the card
    only, as JAX fuses them off its interpreter.

    The kernels differentiate in AD mode only, so ``derivative_mode="fd"``
    takes the non-fused path with the vmapped finite-difference oracles and
    no K7, as JAX's fused gate and ``lane_linearize`` send it; the K2
    rollout and select and K4 still run where the problem fits them.

    One deliberate divergence: a context solve with ``fused=False`` and
    ``linearize="pallas"`` runs the vmapped linearizer, since K7 takes no
    context.  JAX builds K7 without the context there and raises
    ``TypeError`` (its ``ops/linearize_pallas.py:301``).
    """
    if config.differentiable:
        raise _not_ported("differentiable=True", "queue 1, iLQR modes")
    if config.ddp:
        raise _not_ported("ddp=True", "queue 1, iLQR modes")
    if linearize not in ("xla", "pallas"):
        raise ValueError(f"linearize={linearize!r}: 'xla' or 'pallas'")
    if fused in ("on", "off"):
        fused = fused == "on"
    if fused == "auto" and config.fused != "auto":
        fused = config.fused == "on"
    nx, nu = specs.state_dim, specs.control_dim
    if backward == "auto":
        backward = "pallas" if (nx <= 16 and nu <= 4) else "scan"
    if config.bound_mode == "boxqp" and specs.has_input_bounds and backward == "assoc":
        backward = "scan"
    if backward == "assoc":
        raise _not_ported("backward='assoc'", "queue 1, ops/riccati_assoc.py")
    if backward not in ("pallas", "scan"):
        raise ValueError(f"backward={backward!r}: 'auto', 'pallas', 'scan' or 'assoc'")
    al = specs.eq_dim > 0 or specs.ineq_dim > 0
    dev = torch.device(device_type)
    interpret = dev.type == "cpu"
    lane_forward = (backward == "pallas" and specs.objective_is_default
                    and spec_supports_lane_forward(specs, dev))
    ad = specs.derivative_mode == "ad"
    if (fused in ("auto", True) and lane_forward and ad
            and (specs.context is None and not al or fused is True or not interpret)):
        return Route(fused=True)
    lane_linearize = (linearize == "pallas" and lane_forward and ad and specs.context is None
                      and kernels_take(specs, dev))
    return Route(False, backward, lane_forward, lane_linearize)


# ---------------------------------------------------------------------------
# The lane AL machinery, batch innermost: values [T, m, B], Jacobians
# [T, m, n, B], multipliers [T, m, B], rho [B] (ilqr.py:842-957 of the JAX
# package).  Plain torch: elementwise math and sums over the rows and the
# horizon, around the kernels.
# ---------------------------------------------------------------------------


def _lane_constraint_vals(constraint, xs: torch.Tensor, us: torch.Tensor) -> torch.Tensor:
    """``g [T, m, B]`` of ``constraint`` at ``(x_t, u_t)``."""
    x, u = xs.permute(0, 2, 1), us.permute(0, 2, 1)                     # [T, B, n]
    g = constraint(x, u)
    return torch.broadcast_to(g, x.shape[:2] + g.shape[-1:]).permute(0, 2, 1).contiguous()


def _lane_constraint_stacks(constraint, xs: torch.Tensor, us: torch.Tensor):
    """``(g [T, m, B], Gx [T, m, nx, B], Gu [T, m, nu, B])``: the Jacobian
    columns by ``torch.func.jvp`` against basis tangents, as the JAX
    package's ``_lane_constraint_stacks``."""
    x, u = xs.permute(0, 2, 1), us.permute(0, 2, 1)                     # [T, B, n]
    g = constraint(x, u)
    lead = x.shape[:2] + g.shape[-1:]                                   # [T, B, m]

    def columns(fn, z):
        cols = [torch.broadcast_to(jvp(fn, (z,), (_k3._basis(z.shape[-1], j, z),))[1], lead)
                for j in range(z.shape[-1])]
        return torch.stack(cols, -1).permute(0, 2, 3, 1).contiguous()   # [T, m, n, B]

    return (torch.broadcast_to(g, lead).permute(0, 2, 1).contiguous(),
            columns(lambda a: constraint(a, u), x), columns(lambda a: constraint(x, a), u))


def _lane_objective(spec: OCPSpec, xs: torch.Tensor, xT: torch.Tensor, us: torch.Tensor,
                    ctx: torch.Tensor = None):
    """The true (un-augmented) objective per problem ``[B]``: the stage
    costs at ``(x_t, u_t, t)`` -- with ``ctx [T, ..., B]`` at ``(x_t, u_t,
    t, ctx_t)`` -- summed over the horizon, plus the terminal cost at
    ``x_T``.  ``t`` is the float stage index K3 passes."""
    x, u = xs.permute(0, 2, 1), us.permute(0, 2, 1)
    t = torch.arange(xs.shape[0], dtype=xs.dtype, device=xs.device)[:, None].expand(x.shape[:2])
    args = (x, u, t) + (() if ctx is None else (ctx.movedim(-1, 1),))
    stage = torch.broadcast_to(spec.stage_cost(*args), x.shape[:2])
    return stage.sum(0) + spec.terminal_cost(xT.T)


def _activation(h: torch.Tensor, act_tol: float) -> torch.Tensor:
    """``[h > -act_tol]`` as float32 (False for NaN)."""
    return (h > -act_tol).to(h.dtype)


def _lane_merit(objective, g, h, eq_mult, ineq_mult, rho, act_tol: float):
    """The AL merit per problem: ``objective`` plus ``sum lambda g +
    0.5 rho sum g^2`` over the equality values ``g`` and ``sum (mu a) s +
    0.5 rho sum s^2`` over the inequality values ``h``, ``s = max(h, 0) a``
    (the reference's compute_merit)."""
    merit = objective
    if g is not None:
        merit = merit + (eq_mult * g).sum((0, 1))
        merit = merit + 0.5 * rho * (g ** 2).sum((0, 1))
    if h is not None:
        active = _activation(h, act_tol)
        active_slack = torch.maximum(h, h.new_zeros(())) * active
        merit = merit + ((ineq_mult * active) * active_slack).sum((0, 1))
        merit = merit + 0.5 * rho * (active_slack ** 2).sum((0, 1))
    return merit


def _outer(P, Q, w=None):
    """``sum_m w_m P[:, m, i] Q[:, m, j]`` over the rows m: ``[T, i, j, B]``."""
    total = None
    for m in range(P.shape[1]):
        term = P[:, m, :, None] * Q[:, m, None, :]
        if w is not None:
            term = term * w[:, m, None, None]
        total = term if total is None else total + term
    return total


def _lane_al_fold(lin, stacks_eq, stacks_ineq, eq_mult, ineq_mult, rho, act_tol: float):
    """The AL terms folded into the derivative stacks ``(A, B, lx, lu, lxx,
    luu, lux)`` (the reference's _add_al_terms): gradients gain
    ``G^T (lambda + rho g)``, Hessians ``rho G^T G``, inequality rows
    weighted by their activation.  Out of place: the hoisted Hessians of
    the quadratic branch are shared by every iteration."""
    A, Bm, lx, lu, lxx, luu, lux = lin
    for stacks, mult, eq in ((stacks_eq, eq_mult, True), (stacks_ineq, ineq_mult, False)):
        if stacks is None:
            continue
        g, Gx, Gu = stacks
        if eq:
            w = None
            dual = mult + rho * g
        else:
            w = _activation(g, act_tol)
            dual = mult * w + rho * torch.maximum(g, g.new_zeros(())) * w
        lx = lx + (Gx * dual[:, :, None]).sum(1)
        lu = lu + (Gu * dual[:, :, None]).sum(1)
        lxx = lxx + rho * _outer(Gx, Gx, w)
        lux = lux + rho * _outer(Gu, Gx, w)
        luu = luu + rho * _outer(Gu, Gu, w)
    return A, Bm, lx, lu, lxx, luu, lux


def _lane_dual_update(g, h, eq_mult, ineq_mult, rho, config: ILQRConfig):
    """Multiplier and penalty updates at the kept trajectory's values:
    ``lambda + rho g``, ``max(mu + rho max(h, 0), 0)``, the violation norms
    ``sqrt(sum g^2)`` and ``sqrt(sum max(h, 0)^2)``, and ``rho *
    penalty_increase`` where a norm exceeds ``constraint_tolerance``.
    Returns ``(eq_mult, ineq_mult, rho, eq_viol, ineq_viol)``."""
    eq_viol = ineq_viol = torch.zeros_like(rho)
    if g is not None:
        eq_mult = eq_mult + rho * g
        eq_viol = torch.sqrt((g ** 2).sum((0, 1)))
    if h is not None:
        positive = torch.maximum(h, h.new_zeros(()))
        ineq_mult = torch.maximum(ineq_mult + rho * positive, h.new_zeros(()))
        ineq_viol = torch.sqrt((positive ** 2).sum((0, 1)))
    tol = config.constraint_tolerance
    rho = torch.where((eq_viol > tol) | (ineq_viol > tol), rho * config.penalty_increase, rho)
    return eq_mult, ineq_mult, rho, eq_viol, ineq_viol


def _unbatch(specs: OCPSpec) -> OCPSpec:
    """One problem's spec (statics carrier for the cost probe)."""
    return specs.replace(
        initial_state=specs.initial_state[0], initial_controls=specs.initial_controls[0],
        context=None if specs.context is None else specs.context[0])


def solve_ilqr_batched_fused(specs: OCPSpec, config: ILQRConfig, ops: KernelOps = None,
                             structure=None) -> SolveResult:
    """The fused loop on the device of ``specs``.

    Spec leaves carry a leading batch axis (``initial_state [B, nx]``,
    ``initial_controls [B, T, nu]``, bounds ``[nu]`` or ``[B, nu]``,
    ``context [B, T, K, C]``).  ``ops`` picks the kernels (None:
    :data:`KERNEL_OPS`) or, with :data:`PLAIN_OPS`, the plain versions on
    the same device.
    ``structure``: the cost's ``(quadratic, stationary)`` when the caller
    has resolved it already (a strategy resolves it once for all its
    sweeps); None resolves it here.
    """
    ops = KERNEL_OPS if ops is None else ops
    B, nx = specs.initial_state.shape
    T, nu = specs.horizon_steps, specs.control_dim
    dev = specs.initial_state.device
    out_dtype = specs.initial_state.dtype
    f32 = torch.float32

    def pack(t: torch.Tensor, perm) -> torch.Tensor:
        # A fresh contiguous float32 copy: the select kernel updates the
        # trajectory buffers in place, so they must never alias the caller's.
        t = t.permute(perm)
        out = torch.empty(t.shape, dtype=f32, device=dev)
        return out.copy_(t)

    x0 = pack(specs.initial_state, (1, 0))                               # [nx, B]
    us = pack(specs.initial_controls, (1, 2, 0))                         # [T, nu, B]
    ctx = None
    if specs.context is not None:                                        # [T, ..., B]
        ctx = pack(specs.context, tuple(range(1, specs.context.dim())) + (0,))
    lb = ub = None
    if specs.has_input_bounds:
        lb = pack(specs.input_lower_bounds.expand(B, nu), (1, 0))
        ub = pack(specs.input_upper_bounds.expand(B, nu), (1, 0))
    use_boxqp = config.bound_mode == "boxqp" and specs.has_input_bounds

    discrete = config.jacobian_mode == "discrete"
    ladder_full = _alpha_ladder_floats(config.alpha_min)
    ladder_short = tuple(float(a) for a in config.alpha_ladder) if config.alpha_ladder else ladder_full
    use_schedule = config.alpha_warmup > 0 and ladder_short != ladder_full

    xs_tail, cost = ops.rollout(specs, x0, us, ctx)
    xs = torch.cat([x0[None], xs_tail[:-1]], 0)                          # x_0..x_{T-1}
    xT = xs_tail[-1].clone()

    # Quadratic-cost hoisting: the Hessian stacks do not depend on the
    # trajectory, so they are computed once, by K3's hoist mode (the
    # Hessians alone, where the TPU driver keeps K3's last three outputs) --
    # one block per problem for a stationary cost, one per stage otherwise.
    if structure is None:
        structure = resolve_cost_structure(_unbatch(specs), config)
    quad, stationary = structure
    eq_fn = specs.equality_constraints if specs.eq_dim > 0 else None
    in_fn = specs.inequality_constraints if specs.ineq_dim > 0 else None
    has_al = eq_fn is not None or in_fn is not None
    stationary = stationary and not has_al and ctx is None
    fusedlin = stationary and config.stationary_fusedlin
    hess = None
    if stationary:
        hess = ops.linearize_hessians(specs, x0[None].contiguous(), us[:1].contiguous())
    elif quad:
        hess = ops.linearize_hessians(specs, xs, us, ctx)
    levels = _k1.reg_ladder(config.reg_init, config.reg_factor, config.reg_levels)

    # The AL carries: multipliers [T, m, B], penalty [B], violation norms [B].
    act_tol = config.inequality_activation_tolerance
    eq_viol = ineq_viol = torch.zeros(B, dtype=f32, device=dev)
    eq_mult = torch.zeros((T, specs.eq_dim, B), dtype=f32, device=dev) if eq_fn else None
    ineq_mult = torch.zeros((T, specs.ineq_dim, B), dtype=f32, device=dev) if in_fn else None
    rho = torch.full((B,), config.penalty, dtype=f32, device=dev) if has_al else None

    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    it = 0
    while it < config.max_iterations:
        # The JAX fused loop's while_loop predicate any(~converged) becomes a
        # host check, once per iteration.
        if config.early_exit and it > 0 and bool(converged.all()):
            break
        active = ~converged
        merit = cost
        # Delta bounds: the box around the current controls.
        blb, bub = (lb[None] - us, ub[None] - us) if use_boxqp else (None, None)
        if fusedlin:
            k, K = ops.riccati(specs, xs, us, *(h[0] for h in hess), xT, levels, blb, bub,
                               discrete)
        else:
            lin = ops.linearize(specs, xs, us, hess is None, ctx, discrete)
            if hess is not None:
                lin = lin + tuple(hess)
            if has_al:
                # The merit under the current multipliers, and the AL terms
                # folded into the stacks, at the current trajectory (the
                # select overwrites it).
                st_eq = _lane_constraint_stacks(eq_fn, xs, us) if eq_fn else None
                st_in = _lane_constraint_stacks(in_fn, xs, us) if in_fn else None
                merit = _lane_merit(cost, st_eq[0] if st_eq else None,
                                    st_in[0] if st_in else None, eq_mult, ineq_mult, rho, act_tol)
                lin = _lane_al_fold(lin, st_eq, st_in, eq_mult, ineq_mult, rho, act_tol)
            k, K = ops.riccati_backward(specs, *lin, xT, levels, blb, bub)
        ladder = ladder_full if use_schedule and it < config.alpha_warmup else ladder_short
        al = (eq_mult, ineq_mult, rho, act_tol) if has_al else ()
        kept, _ = ops.select(specs, xs, us, xT, k, K, merit, active, lb, ub, ladder, ctx, *al)
        newly = active & (merit - kept < config.tolerance)
        if has_al:
            # The true objective, multipliers and penalty at the kept
            # trajectory; frozen problems keep theirs.
            g = _lane_constraint_vals(eq_fn, xs, us) if eq_fn else None
            h = _lane_constraint_vals(in_fn, xs, us) if in_fn else None
            new = (_lane_objective(specs, xs, xT, us, ctx),
                   *_lane_dual_update(g, h, eq_mult, ineq_mult, rho, config))
            old = (cost, eq_mult, ineq_mult, rho, eq_viol, ineq_viol)
            cost, eq_mult, ineq_mult, rho, eq_viol, ineq_viol = (
                None if o is None else torch.where(active, n, o) for n, o in zip(new, old))
            tol = config.constraint_tolerance
            newly = newly & (new[4] < tol) & (new[5] < tol)
        else:
            cost = kept
        converged = converged | newly
        it += 1

    states = torch.cat([x0[None], xs[1:], xT[None]], 0).permute(2, 0, 1)  # [B, T+1, nx]
    cost_out = cost.to(out_dtype)
    return SolveResult(
        states=states.to(out_dtype).contiguous(),
        controls=us.permute(2, 0, 1).to(out_dtype).contiguous(),
        cost=cost_out,
        iterations=torch.full((B,), it, dtype=torch.int32, device=dev),
        converged=converged,
        merit=cost_out,
        eq_violation=eq_viol.to(out_dtype),
        ineq_violation=ineq_viol.to(out_dtype),
    )


# ---------------------------------------------------------------------------
# The scan functions (ilqr.py:264-798 of the JAX package) on leading batch
# axes: one problem (``states [T+1, nx]``) or a batch (``[B, T+1, nx]``; the
# forward pass adds a candidate axis in front).  Derivative oracles and
# constraints are single-problem functions, mapped over the leading axes by
# torch.func.vmap (derivatives.map_leading).
# ---------------------------------------------------------------------------


def _sym(M: torch.Tensor) -> torch.Tensor:
    return 0.5 * (M + M.transpose(-1, -2))


def compute_merit(spec: OCPSpec, config: ILQRConfig, states, controls, eq_mult, ineq_mult, rho):
    """AL merit with the inequality activation mask (``[...]``): the
    objective plus ``sum lambda g + 0.5 rho sum g^2`` and ``sum (mu a) s +
    0.5 rho sum s^2``, ``s = max(h, 0) a``, ``a = [h > -act_tol]``."""
    merit = spec.cost(states, controls)
    if spec.eq_dim > 0:
        g = eval_constraints_horizon(spec.equality_constraints, states, controls)
        merit = merit + (eq_mult * g).sum((-2, -1)) + 0.5 * rho * (g ** 2).sum((-2, -1))
    if spec.ineq_dim > 0:
        h = eval_constraints_horizon(spec.inequality_constraints, states, controls)
        slack = torch.maximum(h, h.new_zeros(()))
        active = (h > -config.inequality_activation_tolerance).to(states.dtype)
        active_slack = slack * active
        merit = merit + ((ineq_mult * active) * active_slack).sum((-2, -1))
        merit = merit + 0.5 * rho * (active_slack ** 2).sum((-2, -1))
    return merit


def _cost_args(spec: OCPSpec, xs, us):
    """``(x_t, u_t, t[, ctx_t])`` stacks of the stage-cost oracles."""
    ts = torch.arange(spec.horizon_steps, device=us.device).expand(us.shape[:-1])
    return (xs[..., :-1, :], us, ts) + (() if spec.context is None else (spec.context,))


def _linearize(spec: OCPSpec, config: ILQRConfig, xs, us, hess=None):
    """Stage derivatives ``(A, B, lx, lu, lxx, luu, lux)`` over the horizon:
    the step Jacobians ``step_fx`` / ``step_fu`` in the discrete mode, the
    continuous ``fx`` / ``fu`` (the user's analytic Jacobians where the OCP
    sets them) in the continuous mode; ``hess`` the hoisted
    ``(lxx, luu, lux)`` of a quadratic cost."""
    d = spec.derivs
    lead = us.shape[:-1]
    x, u = xs[..., :-1, :], us
    if config.jacobian_mode == "discrete" and d.step_fx is not None:
        A, Bm = map_leading(d.step_fx, x, u, lead=lead), map_leading(d.step_fu, x, u, lead=lead)
    else:
        A, Bm = map_leading(d.fx, x, u, lead=lead), map_leading(d.fu, x, u, lead=lead)
    args = _cost_args(spec, xs, us)
    lx, lu = map_leading(d.lx, *args, lead=lead), map_leading(d.lu, *args, lead=lead)
    if hess is None:
        hess = tuple(map_leading(f, *args, lead=lead) for f in (d.lxx, d.luu, d.lux))
    return (A, Bm, lx, lu) + tuple(hess)


def _cost_hessians(spec: OCPSpec, xs, us):
    """The hoist of a quadratic cost: ``((lxx, luu, lux), phixx)`` at a
    nominal trajectory, the terminal Hessian symmetrized."""
    d = spec.derivs
    args = _cost_args(spec, xs, us)
    hess = tuple(map_leading(f, *args, lead=us.shape[:-1]) for f in (d.lxx, d.luu, d.lux))
    return hess, _sym(map_leading(d.phixx, xs[..., -1, :], lead=xs.shape[:-2]))


def _add_al_terms(spec: OCPSpec, config: ILQRConfig, xs, us, lx, lu, lxx, luu, lux, eq_mult,
                  ineq_mult, rho):
    """The AL terms folded into the stage derivatives, out of place (the
    hoisted Hessians are shared by every iteration): gradients gain
    ``G^T (lambda + rho g)``, Hessians ``rho G^T G`` -- inequality rows
    weighted by their activation."""
    d = spec.derivs
    lead = us.shape[:-1]
    x, u = xs[..., :-1, :], us
    r = rho[..., None, None]
    r3 = rho[..., None, None, None]
    sides = ((spec.eq_dim, spec.equality_constraints, d.eq_gx, d.eq_gu, eq_mult, True),
             (spec.ineq_dim, spec.inequality_constraints, d.ineq_gx, d.ineq_gu, ineq_mult, False))
    for m, fn, gx, gu, mult, eq in sides:
        if m == 0:
            continue
        g = eval_constraints_horizon(fn, xs, us)                                    # [..., T, m]
        Gx, Gu = map_leading(gx, x, u, lead=lead), map_leading(gu, x, u, lead=lead)       # [..., T, m, n]
        if eq:
            dual = mult + r * g
            w = torch.ones_like(g)
        else:
            w = (g > -config.inequality_activation_tolerance).to(g.dtype)
            dual = mult * w + r * torch.maximum(g, g.new_zeros(())) * w
        lx = lx + torch.einsum("...tmi,...tm->...ti", Gx, dual)
        lu = lu + torch.einsum("...tmi,...tm->...ti", Gu, dual)
        lxx = lxx + r3 * torch.einsum("...tmi,...tm,...tmj->...tij", Gx, w, Gx)
        lux = lux + r3 * torch.einsum("...tmi,...tm,...tmj->...tij", Gu, w, Gx)
        luu = luu + r3 * torch.einsum("...tmi,...tm,...tmj->...tij", Gu, w, Gu)
    return lx, lu, lxx, luu, lux


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _backward_pass(spec: OCPSpec, config: ILQRConfig, xs, A, B, lx, lu, lxx, luu, lux, us=None,
                   phixx_const=None):
    """The Riccati recursion as a reverse loop over the stages: Q-terms, the
    gains from the first level of the cumulative regularization ladder
    whose shifted q_uu passes Sylvester's test (or, with
    ``bound_mode="boxqp"``, input bounds and ``us``, the exact box-QP
    gains on the delta bounds), the value recursion with a symmetrized
    v_xx.  Returns ``k [..., T, nu]``, ``K [..., T, nu, nx]``."""
    use_boxqp = (config.bound_mode == "boxqp" and spec.has_input_bounds
                 and spec.control_dim <= 4 and us is not None)
    v_x = map_leading(spec.derivs.phix, xs[..., -1, :], lead=xs.shape[:-2])
    v_xx = phixx_const if phixx_const is not None else _sym(
        map_leading(spec.derivs.phixx, xs[..., -1, :], lead=xs.shape[:-2]))
    nu = spec.control_dim
    eye = torch.eye(nu, dtype=xs.dtype, device=xs.device)
    ks, Ks = [], []
    for t in range(spec.horizon_steps - 1, -1, -1):
        A_t, B_t = A[..., t, :, :], B[..., t, :, :]
        A_T, B_T = A_t.transpose(-1, -2), B_t.transpose(-1, -2)
        q_x = lx[..., t, :] + _mv(A_T, v_x)
        q_u = lu[..., t, :] + _mv(B_T, v_x)
        q_xx = lxx[..., t, :, :] + A_T @ v_xx @ A_t
        q_ux = lux[..., t, :, :] + B_T @ v_xx @ A_t
        q_uu = luu[..., t, :, :] + B_T @ v_xx @ B_t
        if use_boxqp:
            levels = reg_levels(config.reg_init, config.reg_factor, config.reg_levels, q_uu)
            cands = q_uu[None] + levels.reshape((-1,) + (1,) * q_uu.dim()) * eye
            ok = leading_minors_positive(cands)
            idx = torch.where(ok.any(0), torch.argmax(ok.to(torch.uint8), 0),
                              torch.full_like(ok[0], config.reg_levels - 1, dtype=torch.int64))
            u_t = us[..., t, :]
            k_t, K_t = boxqp_gains(q_uu + levels[idx][..., None, None] * eye, q_u, q_ux,
                                   spec.input_lower_bounds - u_t, spec.input_upper_bounds - u_t)
        else:
            rhs = torch.cat([q_u[..., None], q_ux], -1)
            sol, _ = psd_solve_with_escalation(q_uu, rhs, config.reg_init, config.reg_factor,
                                               config.reg_levels)
            k_t, K_t = -sol[..., 0], -sol[..., 1:]
        K_T = K_t.transpose(-1, -2)
        q_ux_T = q_ux.transpose(-1, -2)
        v_x = q_x + _mv(K_T, q_u) + _mv(q_ux_T, k_t) + _mv(K_T, _mv(q_uu, k_t))
        v_xx = _sym(q_xx + K_T @ q_ux + q_ux_T @ K_t + K_T @ q_uu @ K_t)
        ks.append(k_t)
        Ks.append(K_t)
    return torch.stack(ks[::-1], -2), torch.stack(Ks[::-1], -3)


def _forward_pass(spec: OCPSpec, config: ILQRConfig, xs, us, k, K, eq_mult, ineq_mult, rho,
                  current_merit):
    """Every candidate step at once -- one feedback rollout per alpha of
    the ladder (``config.alpha_ladder`` or the reference ladder), clamped
    to the input bounds -- and the largest alpha whose merit beats
    ``current_merit`` wins; without one the trajectory stays.  Returns
    ``(xs_new, us_new, merit_new)``."""
    ladder = config.alpha_ladder or _alpha_ladder_floats(config.alpha_min)
    alphas = torch.tensor(ladder, dtype=xs.dtype, device=xs.device)
    n_a = alphas.shape[0]
    a = alphas.reshape((n_a,) + (1,) * (us.dim() - 1))
    x = xs[..., 0, :].expand((n_a,) + xs.shape[:-2] + xs.shape[-1:])
    x_list, u_list = [x], []
    for t in range(spec.horizon_steps):
        u = us[..., t, :] + a * k[..., t, :] + _mv(K[..., t, :, :], x - xs[..., t, :])
        if spec.has_input_bounds:
            u = torch.minimum(torch.maximum(u, spec.input_lower_bounds), spec.input_upper_bounds)
        x = integrate_rk4(x, u, spec.dt, spec.dynamics)
        x_list.append(x)
        u_list.append(u)
    xs_c, us_c = torch.stack(x_list, -2), torch.stack(u_list, -2)   # [A, ..., T(+1), n]
    merits = compute_merit(spec, config, xs_c, us_c, eq_mult, ineq_mult, rho)
    accept = merits < current_merit
    found = accept.any(0)
    idx = torch.argmax(accept.to(torch.uint8), 0)
    pick = lambda c: torch.take_along_dim(c, idx.reshape((1,) + idx.shape + (1, 1)), 0)[0]
    sel = lambda new, old: torch.where(found.reshape(found.shape + (1,) * (old.dim()
                                                                          - found.dim())),
                                       new, old)
    merit_new = torch.where(found, torch.take_along_dim(merits, idx[None], 0)[0], current_merit)
    return sel(pick(xs_c), xs), sel(pick(us_c), us), merit_new


def _violations(spec: OCPSpec, states, controls, eq_mult, ineq_mult, rho, config):
    """Dual updates at a trajectory: ``(eq_mult, ineq_mult, eq_viol,
    ineq_viol)`` -- ``lambda + rho g``, ``max(mu + rho max(h, 0), 0)`` and
    the norms ``sqrt(sum g^2)``, ``sqrt(sum max(h, 0)^2)``."""
    zero = states.new_zeros(states.shape[:-2])
    eq_viol = ineq_viol = zero
    r = rho[..., None, None]
    if spec.eq_dim > 0:
        g = eval_constraints_horizon(spec.equality_constraints, states, controls)
        eq_mult = eq_mult + r * g
        eq_viol = torch.sqrt((g ** 2).sum((-2, -1)))
    if spec.ineq_dim > 0:
        h = eval_constraints_horizon(spec.inequality_constraints, states, controls)
        positive = torch.maximum(h, h.new_zeros(()))
        ineq_mult = torch.maximum(ineq_mult + r * positive, h.new_zeros(()))
        ineq_viol = torch.sqrt((positive ** 2).sum((-2, -1)))
    return eq_mult, ineq_mult, eq_viol, ineq_viol


def _penalty(rho, eq_viol, ineq_viol, config: ILQRConfig):
    tol = config.constraint_tolerance
    return torch.where((eq_viol > tol) | (ineq_viol > tol), rho * config.penalty_increase, rho)


def solve_ilqr(spec: OCPSpec, config: ILQRConfig, deadline=None) -> SolveResult:
    """The single problem's AL-iLQR solve (``spec`` without a batch axis),
    on the spec's device and in its dtype: per iteration the merit under
    the current multipliers, :func:`_linearize` (Hessians hoisted for a
    quadratic cost), :func:`_add_al_terms`, :func:`_backward_pass`,
    :func:`_forward_pass`, the dual updates and the penalty schedule.  It
    stops after ``max_iterations``, at convergence (merit improvement
    below ``tolerance`` and both violation norms below
    ``constraint_tolerance``), or once the host clock
    (``time.perf_counter()``) has passed ``deadline`` -- checked after each
    iteration, the iteration kept; ``SolverBase.solve`` sets it from
    ``max_ms`` under ``enforce_max_ms``."""
    T, dtype, dev = spec.horizon_steps, spec.initial_state.dtype, spec.initial_state.device
    us = spec.initial_controls
    xs = spec.rollout(us)
    cost = spec.cost(xs, us)
    eq_mult = torch.zeros((T, spec.eq_dim), dtype=dtype, device=dev)
    ineq_mult = torch.zeros((T, spec.ineq_dim), dtype=dtype, device=dev)
    rho = torch.tensor(config.penalty, dtype=dtype, device=dev)
    merit = compute_merit(spec, config, xs, us, eq_mult, ineq_mult, rho)
    hess = phixx = None
    if resolve_cost_structure(spec, config)[0]:
        hess, phixx = _cost_hessians(spec, xs, us)
    eq_viol = ineq_viol = torch.zeros((), dtype=dtype, device=dev)
    converged = False
    it = 0
    while it < config.max_iterations:
        merit = compute_merit(spec, config, xs, us, eq_mult, ineq_mult, rho)
        A, Bm, lx, lu, lxx, luu, lux = _linearize(spec, config, xs, us, hess)
        lx, lu, lxx, luu, lux = _add_al_terms(spec, config, xs, us, lx, lu, lxx, luu, lux,
                                              eq_mult, ineq_mult, rho)
        k, K = _backward_pass(spec, config, xs, A, Bm, lx, lu, lxx, luu, lux, us, phixx)
        xs, us, merit_new = _forward_pass(spec, config, xs, us, k, K, eq_mult, ineq_mult, rho,
                                          merit)
        improvement = merit - merit_new
        merit = merit_new
        cost = spec.cost(xs, us)
        eq_mult, ineq_mult, eq_viol, ineq_viol = _violations(spec, xs, us, eq_mult, ineq_mult,
                                                             rho, config)
        rho = _penalty(rho, eq_viol, ineq_viol, config)
        tol = config.constraint_tolerance
        converged = bool((improvement < config.tolerance) & (eq_viol < tol) & (ineq_viol < tol))
        if config.debug:
            print(f"iLQR iter {it}: cost={float(cost)} merit={float(merit)} "
                  f"d_merit={float(improvement)} eq_violation={float(eq_viol)} "
                  f"ineq_violation={float(ineq_viol)}")
        it += 1
        if converged or (deadline is not None and time.perf_counter() > deadline):
            break
    return SolveResult(states=xs, controls=us, cost=cost,
                       iterations=torch.tensor(it, dtype=torch.int32, device=dev),
                       converged=torch.tensor(converged, device=dev), merit=merit,
                       eq_violation=eq_viol, ineq_violation=ineq_viol)


def _batched_backward_pallas(specs: OCPSpec, config: ILQRConfig, xs, us, lin, ops: KernelOps,
                             phixx_const=None, boxqp=False):
    """The non-fused backward pass through K4's explicit-terminal mode:
    ``phix`` by vmap, ``phixx`` symmetrized (or hoisted), the delta bounds
    around the current controls under boxqp; gains cast to the dtype."""
    B = xs.shape[0]
    xT = xs[:, -1]
    phix = map_leading(specs.derivs.phix, xT, lead=(B,))
    phixx = phixx_const if phixx_const is not None else _sym(
        map_leading(specs.derivs.phixx, xT, lead=(B,)))
    lb = ub = None
    if boxqp:
        nu = specs.control_dim
        lb = specs.input_lower_bounds.expand(B, nu)[:, None, :] - us
        ub = specs.input_upper_bounds.expand(B, nu)[:, None, :] - us
    k, K = ops.riccati_backward_pallas(*lin, phix, phixx, config.reg_init, config.reg_factor,
                                       config.reg_levels, lb, ub)
    return k.to(xs.dtype), K.to(xs.dtype)


def solve_ilqr_batched_nonfused(specs: OCPSpec, config: ILQRConfig, route_: Route,
                                ops: KernelOps = None, structure=None) -> SolveResult:
    """The kernel-per-phase path (ilqr.py:1440-1665 of the JAX package) on
    the device of ``specs``, batch-first in the spec's dtype; kernel
    outputs are cast to it.  ``route_`` says which phases run a kernel;
    every problem is frozen once it converges, and the loop stops when all
    have (a host check once per iteration) or after ``max_iterations``."""
    ops = KERNEL_OPS if ops is None else ops
    B, T = specs.initial_state.shape[0], specs.horizon_steps
    dtype, dev = specs.initial_state.dtype, specs.initial_state.device
    use_boxqp = config.bound_mode == "boxqp" and specs.has_input_bounds
    al = specs.eq_dim > 0 or specs.ineq_dim > 0
    us = specs.initial_controls
    if route_.lane_forward:
        xs, cost = ops.rollout_select(specs, specs.initial_state, us)
        xs, cost = xs.to(dtype), cost.to(dtype)
    else:
        xs = specs.rollout(us)
        cost = specs.cost(xs, us)
    eq_mult = torch.zeros((B, T, specs.eq_dim), dtype=dtype, device=dev)
    ineq_mult = torch.zeros((B, T, specs.ineq_dim), dtype=dtype, device=dev)
    rho = torch.full((B,), config.penalty, dtype=dtype, device=dev)
    merit = compute_merit(specs, config, xs, us, eq_mult, ineq_mult, rho)
    if structure is None:
        structure = resolve_cost_structure(_unbatch(specs), config)
    hess = phixx = None
    if structure[0]:
        hess, phixx = _cost_hessians(specs, xs, us)
    # The select kernel scores the reference ladder, as JAX passes it.
    ladder = _alpha_ladder_floats(config.alpha_min)
    discrete = config.jacobian_mode == "discrete"
    eq_viol = ineq_viol = torch.zeros(B, dtype=dtype, device=dev)
    converged = torch.zeros(B, dtype=torch.bool, device=dev)

    def mask(new, old, active):
        return torch.where(active.reshape((B,) + (1,) * (new.dim() - 1)), new, old)

    it = 0
    while it < config.max_iterations and not bool(converged.all()):
        active = ~converged
        merit = compute_merit(specs, config, xs, us, eq_mult, ineq_mult, rho)
        if route_.lane_linearize:
            lin = tuple(o.to(dtype) for o in ops.linearize_pallas(specs, xs, us, discrete))
        else:
            lin = _linearize(specs, config, xs, us, hess)
        lin = lin[:2] + _add_al_terms(specs, config, xs, us, *lin[2:], eq_mult, ineq_mult, rho)
        if route_.backward == "pallas":
            k, K = _batched_backward_pallas(specs, config, xs, us, lin, ops, phixx, use_boxqp)
        else:
            k, K = _backward_pass(specs, config, xs, *lin, us, phixx)
        if route_.lane_forward:
            xs_sel, us_sel, merit_sel, accepted = ops.forward_select_pallas(
                specs, xs, us, k, K, merit, ladder,
                eq_mult if specs.eq_dim > 0 else None,
                ineq_mult if specs.ineq_dim > 0 else None, rho if al else None,
                config.inequality_activation_tolerance)
            # Rejected problems keep their trajectory and merit exactly.
            xs_new = mask(xs_sel.to(dtype), xs, accepted)
            us_new = mask(us_sel.to(dtype), us, accepted)
            merit_new = torch.where(accepted, merit_sel.to(dtype), merit)
            cost_new = specs.cost(xs_new, us_new) if al else merit_new
        else:
            xs_new, us_new, merit_new = _forward_pass(specs, config, xs, us, k, K, eq_mult,
                                                      ineq_mult, rho, merit)
            cost_new = specs.cost(xs_new, us_new)
        improvement = merit - merit_new
        eq_new, ineq_new, eqv_new, inv_new = _violations(specs, xs_new, us_new, eq_mult,
                                                         ineq_mult, rho, config)
        rho_new = _penalty(rho, eqv_new, inv_new, config)
        tol = config.constraint_tolerance
        newly = (improvement < config.tolerance) & (eqv_new < tol) & (inv_new < tol)
        xs, us, cost, merit = (mask(xs_new, xs, active), mask(us_new, us, active),
                               mask(cost_new, cost, active), mask(merit_new, merit, active))
        eq_mult, ineq_mult, rho = (mask(eq_new, eq_mult, active),
                                   mask(ineq_new, ineq_mult, active), mask(rho_new, rho, active))
        eq_viol, ineq_viol = mask(eqv_new, eq_viol, active), mask(inv_new, ineq_viol, active)
        converged = converged | newly
        it += 1
    return SolveResult(
        states=xs, controls=us, cost=cost,
        iterations=torch.full((B,), it, dtype=torch.int32, device=dev), converged=converged,
        merit=merit, eq_violation=eq_viol, ineq_violation=ineq_viol)


def solve_ilqr_batched(specs: OCPSpec, config: ILQRConfig, backward: str = "auto",
                       linearize: str = "xla", fused="auto", device="cuda", ops: KernelOps = None,
                       structure=None) -> SolveResult:
    """Batched iLQR over specs whose leaves carry a leading batch axis.

    Runs on ``device`` (default ``"cuda"``; raises when CUDA is absent):
    the spec's tensors are moved there and :func:`route` picks the fused
    loop or the non-fused path with its kernels, as the JAX package's
    router does (``backward``: ``"auto"``, ``"pallas"`` -- K4 -- or
    ``"scan"``; ``linearize``: ``"xla"`` or ``"pallas"`` -- K7; ``fused``:
    ``"auto"``, True or False).  The kernels run on the card, their plain
    versions on ``"cpu"``; ``ops`` picks the kernels (None:
    :data:`KERNEL_OPS`) or :data:`PLAIN_OPS`.  ``structure``: the cost's
    ``(quadratic, stationary)`` when the caller has resolved it already.
    """
    dev = resolve_device(device)
    decision = route(specs, config, backward, linearize, fused, dev.type)
    specs = _on_device(specs, dev)
    if decision.fused:
        return solve_ilqr_batched_fused(specs, config, ops, structure)
    return solve_ilqr_batched_nonfused(specs, config, decision, ops, structure)


def _on_device(spec: OCPSpec, dev: torch.device) -> OCPSpec:
    """``spec`` with its tensors on ``dev``."""
    move = lambda t: None if t is None else t.to(dev)
    return spec.replace(
        initial_state=move(spec.initial_state),
        initial_controls=move(spec.initial_controls),
        input_lower_bounds=move(spec.input_lower_bounds),
        input_upper_bounds=move(spec.input_upper_bounds),
        state_lower_bounds=move(spec.state_lower_bounds),
        state_upper_bounds=move(spec.state_upper_bounds),
        context=move(spec.context),
    )


@register_solver
class ILQR(SolverBase):
    """The iLQR solver with the reference's ``set_params`` / ``solve``
    surface.

    ``device`` (default ``"cuda"``) is where its solves run; ``ops`` picks
    the kernels of its batched solves (None: :data:`KERNEL_OPS`) or
    :data:`PLAIN_OPS`.  The single-problem ``solve(ocp)`` runs
    :func:`solve_ilqr`, torch on the device, as the JAX package runs its
    scan path in XLA.
    """

    name = "ilqr"
    config_cls = ILQRConfig

    def __init__(self, device="cuda", ops: KernelOps = None, **params):
        self.ops = ops
        super().__init__(device=device, **params)

    def solve_spec(self, spec: OCPSpec, deadline=None) -> SolveResult:
        config = self.config
        if config.differentiable:
            raise _not_ported("differentiable=True", "queue 1, iLQR modes")
        if config.ddp:
            raise _not_ported("ddp=True", "queue 1, iLQR modes")
        return solve_ilqr(_on_device(spec, resolve_device(self.device)), config, deadline)

    def _solve_batched_fn(self, specs: OCPSpec, config: ILQRConfig, structure=None) -> SolveResult:
        return solve_ilqr_batched(specs, config, device=self.device, ops=self.ops,
                                  structure=structure)

    def resolve_structure(self, specs: OCPSpec, config: ILQRConfig):
        """The cost's ``(quadratic, stationary)`` of batched ``specs``."""
        return resolve_cost_structure(_unbatch(specs), config)
