"""Batched iLQR: the lane-resident fused loop.

PyTorch counterpart of ``multi_agent_solver_tpu/solvers/ilqr.py``
(``ILQRConfig``, the cost-structure probe, ``_solve_ilqr_batched_fused``
with its lane AL machinery, and the ``ILQR`` solver class).  Per solve it
launches K2 (``ops/forward_select.rollout_cost``) once for the initial
rollout and cost, then by the cost structure that
:func:`resolve_cost_structure` finds:

* stationary quadratic (the main path): K3 (``ops/linearize.linearize``)
  once on one stage to hoist the time-constant Hessians; per iteration K1
  (``ops/riccati.riccati_fusedlin``) -- or, with
  ``stationary_fusedlin=False``, K3 without Hessians and K4
  (``ops/riccati.riccati_backward``) on one-stage Hessian blocks;
* quadratic, time-varying: K3 once over the horizon to hoist the per-stage
  Hessians; per iteration K3 without Hessians and K4;
* general: per iteration K3 with Hessians and K4;

and per iteration K2 in select mode.  ``bound_mode="boxqp"`` runs the
box-QP stage solve (K5) inside K1 or K4 on the delta bounds around the
current controls.

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
frozen.  An AL problem is never stationary, so K1 does not run.  AL with a
context is not ported.

Routing differs from the JAX package's ``fused="auto"`` on the CPU: JAX
sends context (coupled) and AL-constrained solves on the CPU to its
kernel-per-phase path and fuses them only off the CPU (or with
``fused=1``); the port has no kernel-per-phase path yet, so such a solve
takes the fused loop on every device -- with the CUDA kernels on the card
and their plain versions on the CPU.

State is carried batch-innermost (``[T, dim, B]``, ``[dim, B]``), the
counterpart of the TPU lane layout; it is converted once on entry and once
on exit.  Branches this slice does not port raise ``NotImplementedError``
naming the ROADMAP item that brings them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch.func import jvp

from ..ocp import OCPSpec
from ..ops import forward_select as _k2
from ..ops import linearize as _k3
from ..ops import riccati as _k1
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


def resolve_cost_structure(spec: OCPSpec, config: ILQRConfig) -> "tuple[bool, bool]":
    """Concrete ``(quadratic, stationary)`` from the tri-state config fields:
    None = probe, True = assertion verified against the probe (ValueError
    on mismatch), False = off."""
    want_q, want_s = config.quadratic_cost, config.stationary_cost
    if want_q is False:
        return False, False
    if spec.derivative_mode != "ad":
        quad = bool(want_q)
        return quad, quad and bool(want_s)
    probe_q, probe_s = probe_cost_structure(spec)
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
class FusedOps:
    """The five operations of the fused loop."""

    rollout: Callable
    linearize: Callable
    riccati: Callable            # K1, in-kernel linearization
    riccati_backward: Callable   # K4, precomputed stacks
    select: Callable


# The wrappers: CUDA kernels on CUDA tensors, plain versions on CPU tensors.
KERNEL_OPS = FusedOps(_k2.rollout_cost, _k3.linearize, _k1.riccati_fusedlin,
                      _k1.riccati_backward, _k2.forward_select)
# The plain PyTorch versions on any device: the reference the kernels are
# held against on the card (chip_smoke.py).
PLAIN_OPS = FusedOps(_k2.rollout_cost_plain, _k3.linearize_plain, _k1.riccati_fusedlin_plain,
                     _k1.riccati_backward_plain, _k2.forward_select_plain)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP: {item})")


def _check_route(specs: OCPSpec, config: ILQRConfig, backward: str, fused) -> None:
    """Raise for every branch of the JAX router this slice does not port."""
    if config.differentiable:
        raise _not_ported("differentiable=True", "queue 1, constraints and iLQR modes")
    if config.ddp:
        raise _not_ported("ddp=True", "queue 1, constraints and iLQR modes")
    if fused is False or fused == "off" or (fused == "auto" and config.fused == "off"):
        raise _not_ported("the non-fused pure-torch iLQR (fused=False)",
                          "queue 1, non-fused pure-torch iLQR")
    if backward not in ("auto", "pallas") or (
            backward == "auto" and not (specs.state_dim <= 16 and specs.control_dim <= 4)):
        raise _not_ported(f"the scan backward pass (backward={backward!r})",
                          "queue 1, non-fused pure-torch iLQR")
    if (specs.eq_dim > 0 or specs.ineq_dim > 0) and specs.context is not None:
        raise _not_ported("AL constraints with a per-stage context",
                          "queue 1, AL constraints with a context")
    if not _constraints_batched(specs):
        raise _not_ported("a constraint that does not give [..., m] on batched values",
                          "queue 1, non-fused pure-torch iLQR")
    if not specs.objective_is_default:
        raise _not_ported("a user objective_function", "queue 1, non-fused pure-torch iLQR")
    if specs.derivative_mode != "ad":
        raise _not_ported("derivative_mode='fd'", "queue 1, model zoo and derivative oracles")
    if config.jacobian_mode != "discrete":
        raise _not_ported("jacobian_mode='continuous'", "queue 1, non-fused pure-torch iLQR")


def _constraints_batched(specs: OCPSpec) -> bool:
    """Do the constraint callables give ``[..., m]`` (or a constant ``[m]``)
    on batched values ``x [2, nx]``, ``u [2, nu]``?  The counterpart of the
    JAX router's ``_lane_constraints_traceable``."""
    x = torch.zeros((2, specs.state_dim), dtype=torch.float32,
                    device=specs.initial_state.device)
    u = torch.zeros((2, specs.control_dim), dtype=torch.float32, device=x.device)
    for fn, m in ((specs.equality_constraints, specs.eq_dim),
                  (specs.inequality_constraints, specs.ineq_dim)):
        if m == 0:
            continue
        try:
            shape = tuple(fn(x, u).shape)
        except Exception:
            return False
        if shape not in ((2, m), (m,)):
            return False
    return True


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


def _lane_objective(spec: OCPSpec, xs: torch.Tensor, xT: torch.Tensor, us: torch.Tensor):
    """The true (un-augmented) objective per problem ``[B]``: the stage
    costs at ``(x_t, u_t, t)`` summed over the horizon, plus the terminal
    cost at ``x_T``.  ``t`` is the float stage index K3 passes."""
    x, u = xs.permute(0, 2, 1), us.permute(0, 2, 1)
    t = torch.arange(xs.shape[0], dtype=xs.dtype, device=xs.device)[:, None].expand(x.shape[:2])
    stage = torch.broadcast_to(spec.stage_cost(x, u, t), x.shape[:2])
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


def solve_ilqr_batched_fused(specs: OCPSpec, config: ILQRConfig, ops: FusedOps = None,
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

    ladder_full = _alpha_ladder_floats(config.alpha_min)
    ladder_short = tuple(float(a) for a in config.alpha_ladder) if config.alpha_ladder else ladder_full
    use_schedule = config.alpha_warmup > 0 and ladder_short != ladder_full

    xs_tail, cost = ops.rollout(specs, x0, us, ctx)
    xs = torch.cat([x0[None], xs_tail[:-1]], 0)                          # x_0..x_{T-1}
    xT = xs_tail[-1].clone()

    # Quadratic-cost hoisting: the Hessian stacks do not depend on the
    # trajectory, so they are computed once -- one block per problem for a
    # stationary cost, one per stage otherwise.
    if structure is None:
        structure = resolve_cost_structure(_unbatch(specs), config)
    quad, stationary = structure
    eq_fn = specs.equality_constraints if specs.eq_dim > 0 else None
    in_fn = specs.inequality_constraints if specs.ineq_dim > 0 else None
    has_al = eq_fn is not None or in_fn is not None
    stationary = stationary and not has_al
    fusedlin = stationary and config.stationary_fusedlin
    hess = None
    if stationary:
        hess = ops.linearize(specs, x0[None].contiguous(), us[:1].contiguous(), True)[4:]
    elif quad:
        hess = ops.linearize(specs, xs, us, True, ctx)[4:]
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
            k, K = ops.riccati(specs, xs, us, *(h[0] for h in hess), xT, levels, blb, bub)
        else:
            lin = ops.linearize(specs, xs, us, hess is None, ctx)
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
            new = (_lane_objective(specs, xs, xT, us),
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


def solve_ilqr_batched(
    specs: OCPSpec, config: ILQRConfig, backward: str = "auto", fused="auto",
    device="cuda",
) -> SolveResult:
    """Batched iLQR over specs whose leaves carry a leading batch axis.

    Runs on ``device`` (default ``"cuda"``; raises when CUDA is absent):
    the spec's tensors are moved there, and the fused loop runs its CUDA
    kernels on the card, or the plain PyTorch versions on ``"cpu"``.  The
    JAX router's fused branches in AD mode are ported (clamp and boxqp;
    unconstrained with or without a per-stage context, or AL-constrained
    without one); every other branch raises ``NotImplementedError``.
    """
    return solve_ilqr_batched_fused(_routed(specs, config, backward, fused, device), config)


def _routed(specs: OCPSpec, config: ILQRConfig, backward, fused, device) -> OCPSpec:
    """``specs`` on ``device`` once the route is checked."""
    dev = resolve_device(device)
    _check_route(specs, config, backward, fused)
    move = lambda t: None if t is None else t.to(dev)
    return specs.replace(
        initial_state=move(specs.initial_state),
        initial_controls=move(specs.initial_controls),
        input_lower_bounds=move(specs.input_lower_bounds),
        input_upper_bounds=move(specs.input_upper_bounds),
        context=move(specs.context),
    )


@register_solver
class ILQR(SolverBase):
    """The iLQR solver with the reference's ``set_params`` surface.

    ``device`` (default ``"cuda"``) is where its batched solves run;
    ``ops`` picks the kernels (None: :data:`KERNEL_OPS`) or
    :data:`PLAIN_OPS`.
    """

    name = "ilqr"
    config_cls = ILQRConfig

    def __init__(self, device="cuda", ops: FusedOps = None, **params):
        self.ops = ops
        super().__init__(device=device, **params)

    def _solve_batched_fn(self, specs: OCPSpec, config: ILQRConfig, structure=None) -> SolveResult:
        specs = _routed(specs, config, "auto", "auto", self.device)
        return solve_ilqr_batched_fused(specs, config, self.ops, structure)

    def resolve_structure(self, specs: OCPSpec, config: ILQRConfig):
        """The cost's ``(quadratic, stationary)`` of batched ``specs``."""
        return resolve_cost_structure(_unbatch(specs), config)
