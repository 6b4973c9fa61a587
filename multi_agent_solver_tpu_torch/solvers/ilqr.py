"""Batched iLQR: the lane-resident fused loop, stationary clamp branch.

PyTorch counterpart of ``multi_agent_solver_tpu/solvers/ilqr.py``
(``ILQRConfig``, the cost-structure probe and the stationary-cost branch of
``_solve_ilqr_batched_fused``).  Per solve it launches

* K2 (``ops/forward_select.rollout_cost``) once: the initial rollout and cost;
* K3 (``ops/linearize.linearize``) once, on one stage, to hoist the
  time-constant cost Hessians;
* per iteration K1 (``ops/riccati.riccati_fusedlin``), then K2 in select mode.

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

from ..ocp import OCPSpec
from ..ops import forward_select as _k2
from ..ops import linearize as _k3
from ..ops import riccati as _k1
from ..types import SolverParams, get_param, param_flag, resolve_device
from .base import SolveResult


@dataclasses.dataclass(frozen=True)
class ILQRConfig:
    """Solver configuration; the fields are the JAX ``ILQRConfig``'s, so a
    config carries across (``utils/carry.config_from_dict``).

    ``lane_fold`` and ``time_unroll`` are TPU-layout knobs (sublane folding
    of batch tiles; time steps per sequential grid step) with no effect on
    CUDA, where every kernel runs one problem per thread and the time loop
    inside it.  Only the fields of the stationary clamp branch change what
    this port computes; the others select branches that raise
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
    Non-finite values compare unequal.
    """
    if spec.context is not None:
        raise NotImplementedError(
            "context costs are not ported yet (ROADMAP queue 1, AL and context)")
    d = spec.derivs
    nx, nu, T = spec.state_dim, spec.control_dim, spec.horizon_steps
    rng = np.random.RandomState(0xC057)
    dev = spec.initial_state.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    x_pts = [f32(rng.standard_normal(nx)) for _ in range(2)]
    u_pts = [f32(rng.standard_normal(nu)) for _ in range(2)]

    def blocks(x, u, t):
        tt = torch.tensor(t, dtype=torch.int32, device=dev)
        return tuple(f(x, u, tt).detach().cpu().double().numpy() for f in (d.lxx, d.luu, d.lux))

    def match(a, b):
        return all(
            np.all(np.isfinite(p)) and np.all(np.isfinite(q))
            and np.allclose(p, q, rtol=1e-4, atol=1e-6)
            for p, q in zip(a, b)
        )

    q00 = blocks(x_pts[0], u_pts[0], 0)
    q01 = blocks(x_pts[1], u_pts[1], 0)
    q10 = blocks(x_pts[0], u_pts[0], T - 1)
    q11 = blocks(x_pts[1], u_pts[1], T - 1)
    p_terms = tuple((d.phixx(x).detach().cpu().double().numpy(),) for x in x_pts)
    quadratic = match(q00, q01) and match(q10, q11) and match(*p_terms)
    stationary = quadratic and match(q00, q10)
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
    """The four operations of the fused loop."""

    rollout: Callable
    linearize: Callable
    riccati: Callable
    select: Callable


# The wrappers: CUDA kernels on CUDA tensors, plain versions on CPU tensors.
KERNEL_OPS = FusedOps(_k2.rollout_cost, _k3.linearize, _k1.riccati_fusedlin, _k2.forward_select)
# The plain PyTorch versions on any device: the reference the kernels are
# held against on the card (chip_smoke.py).
PLAIN_OPS = FusedOps(_k2.rollout_cost_plain, _k3.linearize_plain,
                     _k1.riccati_fusedlin_plain, _k2.forward_select_plain)


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
    if specs.eq_dim > 0 or specs.ineq_dim > 0:
        raise _not_ported("AL constraints", "queue 1, AL and context")
    if specs.context is not None:
        raise _not_ported("per-stage context costs", "queue 1, AL and context")
    if config.bound_mode == "boxqp" and specs.has_input_bounds:
        raise _not_ported("bound_mode='boxqp'", "queue 1, boxqp")
    if not specs.objective_is_default:
        raise _not_ported("a user objective_function", "queue 1, non-fused pure-torch iLQR")
    if specs.derivative_mode != "ad":
        raise _not_ported("derivative_mode='fd'", "queue 1, model zoo and derivative oracles")
    if config.jacobian_mode != "discrete":
        raise _not_ported("jacobian_mode='continuous'", "queue 1, non-fused pure-torch iLQR")
    if not config.stationary_fusedlin:
        raise _not_ported("stationary_fusedlin=False (the K3 + K4 route)", "queue 2, K4")


def _unbatch(specs: OCPSpec) -> OCPSpec:
    """One problem's spec (statics carrier for the cost probe)."""
    return specs.replace(initial_state=specs.initial_state[0],
                         initial_controls=specs.initial_controls[0])


def solve_ilqr_batched_fused(specs: OCPSpec, config: ILQRConfig, ops: FusedOps = KERNEL_OPS) -> SolveResult:
    """The fused loop, stationary clamp branch, on the device of ``specs``.

    Spec leaves carry a leading batch axis (``initial_state [B, nx]``,
    ``initial_controls [B, T, nu]``, bounds ``[nu]`` or ``[B, nu]``).
    ``ops`` picks the kernels (default) or, with :data:`PLAIN_OPS`, the
    plain versions on the same device.
    """
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
    lb = ub = None
    if specs.has_input_bounds:
        lb = pack(specs.input_lower_bounds.expand(B, nu), (1, 0))
        ub = pack(specs.input_upper_bounds.expand(B, nu), (1, 0))

    ladder_full = _alpha_ladder_floats(config.alpha_min)
    ladder_short = tuple(float(a) for a in config.alpha_ladder) if config.alpha_ladder else ladder_full
    use_schedule = config.alpha_warmup > 0 and ladder_short != ladder_full

    xs_tail, cost = ops.rollout(specs, x0, us)
    xs = torch.cat([x0[None], xs_tail[:-1]], 0)                          # x_0..x_{T-1}
    xT = xs_tail[-1].clone()

    _, stationary = resolve_cost_structure(_unbatch(specs), config)
    if not stationary:
        raise _not_ported("a non-stationary or non-quadratic cost",
                          "queue 2, K4 (riccati_backward_pallas_tiled)")
    lin = ops.linearize(specs, x0[None].contiguous(), us[:1].contiguous(), True)
    lxx, luu, lux = (h[0] for h in lin[4:])                             # time-constant blocks
    levels = _k1.reg_ladder(config.reg_init, config.reg_factor, config.reg_levels)

    converged = torch.zeros(B, dtype=torch.bool, device=dev)
    it = 0
    while it < config.max_iterations:
        # The JAX fused loop's while_loop predicate any(~converged) becomes a
        # host check, once per iteration.
        if config.early_exit and it > 0 and bool(converged.all()):
            break
        active = ~converged
        merit = cost
        k, K = ops.riccati(specs, xs, us, lxx, luu, lux, xT, levels)
        ladder = ladder_full if use_schedule and it < config.alpha_warmup else ladder_short
        cost, _ = ops.select(specs, xs, us, xT, k, K, merit, active, lb, ub, ladder)
        converged = converged | (active & (merit - cost < config.tolerance))
        it += 1

    states = torch.cat([x0[None], xs[1:], xT[None]], 0).permute(2, 0, 1)  # [B, T+1, nx]
    zeros = torch.zeros(B, dtype=out_dtype, device=dev)
    cost_out = cost.to(out_dtype)
    return SolveResult(
        states=states.to(out_dtype).contiguous(),
        controls=us.permute(2, 0, 1).to(out_dtype).contiguous(),
        cost=cost_out,
        iterations=torch.full((B,), it, dtype=torch.int32, device=dev),
        converged=converged,
        merit=cost_out,
        eq_violation=zeros,
        ineq_violation=zeros,
    )


def solve_ilqr_batched(
    specs: OCPSpec, config: ILQRConfig, backward: str = "auto", fused="auto",
    device="cuda",
) -> SolveResult:
    """Batched iLQR over specs whose leaves carry a leading batch axis.

    Runs on ``device`` (default ``"cuda"``; raises when CUDA is absent):
    the spec's tensors are moved there, and the fused loop runs its CUDA
    kernels on the card, or the plain PyTorch versions on ``"cpu"``.  Only
    the JAX router's fused stationary clamp branch is ported; every other
    branch raises ``NotImplementedError``.
    """
    dev = resolve_device(device)
    _check_route(specs, config, backward, fused)
    move = lambda t: None if t is None else t.to(dev)
    specs = specs.replace(
        initial_state=move(specs.initial_state),
        initial_controls=move(specs.initial_controls),
        input_lower_bounds=move(specs.input_lower_bounds),
        input_upper_bounds=move(specs.input_upper_bounds),
    )
    return solve_ilqr_batched_fused(specs, config)
