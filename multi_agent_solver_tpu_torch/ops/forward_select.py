"""K2: forward line search with in-kernel step-size selection.

Port of ``multi_agent_solver_tpu/ops/forward_select_pallas.py ::
forward_select_pallas_tiled`` in its two modes on the iLQR main path; the
CUDA kernels are in ``csrc/forward_select.cuh``, instantiated in
``csrc/forward_select*.cu`` (one launch counter for the select without a
context, ``STATS``, one with, ``CTX_STATS``, and one for the rollout mode
with or without, ``ROLLOUT_STATS``):

* :func:`rollout_cost` -- the initial rollout and its cost: alpha 0, zero
  gains, no clamp, merit +inf (a NaN cost becomes +inf, and a state that is
  not finite makes every later control NaN, as the TPU kernel's).  ``x0
  [nx, B]``, ``us [T, nu, B]`` -> ``xs [T, nx, B]`` holding x_1..x_T,
  ``cost [B]``.  It runs on a kernel of its own, one thread a problem
  (``forward_rollout_kernel``), with or without a context.
* :func:`forward_select` -- stage-out mode: every candidate alpha scored,
  the largest one that beats ``merit`` on an active problem re-rolled.
  ``xs [T, nx, B]`` (x_0..x_{T-1}), ``us [T, nu, B]`` and ``xT [nx, B]``
  are updated IN PLACE -- the port's one in-place update, the counterpart
  of the TPU kernel's input/output aliasing: an accepted problem's column
  becomes the new trajectory, a rejected or frozen one keeps the reference
  verbatim.  Returns ``(merit_new [B], accept [B] bool)``.

Stage costs see the integer stage index, as in the TPU kernel.  Both modes
take an optional per-stage context ``ctx [T, K, C, B]`` (the context mode
of the select kernel, K6 in the ROADMAP's numbering): the stage cost is
then ``stage_cost(x, u, t, ctx_t)``, as with the TPU kernel's ``ctx_l``.
The select mode with a context (with or without AL) launches a lane-group
kernel, one candidate a lane (``forward_select_group_kernel``); without a
context (with or without AL) a lane kernel (``forward_select_lanes_kernel``,
the A lanes of a problem packed in a warp) and its re-roll launch, which
reads the kept alphas from a ``[B]`` scratch tensor that the wrapper
allocates.  Their results are the one-thread kernel's bit for bit.

The select mode also has an AL mode (K6's other half, the TPU kernel's
``eq_mult_l`` / ``ineq_mult_l`` / ``rho_l``): with ``rho [B]`` and the
multipliers ``eq_mult [T, m_eq, B]`` and/or ``ineq_mult [T, m_in, B]``,
every candidate's stage cost gains the AL merit terms of the spec's
constraints at its ``(x_t, u_t)`` -- ``lambda g + 0.5 rho g g`` per
equality row, ``(mu a) s + 0.5 rho s s`` per inequality row with the
activation ``a = [h > -act_tol]`` and ``s = max(h, 0) a`` -- summed in
row order and added to the stage cost before it joins the candidate's sum.
Its launches are counted apart (``AL_STATS``); the kernel instantiation is
named by the constraints' device-function tags (``none``, the tag of
``types.no_constraint``, for an absent side), and an untagged constraint
on a CUDA tensor raises
``NotImplementedError``.  The rollout mode takes no AL.  The AL mode takes
a context too (a constrained agent of a coupled game): each candidate's
step is then ``stage_cost(x, u, t, ctx_t)`` plus the AL terms, stage
first, as the TPU kernel sums them; those launches are counted on
``AL_CTX_STATS``.

:func:`forward_select_emit_lin` is the select kernel's emit mode (K8, the
TPU kernel's ``emit_lin``): the select without the stage-out contract --
every problem live, every problem re-rolled at its selected alpha (0 where
none improved) into fresh buffers -- that also returns the linearization
at the accepted ``(x_t, u_t)`` in K3's layout, through the RK4 step or the
continuous dynamics, with or without a context, and with or without AL
multipliers (they enter the select's merit; the stacks are the
un-augmented cost's).  The card runs it as one kernel, a thread a problem
that scores the candidates, re-rolls at the kept alpha and linearizes each
stage with K3's device code; with a context as three (the group select, a
re-roll of every problem, K3's context mode at the emitted trajectory).
Its stacks are K3's floats.  No solve path calls it; its calls are
counted on ``EMIT_STATS``.

The non-fused path calls the kernel through two batch-first wrappers,
the JAX package's ``forward_select_pallas`` and ``rollout_select``
(:func:`forward_select_pallas`, :func:`rollout_select`): trajectories
``[B, T+1, nx]``, controls ``[B, T, nu]``, gains ``[B, T, ...]`` of any
float dtype, converted once to the port's layout and back.
"""

from __future__ import annotations

import math

import torch

from ..integrators import integrate_rk4
from ..types import Tensor, no_constraint
from ._build import (KernelStats, check_context, check_tensor, launch, problem_symbol,
                     stage_major, step_constants)
from .linearize import linearize_plain

STATS = KernelStats()         # the select's launches and plain calls without a context
CTX_STATS = KernelStats()     # ... and with one (the context mode, K6)
AL_STATS = KernelStats()      # ... in the AL mode (K6)
AL_CTX_STATS = KernelStats()  # ... in the AL mode with a context (K6)
EMIT_STATS = KernelStats()    # the emit mode (K8)
ROLLOUT_STATS = KernelStats()  # the rollout mode, with or without a context
MAX_ALPHAS = 16   # candidates the CUDA kernels take


def _stats(ctx, al=False) -> KernelStats:
    if al:
        return AL_STATS if ctx is None else AL_CTX_STATS
    return STATS if ctx is None else CTX_STATS


def _constraint_rows(fn, x: Tensor, u: Tensor) -> Tensor:
    """``fn(x [B, nx], u [B, nu])`` as ``[B, m]`` (a constant ``[m]``
    broadcast)."""
    g = fn(x, u)
    return torch.broadcast_to(g, x.shape[:-1] + g.shape[-1:])


def al_terms(spec, x, u, t, eq_mult, ineq_mult, half_rho, act_tol):
    """AL merit terms at ``(x [B, nx], u [B, nu])`` of stage ``t``, in the
    TPU kernel's order: from 0, per equality row ``lambda g + half_rho g g``,
    then per inequality row ``(mu a) s + half_rho s s`` with
    ``a = [h > -act_tol]`` and ``s = max(h, 0) a`` (NaN-propagating max)."""
    total = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    if eq_mult is not None:
        g = _constraint_rows(spec.equality_constraints, x, u)
        lam = eq_mult[t]
        for m in range(lam.shape[0]):
            total = total + lam[m] * g[:, m] + half_rho * g[:, m] * g[:, m]
    if ineq_mult is not None:
        h = _constraint_rows(spec.inequality_constraints, x, u)
        lam = ineq_mult[t]
        zero = h.new_zeros(())
        for m in range(lam.shape[0]):
            active = (h[:, m] > -act_tol).to(torch.float32)
            s = torch.maximum(h[:, m], zero) * active
            total = total + (lam[m] * active) * s + half_rho * s * s
    return total


def stage_fn(spec, ctx, t):
    """The stage cost of stage ``t`` on batch-first values: ``spec.stage_cost``,
    or with ``ctx [T, ..., B]`` the cost with stage t's context bound."""
    if ctx is None:
        return spec.stage_cost
    ctx_t = ctx[t].movedim(-1, 0)
    return lambda x, u, tt: spec.stage_cost(x, u, tt, ctx_t)


def _control(x, x_ref, u_ref, k_t, K_t, alpha, lb, ub):
    """``clamp(u_ref + alpha k + K (x - x_ref))`` on ``[B, n]`` tensors, in
    the TPU kernel's order of operations."""
    nx, nu = x.shape[-1], u_ref.shape[-1]
    dx = x - x_ref
    rows = []
    for i in range(nu):
        u_i = u_ref[:, i] + alpha * k_t[:, i] + sum(K_t[:, i, j] * dx[:, j] for j in range(nx))
        if lb is not None:
            u_i = torch.minimum(torch.maximum(u_i, lb[:, i]), ub[:, i])
        rows.append(u_i)
    return torch.stack(rows, -1)


def rollout_cost_plain(spec, x0: Tensor, us: Tensor, ctx: Tensor = None):
    """Plain PyTorch version of the K2 rollout mode."""
    ROLLOUT_STATS.plain_calls += 1
    T, nu, B = us.shape
    x = x_start = x0.T
    xs = torch.empty((T, x0.shape[0], B), dtype=torch.float32, device=x0.device)
    total = torch.zeros(B, dtype=torch.float32, device=x0.device)
    for t in range(T):
        # u_ref + 0 k + 0 (x - x_0), as the TPU kernel's alpha-0, zero-gain
        # control: NaN from the first stage whose state is not finite on.
        u = us[t].T + (0.0 * (x - x_start)).sum(-1, keepdim=True)
        total = total + stage_fn(spec, ctx, t)(x, u, t)
        x = integrate_rk4(x, u, spec.dt, spec.dynamics)
        xs[t] = x.T
    total = total + spec.terminal_cost(x)
    return xs, torch.where(total < math.inf, total, torch.full_like(total, math.inf))


def _score(spec, xs, us, k, K, merit, live, lbT, ubT, alphas, ctx, eq_mult, ineq_mult, rho,
           act_tol):
    """Phase 1 and the selection of the select mode: every candidate rolled
    out from ``x_0`` with its stage costs (plus the AL terms with ``rho``)
    summed, the terminal cost added, and from the smallest alpha up the
    last candidate that beats ``merit`` on a ``live`` problem kept.
    Returns ``(x_0 [B, nx], best merit [B], selected alpha [B], found
    [B])``."""
    has_al = rho is not None
    half_rho = 0.5 * rho if has_al else None
    T, nx, B = xs.shape
    x_start = xs[0].T.clone()
    xa = [x_start for _ in alphas]
    ca = [torch.zeros(B, dtype=torch.float32, device=xs.device) for _ in alphas]
    for t in range(T):
        x_ref, u_ref, k_t, K_t = xs[t].T, us[t].T, k[t].T, K[t].permute(2, 0, 1)
        stage = stage_fn(spec, ctx, t)
        for a, alpha in enumerate(alphas):
            u = _control(xa[a], x_ref, u_ref, k_t, K_t, alpha, lbT, ubT)
            step = stage(xa[a], u, t)
            if has_al:
                step = step + al_terms(spec, xa[a], u, t, eq_mult, ineq_mult, half_rho, act_tol)
            ca[a] = ca[a] + step
            xa[a] = integrate_rk4(xa[a], u, spec.dt, spec.dynamics)

    best = merit.clone()
    sel = torch.zeros(B, dtype=torch.float32, device=xs.device)
    found = torch.zeros(B, dtype=torch.bool, device=xs.device)
    for a in range(len(alphas) - 1, -1, -1):
        total = ca[a] + spec.terminal_cost(xa[a])
        ok = (total < merit) & live
        sel = torch.where(ok, torch.full_like(sel, alphas[a]), sel)
        best = torch.where(ok, total, best)
        found = found | ok
    return x_start, best, sel, found


def _reroll(spec, x_start, xs, us, k, K, sel, lbT, ubT):
    """Phase 2: the feedback rollout at the selected alphas, yielding ``(t,
    x_t, u_t, x_{t+1})`` stage by stage (each stage's reference is read
    before the caller may overwrite it)."""
    x = x_start
    for t in range(xs.shape[0]):
        x_ref, u_ref, k_t, K_t = xs[t].T, us[t].T, k[t].T, K[t].permute(2, 0, 1)
        u = _control(x, x_ref, u_ref, k_t, K_t, sel, lbT, ubT)
        x_next = integrate_rk4(x, u, spec.dt, spec.dynamics)
        yield t, x, u, x_next
        x = x_next


def forward_select_plain(spec, xs, us, xT, k, K, merit, active, lb, ub, alphas, ctx=None,
                         eq_mult=None, ineq_mult=None, rho=None, act_tol=1e-6):
    """Plain PyTorch version of the K2 select mode (same in-place contract)."""
    _stats(ctx, rho is not None).plain_calls += 1
    lbT = lb.T if lb is not None else None
    ubT = ub.T if ub is not None else None
    x_start, best, sel, found = _score(spec, xs, us, k, K, merit, active, lbT, ubT, alphas, ctx,
                                       eq_mult, ineq_mult, rho, act_tol)
    keep = found[:, None]
    x = x_start
    for t, x, u, x_next in _reroll(spec, x_start, xs, us, k, K, sel, lbT, ubT):
        xs[t] = torch.where(keep, x, xs[t].T).T
        us[t] = torch.where(keep, u, us[t].T).T
        x = x_next
    xT.copy_(torch.where(keep, x, xT.T).T)
    return best, found


def forward_select_emit_lin_plain(spec, xs, us, k, K, merit, lb, ub, alphas, ctx=None,
                                  discrete=True, eq_mult=None, ineq_mult=None, rho=None,
                                  act_tol=1e-6):
    """Plain PyTorch version of K8: the select mode's scoring, every problem
    live, the re-roll of every problem at its selected alpha, and
    :func:`linearize.linearize_plain` (with Hessians, in the Jacobian mode
    ``discrete``) at the accepted ``(x_t, u_t)``; the un-augmented stage
    cost.  Returns ``(xs_new [T, nx, B]`` holding x_1..x_T, ``us_new [T,
    nu, B]``, ``merit_new [B]``, ``accept [B]``, ``A, B, lx, lu, lxx, luu,
    lux)``, the stacks in K3's layout."""
    EMIT_STATS.plain_calls += 1
    T, nx, B = xs.shape
    lbT = lb.T if lb is not None else None
    ubT = ub.T if ub is not None else None
    live = torch.ones(B, dtype=torch.bool, device=xs.device)
    x_start, best, sel, found = _score(spec, xs, us, k, K, merit, live, lbT, ubT, alphas, ctx,
                                       eq_mult, ineq_mult, rho, act_tol)
    xs_stage, us_new, xs_new = torch.empty_like(xs), torch.empty_like(us), torch.empty_like(xs)
    for t, x, u, x_next in _reroll(spec, x_start, xs, us, k, K, sel, lbT, ubT):
        xs_stage[t], us_new[t], xs_new[t] = x.T, u.T, x_next.T
    lin = linearize_plain(spec, xs_stage, us_new, True, ctx, discrete)
    return (xs_new, us_new, best, found) + lin


def rollout_cost(spec, x0: Tensor, us: Tensor, ctx: Tensor = None):
    """K2 rollout mode on the card for CUDA tensors, plain for CPU tensors."""
    if x0.device.type == "cpu":
        return rollout_cost_plain(spec, x0, us, ctx)
    return launch_rollout_cost(spec, x0, us, ctx)


def launch_rollout_cost(spec, x0: Tensor, us: Tensor, ctx: Tensor = None):
    """The CUDA launch of the K2 rollout mode (``forward_rollout_kernel``)."""
    T, nu, B = us.shape
    nx = x0.shape[0]
    check_tensor(x0, "x0", (nx, B), x0.device)
    check_tensor(us, "us", (T, nu, B), x0.device)
    symbol, params = _symbol(spec, nx, nu)
    n_ctx = check_context(ctx, spec.stage_cost, T, nx, B, x0.device)
    xs = torch.empty((T, nx, B), dtype=torch.float32, device=x0.device)
    cost = torch.empty(B, dtype=torch.float32, device=x0.device)
    with torch.cuda.device(x0.device):
        launch(symbol, 1, x0, xs, us, None, None, None, None, None, None, None,
               cost, None, None, ctx, None, None, None, 0.0, T, B, n_ctx, nx, 0, 0, *params,
               step_constants(spec.dt), (0.0,), 1)
    ROLLOUT_STATS.launches += 1
    return xs, cost


def forward_select(spec, xs, us, xT, k, K, merit, active, lb, ub, alphas, ctx=None,
                   eq_mult=None, ineq_mult=None, rho=None, act_tol=1e-6):
    """K2 select mode on the card for CUDA tensors, plain for CPU tensors.

    ``lb``/``ub`` are ``[nu, B]`` absolute bounds or both None (no clamp);
    ``active [B]`` is bool.  Updates ``xs``, ``us`` and ``xT`` in place.
    The AL mode runs when ``rho [B]`` is given, with ``eq_mult
    [T, m_eq, B]`` for the spec's equality constraints and/or
    ``ineq_mult [T, m_in, B]`` for its inequalities.
    """
    alphas = tuple(float(a) for a in alphas)
    if not 1 <= len(alphas) <= MAX_ALPHAS:
        raise ValueError(f"{len(alphas)} alphas; the kernel takes 1..{MAX_ALPHAS}")
    if (lb is None) != (ub is None):
        raise ValueError("pass both bounds or neither")
    if (rho is None) != (eq_mult is None and ineq_mult is None):
        raise ValueError("the AL mode takes rho with eq_mult and/or ineq_mult")
    args = (spec, xs, us, xT, k, K, merit, active, lb, ub, alphas, ctx, eq_mult, ineq_mult, rho,
            float(act_tol))
    if xs.device.type == "cpu":
        return forward_select_plain(*args)
    return launch_forward_select(*args)


def launch_forward_select(spec, xs, us, xT, k, K, merit, active, lb, ub, alphas, ctx=None,
                          eq_mult=None, ineq_mult=None, rho=None, act_tol=1e-6):
    """The CUDA launch of the K2 select mode (and of its AL mode)."""
    T, nx, B = xs.shape
    nu = us.shape[1]
    dev = xs.device
    has_al = rho is not None
    for t, name, shape in ((xs, "xs", (T, nx, B)), (us, "us", (T, nu, B)),
                           (xT, "xT", (nx, B)), (k, "k", (T, nu, B)),
                           (K, "K", (T, nu, nx, B)), (merit, "merit", (B,))):
        check_tensor(t, name, shape, dev)
    m_eq, m_in, constraints = _al_inputs(spec, T, B, dev, eq_mult, ineq_mult, rho)
    if lb is not None:
        check_tensor(lb, "lb", (nu, B), dev)
        check_tensor(ub, "ub", (nu, B), dev)
    if active.dtype != torch.bool or tuple(active.shape) != (B,) or active.device != dev \
            or not active.is_contiguous():
        raise ValueError("active: expected a contiguous bool tensor of shape (B,) on the card")
    symbol, params = _symbol(spec, nx, nu, *constraints)
    n_ctx = check_context(ctx, spec.stage_cost, T, nx, B, dev)
    merit_new = torch.empty(B, dtype=torch.float32, device=dev)
    accept = torch.empty(B, dtype=torch.bool, device=dev)
    # The lane select's kept alphas, read by its re-roll launch.
    kept = torch.empty(B, dtype=torch.float32, device=dev) if ctx is None else None
    with torch.cuda.device(dev):
        launch(symbol, 0, None, xs, us, xT, k, K, merit, active, lb, ub, merit_new,
               accept, kept, ctx, eq_mult, ineq_mult, rho, act_tol, T, B, n_ctx, nx, m_eq, m_in,
               *params, step_constants(spec.dt), alphas, len(alphas))
    _stats(ctx, has_al).launches += 1
    return merit_new, accept


def forward_select_emit_lin(spec, xs, us, k, K, merit, lb, ub, alphas, ctx=None, discrete=True,
                            eq_mult=None, ineq_mult=None, rho=None, act_tol=1e-6):
    """K8 on the card for CUDA tensors, the plain version for CPU tensors.

    ``xs [T, nx, B]`` (x_0..x_{T-1}), ``us [T, nu, B]``, ``k``, ``K``,
    ``merit [B]``, ``lb``/``ub [nu, B]`` or both None, the candidates and an
    optional context ``ctx [T, K, C, B]``; the inputs are only read.
    Returns :func:`forward_select_emit_lin_plain`'s eleven outputs.  With
    AL multipliers (``rho`` with ``eq_mult`` and/or ``ineq_mult``) the
    select scores the AL merit, as the select mode's AL mode does; the
    emitted stacks stay the un-augmented cost's."""
    alphas = tuple(float(a) for a in alphas)
    if not 1 <= len(alphas) <= MAX_ALPHAS:
        raise ValueError(f"{len(alphas)} alphas; the kernel takes 1..{MAX_ALPHAS}")
    if (lb is None) != (ub is None):
        raise ValueError("pass both bounds or neither")
    if (rho is None) != (eq_mult is None and ineq_mult is None):
        raise ValueError("the AL mode takes rho with eq_mult and/or ineq_mult")
    args = (spec, xs, us, k, K, merit, lb, ub, alphas, ctx, bool(discrete), eq_mult, ineq_mult,
            rho, float(act_tol))
    if xs.device.type == "cpu":
        return forward_select_emit_lin_plain(*args)
    return launch_forward_select_emit_lin(*args)


def launch_forward_select_emit_lin(spec, xs, us, k, K, merit, lb, ub, alphas, ctx=None,
                                   discrete=True, eq_mult=None, ineq_mult=None, rho=None,
                                   act_tol=1e-6):
    """The CUDA launch of K8, with or without AL: one kernel a thread a
    problem, or with a context three on one stream (the group select, the
    re-roll of every problem, K3's context mode at the emitted
    trajectory); the instantiation is named by the spec's device functions
    and, with AL, its constraints' (``NotImplementedError`` names a missing
    one)."""
    T, nx, B = xs.shape
    nu = us.shape[1]
    dev = xs.device
    for t, name, shape in ((xs, "xs", (T, nx, B)), (us, "us", (T, nu, B)), (k, "k", (T, nu, B)),
                           (K, "K", (T, nu, nx, B)), (merit, "merit", (B,))):
        check_tensor(t, name, shape, dev)
    if lb is not None:
        check_tensor(lb, "lb", (nu, B), dev)
        check_tensor(ub, "ub", (nu, B), dev)
    m_eq, m_in, constraints = _al_inputs(spec, T, B, dev, eq_mult, ineq_mult, rho)
    symbol, params = _symbol(spec, nx, nu, *constraints, kernel="forward_select_emit")
    n_ctx = check_context(ctx, spec.stage_cost, T, nx, B, dev)
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    xs_new, us_new = empty(T, nx, B), empty(T, nu, B)
    merit_new = empty(B)
    # The group select's kept alphas, read by the re-roll launch (with a context).
    kept = empty(B) if ctx is not None else None
    accept = torch.empty(B, dtype=torch.bool, device=dev)
    lin = (empty(T, nx, nx, B), empty(T, nx, nu, B), empty(T, nx, B), empty(T, nu, B),
           empty(T, nx, nx, B), empty(T, nu, nu, B), empty(T, nu, nx, B))
    with torch.cuda.device(dev):
        launch(symbol, xs, us, k, K, merit, lb, ub, merit_new, accept, kept, ctx, eq_mult,
               ineq_mult, rho, act_tol, T, B, n_ctx, nx, m_eq, m_in, int(discrete), *params,
               step_constants(spec.dt), alphas, len(alphas), xs_new, us_new, *lin)
    EMIT_STATS.launches += 1
    return (xs_new, us_new, merit_new, accept) + lin


def _al_inputs(spec, T, B, dev, eq_mult, ineq_mult, rho):
    """``(m_eq, m_in, constraints)`` of a launch: the checked multipliers'
    row counts, and with ``rho`` the two constraint sides' callables for
    :func:`_symbol` (``no_constraint`` for an absent side), else ``()``."""
    if rho is None:
        return 0, 0, ()
    check_tensor(rho, "rho", (B,), dev)
    m_eq = m_in = 0
    if eq_mult is not None:
        m_eq = spec.eq_dim
        check_tensor(eq_mult, "eq_mult", (T, m_eq, B), dev)
    if ineq_mult is not None:
        m_in = spec.ineq_dim
        check_tensor(ineq_mult, "ineq_mult", (T, m_in, B), dev)
    return m_eq, m_in, (spec.equality_constraints if eq_mult is not None else no_constraint,
                        spec.inequality_constraints if ineq_mult is not None else no_constraint)


def _symbol(spec, nx, nu, *constraints, kernel="forward_select"):
    """Symbol and parameters of ``kernel``'s instantiation for the spec's
    device functions; the non-AL instantiations carry ``no_constraint`` on
    both sides without naming them."""
    symbol, params = problem_symbol(kernel, nx, nu, spec.dynamics, spec.stage_cost,
                                    spec.terminal_cost, *constraints)
    if not constraints:
        params = params + [(), ()]
    return symbol, params


def _bounds(spec, B: int):
    """The spec's input bounds as ``[nu, B]`` float32, or ``(None, None)``."""
    if not spec.has_input_bounds:
        return None, None
    nu = spec.control_dim
    return tuple(stage_major(b.expand(B, nu))
                 for b in (spec.input_lower_bounds, spec.input_upper_bounds))


def _context(spec):
    """The spec's context ``[B, T, ...]`` as ``[T, ..., B]`` float32, or None."""
    return None if spec.context is None else stage_major(spec.context)


def forward_select_pallas(spec, xs, us, k, K, merit, alphas, eq_mult=None, ineq_mult=None,
                          rho=None, act_tol: float = 1e-6, select=None):
    """The select kernel on batch-first tensors (the JAX package's
    ``forward_select_pallas``): ``xs [B, T+1, nx]``, ``us [B, T, nu]``,
    ``k [B, T, nu]``, ``K [B, T, nu, nx]``, ``merit [B]``, the spec's bounds
    and context, and in the AL mode ``eq_mult`` / ``ineq_mult [B, T, m]``
    and ``rho [B]``.  Returns float32 ``(xs_new [B, T+1, nx], us_new
    [B, T, nu], merit_new [B], accepted [B] bool)``: an accepted problem's
    winning trajectory with ``x_0`` prepended; the others' reference
    trajectory and their incoming merit.  The JAX kernel runs its
    non-stage-out mode here; this runs the stage-out kernel with every
    problem active, which returns the same.  ``select`` is the select
    function (None: :func:`forward_select`; :func:`forward_select_plain`
    runs the plain version on any device)."""
    select = forward_select if select is None else select
    B = xs.shape[0]
    xs_st = stage_major(xs[:, :-1])                                  # [T, nx, B]
    xT = stage_major(xs[:, -1])                                      # [nx, B]
    us_st = stage_major(us)
    al = ()
    if rho is not None:
        al = (None if eq_mult is None else stage_major(eq_mult),
              None if ineq_mult is None else stage_major(ineq_mult),
              rho.to(torch.float32).contiguous(), float(act_tol))
    active = torch.ones(B, dtype=torch.bool, device=xs.device)
    merit_new, accepted = select(spec, xs_st, us_st, xT, stage_major(k), stage_major(K),
                                 stage_major(merit), active, *_bounds(spec, B),
                                 tuple(float(a) for a in alphas), _context(spec), *al)
    xs_new = torch.cat([xs[:, :1].to(torch.float32), xs_st.movedim(-1, 0)[:, 1:],
                        xT.movedim(-1, 0)[:, None]], 1)
    return xs_new, us_st.movedim(-1, 0), merit_new, accepted


def rollout_select(spec, x0: Tensor, us: Tensor, rollout=None):
    """Plain batched rollout and cost through the select kernel's rollout
    mode (the JAX package's ``rollout_select``): ``x0 [B, nx]``,
    ``us [B, T, nu]`` applied raw -- bounds stripped, no AL -- with the
    spec's context.  Returns float32 ``xs [B, T+1, nx]`` and ``costs [B]``;
    a cost that does not beat ``+inf`` (NaN) is ``+inf``, as the JAX
    kernel keeps the merit it was given.  ``rollout`` is the rollout
    function (None: :func:`rollout_cost`)."""
    rollout = rollout_cost if rollout is None else rollout
    x0_st = stage_major(x0)
    xs_tail, cost = rollout(spec, x0_st, stage_major(us), _context(spec))
    xs = torch.cat([x0_st.movedim(-1, 0)[:, None], xs_tail.movedim(-1, 0)], 1)
    return xs, cost
