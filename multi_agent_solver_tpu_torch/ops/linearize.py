"""K3: whole-horizon linearization (A, B, lx, lu and optionally the cost
Hessians), and K7: the same derivatives on a flat grid of problem-stages.

Ports of ``multi_agent_solver_tpu/ops/linearize_pallas.py ::
linearize_pallas_tiled`` (K3) and ``linearize_pallas`` (K7); the CUDA
kernels are in ``csrc/linearize.cu``.  Both take the Jacobian mode:
``discrete=True`` differentiates the RK4 step map, ``discrete=False`` the
continuous dynamics ``f(x, u)`` (the reference's ``continuous_jacobians``).

Layout (the fused loop's, batch innermost): ``xs [T, nx, B]``,
``us [T, nu, B]`` in; ``A [T, nx, nx, B]``, ``B [T, nx, nu, B]``,
``lx [T, nx, B]``, ``lu [T, nu, B]`` and, with ``hessians``,
``lxx [T, nx, nx, B]``, ``luu [T, nu, nu, B]``, ``lux [T, nu, nx, B]`` out.

With ``ctx [T, K, C, B]`` (the context mode, the TPU kernel's ``ctx_l``)
the stage cost is ``stage_cost(x, u, t, ctx_t)``; the context is a
constant of the derivatives.  The card runs it on a lane-group kernel
(``linearize_group_kernel``) that sums the neighbours' pair costs over 8 or
32 lanes and a shuffle tree: another order of the sum than the plain
version's, within rtol 1e-5 of it.

:func:`linearize_hessians` is K3's hoist mode: the cost Hessians ``(lxx,
luu, lux)`` alone, in K3's layout, which the fused loop hoists once a
solve for a quadratic cost (the TPU driver runs K3 whole for them and keeps
its last three outputs).  The card runs ``linearize_hessians_kernel``: no
dynamics and no first-order pass, K3's device function for the Hessians,
so they are K3's floats; with a context it runs K3's context mode and keeps
its Hessians, as before (the fused loop never hoists with a context on the
card: a context cost there is ``Coupled``, which is not quadratic).

K10 (:func:`terminal_derivs_tiled`, the TPU function of the same name)
takes terminal states ``xT [nx, B]`` and gives the terminal cost's
gradient ``phix [nx, B]`` and Hessian ``phixx [nx, nx, B]``, its upper
triangle mirrored, by jvp over jvp (``csrc/terminal.cu``: second-order
duals, the device code K1 and K4 run for their terminal value; its plain
version, :func:`terminal_derivatives`, is the one K1's and K4's plain
versions run).  No solve path calls it.

K7 (:func:`linearize_pallas`, the non-fused path's ``linearize="pallas"``)
is batch-first: ``xs [B, T+1, nx]`` (the last state unused), ``us
[B, T, nu]`` of any float dtype in; ``A [B, T, nx, nx]``, ``B
[B, T, nx, nu]``, ``lx [B, T, nx]``, ``lu [B, T, nu]``, ``lxx
[B, T, nx, nx]``, ``luu [B, T, nu, nu]``, ``lux [B, T, nu, nx]`` float32
out, Hessians always; lane ``b T + t`` is one problem-stage, its stage
index a float.

:func:`linearize` and :func:`linearize_pallas` launch the kernel for CUDA
tensors and raise on anything it does not take; for CPU tensors they run
the plain versions; so does :func:`terminal_derivs_tiled`.  Launches are
counted per mode: ``STATS`` (discrete), ``CONT_STATS`` (continuous),
``CTX_STATS`` (a context, either mode; the hoist with a context too),
``HOIST_STATS`` (the hoist mode), ``FLAT_STATS`` (K7) and
``TERMINAL_STATS`` (K10).
"""

from __future__ import annotations

import torch
from torch.func import jvp, vmap

from ..integrators import integrate_rk4
from ..types import Tensor
from ._build import (KernelStats, check_context, check_tensor, launch, problem_symbol,
                     step_constants)

STATS = KernelStats()       # launches and plain calls without a context
CTX_STATS = KernelStats()   # ... and with one (the context mode)
CONT_STATS = KernelStats()  # ... without one, in the continuous Jacobian mode
HOIST_STATS = KernelStats()  # the hoist mode (Hessians alone), without a context
FLAT_STATS = KernelStats()  # K7
TERMINAL_STATS = KernelStats()  # K10


def _stats(ctx, discrete=True) -> KernelStats:
    if ctx is not None:
        return CTX_STATS
    return STATS if discrete else CONT_STATS


def _basis(n: int, j: int, like: Tensor) -> Tensor:
    e = torch.zeros(like.shape[:-1] + (n,), dtype=like.dtype, device=like.device)
    e[..., j] = 1.0
    return e


def stage_derivatives(spec, x: Tensor, u: Tensor, t, discrete: bool = True):
    """``(A [..., nx, nx], B [..., nx, nu], lx [..., nx], lu [..., nu])`` of
    the RK4 step map (``discrete``; else of the continuous dynamics) and
    the stage cost at ``x [..., nx]``, ``u [..., nu]``: one
    ``torch.func.jvp`` per column, as the TPU kernel takes one jvp per
    basis direction."""
    nx, nu = x.shape[-1], u.shape[-1]
    if discrete:
        step = lambda xx, uu: integrate_rk4(xx, uu, spec.dt, spec.dynamics)
    else:
        step = spec.dynamics
    zeros = torch.zeros_like(x[..., 0])
    A = torch.stack(
        [jvp(lambda xx: step(xx, u), (x,), (_basis(nx, j, x),))[1] for j in range(nx)], -1)
    Bm = torch.stack(
        [jvp(lambda uu: step(x, uu), (u,), (_basis(nu, j, u),))[1] for j in range(nu)], -1)
    lx = torch.stack(
        [jvp(lambda a: spec.stage_cost(a, u, t), (x,), (_basis(nx, j, x),))[1] + zeros
         for j in range(nx)], -1)
    lu = torch.stack(
        [jvp(lambda a: spec.stage_cost(x, a, t), (u,), (_basis(nu, j, u),))[1] + zeros
         for j in range(nu)], -1)
    return A, Bm, lx, lu


def _row(h, zeros, a, directions):
    """``[jvp(h, (a,), (e,))[1] for e in directions]`` of a scalar-valued
    ``h``, each plus ``zeros``, by one ``torch.func.vmap`` over the
    directions: every direction sees the arithmetic of its own jvp, so
    the entries are the separate jvps' floats."""
    E = torch.stack(directions)
    return list((vmap(lambda e: jvp(h, (a,), (e,))[1])(E) + zeros).unbind(0))


def cost_hessians(spec, x: Tensor, u: Tensor, t):
    """``(lxx, luu, lux)`` by jvp over jvp: entry (i, j) is the jvp along
    e_j of the gradient along e_i (the directions j of a row in one
    vmapped jvp); upper triangles mirrored."""
    nx, nu = x.shape[-1], u.shape[-1]
    zeros = torch.zeros_like(x[..., 0])
    grad_x = lambda a, b, i: jvp(lambda z: spec.stage_cost(z, b, t), (a,), (_basis(nx, i, a),))[1]
    grad_u = lambda a, b, i: jvp(lambda z: spec.stage_cost(a, z, t), (b,), (_basis(nu, i, b),))[1]
    lxx = [[None] * nx for _ in range(nx)]
    for i in range(nx):
        row = _row(lambda a: grad_x(a, u, i), zeros, x, [_basis(nx, j, x) for j in range(i, nx)])
        for j, h in zip(range(i, nx), row):
            lxx[i][j] = lxx[j][i] = h
    luu = [[None] * nu for _ in range(nu)]
    for i in range(nu):
        row = _row(lambda b: grad_u(x, b, i), zeros, u, [_basis(nu, j, u) for j in range(i, nu)])
        for j, h in zip(range(i, nu), row):
            luu[i][j] = luu[j][i] = h
    lux = [_row(lambda a: grad_u(a, u, i), zeros, x, [_basis(nx, j, x) for j in range(nx)])
           for i in range(nu)]
    stack2 = lambda rows: torch.stack([torch.stack(r, -1) for r in rows], -2)
    return stack2(lxx), stack2(luu), stack2(lux)


def terminal_derivatives(terminal_fn, xT: Tensor):
    """``(phi_x, phi_xx)`` of ``terminal_fn`` at ``xT [B, nx]`` by jvp and
    jvp over jvp, as lists of ``[B]`` tensors; upper triangle mirrored (entry
    (i, j), j >= i, the jvp along e_j of the gradient along e_i, the
    directions j of a row in one vmapped jvp).  The plain version of K10,
    and the terminal value of K1's and K4's."""
    nx = xT.shape[-1]
    zeros = torch.zeros_like(xT[..., 0])
    grad_j = lambda a, j: jvp(terminal_fn, (a,), (_basis(nx, j, a),))[1] + zeros
    vx = [grad_j(xT, j) for j in range(nx)]
    vxx = [[None] * nx for _ in range(nx)]
    for i in range(nx):
        row = _row(lambda a: grad_j(a, i), zeros, xT, [_basis(nx, j, xT) for j in range(i, nx)])
        for j, h in zip(range(i, nx), row):
            vxx[i][j] = vxx[j][i] = h
    return vx, vxx


def terminal_derivs_tiled_plain(spec, xT: Tensor):
    """Plain PyTorch version of K10: :func:`terminal_derivatives` at ``xT
    [nx, B]``, stacked to ``(phix [nx, B], phixx [nx, nx, B])`` float32."""
    TERMINAL_STATS.plain_calls += 1
    vx, vxx = terminal_derivatives(spec.terminal_cost, xT.T)
    phix = torch.stack(vx).to(torch.float32)
    phixx = torch.stack([torch.stack(row) for row in vxx]).to(torch.float32)
    return phix.contiguous(), phixx.contiguous()


def terminal_derivs_tiled(spec, xT: Tensor):
    """K10 on the card for CUDA tensors, the plain version for CPU tensors."""
    if xT.device.type == "cpu":
        return terminal_derivs_tiled_plain(spec, xT)
    return launch_terminal_derivs_tiled(spec, xT)


def launch_terminal_derivs_tiled(spec, xT: Tensor):
    """The CUDA launch of K10."""
    nx, B = xT.shape
    check_tensor(xT, "xT", (nx, B), xT.device)
    symbol, (dyn_p, term_p) = problem_symbol("terminal_derivs", nx, spec.control_dim,
                                             spec.dynamics, spec.terminal_cost)
    phix = torch.empty((nx, B), dtype=torch.float32, device=xT.device)
    phixx = torch.empty((nx, nx, B), dtype=torch.float32, device=xT.device)
    with torch.cuda.device(xT.device):
        launch(symbol, xT, phix, phixx, B, dyn_p, term_p)
    TERMINAL_STATS.launches += 1
    return phix, phixx


def _stage_inputs(spec, xs: Tensor, us: Tensor, ctx: Tensor):
    """``(spec, x [T, B, nx], u [T, B, nu], t [T, B])``: the stage-major
    stacks batch-second, the spec's stage cost bound to the context (a
    constant of the derivatives), and the stage index as a float, as the
    TPU kernel passes it."""
    x = xs.permute(0, 2, 1)
    u = us.permute(0, 2, 1)
    if ctx is not None:
        ctx_b = ctx.movedim(-1, 1)               # [T, B, ...]
        spec = spec.replace(stage_cost=lambda a, b, tt, c=spec.stage_cost: c(a, b, tt, ctx_b))
    t = torch.arange(xs.shape[0], dtype=xs.dtype, device=xs.device)[:, None].expand(x.shape[:2])
    return spec, x, u, t


def _hessian_stacks(spec, x, u, t):
    """:func:`cost_hessians` in K3's layout, float32."""
    return tuple(h.permute(0, 2, 3, 1).to(torch.float32).contiguous()
                 for h in cost_hessians(spec, x, u, t))


def linearize_plain(spec, xs: Tensor, us: Tensor, hessians: bool = True, ctx: Tensor = None,
                    discrete: bool = True):
    """Plain PyTorch version of the K3 kernel (same layout and outputs)."""
    _stats(ctx, discrete).plain_calls += 1
    spec, x, u, t = _stage_inputs(spec, xs, us, ctx)
    A, Bm, lx, lu = stage_derivatives(spec, x, u, t, discrete)
    outs = [A.permute(0, 2, 3, 1), Bm.permute(0, 2, 3, 1), lx.permute(0, 2, 1), lu.permute(0, 2, 1)]
    outs = tuple(o.to(torch.float32).contiguous() for o in outs)
    return outs + (_hessian_stacks(spec, x, u, t) if hessians else ())


def linearize_hessians_plain(spec, xs: Tensor, us: Tensor, ctx: Tensor = None):
    """Plain PyTorch version of K3's hoist mode: :func:`linearize_plain`'s
    ``(lxx, luu, lux)`` alone, by the same jvp over jvp (counted on
    ``CTX_STATS`` with a context, which the card runs on K3's context
    mode)."""
    (HOIST_STATS if ctx is None else CTX_STATS).plain_calls += 1
    return _hessian_stacks(*_stage_inputs(spec, xs, us, ctx))


def linearize(spec, xs: Tensor, us: Tensor, hessians: bool = True, ctx: Tensor = None,
              discrete: bool = True):
    """K3 on the card for CUDA tensors, the plain version for CPU tensors."""
    if xs.device.type == "cpu":
        return linearize_plain(spec, xs, us, hessians, ctx, discrete)
    return launch_linearize(spec, xs, us, hessians, ctx, discrete)


def launch_linearize(spec, xs: Tensor, us: Tensor, hessians: bool = True, ctx: Tensor = None,
                     discrete: bool = True):
    """The CUDA launch of K3."""
    T, nx, B = xs.shape
    nu = us.shape[1]
    check_tensor(xs, "xs", (T, nx, B), xs.device)
    check_tensor(us, "us", (T, nu, B), xs.device)
    symbol, (dyn_p, cost_p) = problem_symbol("linearize", nx, nu, spec.dynamics, spec.stage_cost)
    n_ctx = check_context(ctx, spec.stage_cost, T, nx, B, xs.device)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=xs.device)
    outs = [empty(T, nx, nx, B), empty(T, nx, nu, B), empty(T, nx, B), empty(T, nu, B)]
    hess = [empty(T, nx, nx, B), empty(T, nu, nu, B), empty(T, nu, nx, B)] if hessians else [None] * 3
    with torch.cuda.device(xs.device):
        launch(symbol, xs, us, *outs, *hess, ctx, T, B, n_ctx, nx, int(hessians), int(discrete),
               dyn_p, cost_p, step_constants(spec.dt))
    _stats(ctx, discrete).launches += 1
    return tuple(outs + (hess if hessians else []))


def linearize_hessians(spec, xs: Tensor, us: Tensor, ctx: Tensor = None):
    """K3's hoist mode: ``(lxx [T, nx, nx, B], luu [T, nu, nu, B], lux [T,
    nu, nx, B])`` of the stage cost at ``xs [T, nx, B]``, ``us [T, nu, B]``;
    on the card for CUDA tensors (with a context: K3's context mode, its
    last three outputs), the plain version for CPU tensors."""
    if xs.device.type == "cpu":
        return linearize_hessians_plain(spec, xs, us, ctx)
    if ctx is not None:
        return launch_linearize(spec, xs, us, True, ctx)[4:]
    return launch_linearize_hessians(spec, xs, us)


def launch_linearize_hessians(spec, xs: Tensor, us: Tensor):
    """The CUDA launch of K3's hoist mode, without a context."""
    T, nx, B = xs.shape
    nu = us.shape[1]
    check_tensor(xs, "xs", (T, nx, B), xs.device)
    check_tensor(us, "us", (T, nu, B), xs.device)
    symbol, (_, cost_p) = problem_symbol("linearize_hessians", nx, nu, spec.dynamics,
                                         spec.stage_cost)
    check_context(None, spec.stage_cost, T, nx, B, xs.device)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=xs.device)
    hess = (empty(T, nx, nx, B), empty(T, nu, nu, B), empty(T, nu, nx, B))
    with torch.cuda.device(xs.device):
        launch(symbol, xs, us, *hess, T, B, cost_p)
    HOIST_STATS.launches += 1
    return hess


def _flat(xs: Tensor, us: Tensor):
    """``(x [L, nx], u [L, nu], t [L])`` float32 of the lanes ``b T + t``."""
    B, T, nu = us.shape
    x = xs[:, :-1].reshape(B * T, -1).to(torch.float32)
    u = us.reshape(B * T, nu).to(torch.float32)
    t = torch.arange(T, dtype=torch.float32, device=us.device).repeat(B)
    return x, u, t


def linearize_pallas_plain(spec, xs: Tensor, us: Tensor, discrete: bool):
    """Plain PyTorch version of the K7 kernel (same layout and outputs)."""
    FLAT_STATS.plain_calls += 1
    B, T, nu = us.shape
    nx = xs.shape[-1]
    x, u, t = _flat(xs, us)
    outs = stage_derivatives(spec, x, u, t, discrete) + cost_hessians(spec, x, u, t)
    inner = ((nx, nx), (nx, nu), (nx,), (nu,), (nx, nx), (nu, nu), (nu, nx))
    return tuple(o.to(torch.float32).reshape((B, T) + s).contiguous() for o, s in zip(outs, inner))


def linearize_pallas(spec, xs: Tensor, us: Tensor, discrete: bool):
    """K7 on the card for CUDA tensors, the plain version for CPU tensors."""
    if xs.device.type == "cpu":
        return linearize_pallas_plain(spec, xs, us, discrete)
    return launch_linearize_pallas(spec, xs, us, discrete)


def launch_linearize_pallas(spec, xs: Tensor, us: Tensor, discrete: bool):
    """The CUDA launch of K7 (inputs cast to contiguous float32)."""
    B, T, nu = us.shape
    nx = xs.shape[-1]
    if tuple(xs.shape) != (B, T + 1, nx):
        raise ValueError(f"xs: shape {tuple(xs.shape)}, expected {(B, T + 1, nx)}")
    if spec.context is not None:
        raise ValueError("K7 takes no per-stage context")
    xs = xs.to(torch.float32).contiguous()
    us = us.to(torch.float32).contiguous()
    check_tensor(us, "us", (B, T, nu), xs.device)
    symbol, (dyn_p, cost_p) = problem_symbol("linearize_flat", nx, nu, spec.dynamics,
                                             spec.stage_cost)
    empty = lambda *s: torch.empty((B, T) + s, dtype=torch.float32, device=xs.device)
    outs = [empty(nx, nx), empty(nx, nu), empty(nx), empty(nu), empty(nx, nx), empty(nu, nu),
            empty(nu, nx)]
    with torch.cuda.device(xs.device):
        launch(symbol, xs, us, *outs, T, B, int(discrete), dyn_p, cost_p,
               step_constants(spec.dt))
    FLAT_STATS.launches += 1
    return tuple(outs)
