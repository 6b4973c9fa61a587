"""K3: whole-horizon linearization (A, B, lx, lu and optionally the cost Hessians).

Port of ``multi_agent_solver_tpu/ops/linearize_pallas.py ::
linearize_pallas_tiled``; the CUDA kernel is ``csrc/linearize.cu``.

Layout (the fused loop's, batch innermost): ``xs [T, nx, B]``,
``us [T, nu, B]`` in; ``A [T, nx, nx, B]``, ``B [T, nx, nu, B]``,
``lx [T, nx, B]``, ``lu [T, nu, B]`` and, with ``hessians``,
``lxx [T, nx, nx, B]``, ``luu [T, nu, nu, B]``, ``lux [T, nu, nx, B]`` out.

:func:`linearize` launches the kernel for CUDA tensors and raises on
anything it does not take; for CPU tensors it runs :func:`linearize_plain`.
"""

from __future__ import annotations

import torch
from torch.func import jvp

from ..integrators import integrate_rk4
from ..types import Tensor
from ._build import KernelStats, check_tensor, launch, problem_symbol, step_constants

STATS = KernelStats()


def _basis(n: int, j: int, like: Tensor) -> Tensor:
    e = torch.zeros(like.shape[:-1] + (n,), dtype=like.dtype, device=like.device)
    e[..., j] = 1.0
    return e


def stage_derivatives(spec, x: Tensor, u: Tensor, t):
    """``(A [..., nx, nx], B [..., nx, nu], lx [..., nx], lu [..., nu])`` of
    the RK4 step map and the stage cost at ``x [..., nx]``, ``u [..., nu]``:
    one ``torch.func.jvp`` per column, as the TPU kernel takes one jvp per
    basis direction."""
    nx, nu = x.shape[-1], u.shape[-1]
    step = lambda xx, uu: integrate_rk4(xx, uu, spec.dt, spec.dynamics)
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


def cost_hessians(spec, x: Tensor, u: Tensor, t):
    """``(lxx, luu, lux)`` by jvp over jvp: entry (i, j) is the jvp along
    e_j of the gradient along e_i; upper triangles mirrored."""
    nx, nu = x.shape[-1], u.shape[-1]
    zeros = torch.zeros_like(x[..., 0])
    grad_x = lambda a, b, i: jvp(lambda z: spec.stage_cost(z, b, t), (a,), (_basis(nx, i, a),))[1]
    grad_u = lambda a, b, i: jvp(lambda z: spec.stage_cost(a, z, t), (b,), (_basis(nu, i, b),))[1]
    lxx = [[None] * nx for _ in range(nx)]
    for i in range(nx):
        for j in range(i, nx):
            h = jvp(lambda a: grad_x(a, u, i), (x,), (_basis(nx, j, x),))[1] + zeros
            lxx[i][j] = lxx[j][i] = h
    luu = [[None] * nu for _ in range(nu)]
    for i in range(nu):
        for j in range(i, nu):
            h = jvp(lambda b: grad_u(x, b, i), (u,), (_basis(nu, j, u),))[1] + zeros
            luu[i][j] = luu[j][i] = h
    lux = [[jvp(lambda a: grad_u(a, u, i), (x,), (_basis(nx, j, x),))[1] + zeros
            for j in range(nx)] for i in range(nu)]
    stack2 = lambda rows: torch.stack([torch.stack(r, -1) for r in rows], -2)
    return stack2(lxx), stack2(luu), stack2(lux)


def linearize_plain(spec, xs: Tensor, us: Tensor, hessians: bool = True):
    """Plain PyTorch version of the K3 kernel (same layout and outputs)."""
    STATS.plain_calls += 1
    T = xs.shape[0]
    x = xs.permute(0, 2, 1)                      # [T, B, nx]
    u = us.permute(0, 2, 1)
    # The TPU kernel passes the stage index as a float lane value.
    t = torch.arange(T, dtype=xs.dtype, device=xs.device)[:, None].expand(x.shape[:2])
    A, Bm, lx, lu = stage_derivatives(spec, x, u, t)
    outs = [A.permute(0, 2, 3, 1), Bm.permute(0, 2, 3, 1), lx.permute(0, 2, 1), lu.permute(0, 2, 1)]
    if hessians:
        lxx, luu, lux = cost_hessians(spec, x, u, t)
        outs += [lxx.permute(0, 2, 3, 1), luu.permute(0, 2, 3, 1), lux.permute(0, 2, 3, 1)]
    return tuple(o.to(torch.float32).contiguous() for o in outs)


def linearize(spec, xs: Tensor, us: Tensor, hessians: bool = True):
    """K3 on the card for CUDA tensors, the plain version for CPU tensors."""
    if xs.device.type == "cpu":
        return linearize_plain(spec, xs, us, hessians)
    T, nx, B = xs.shape
    nu = us.shape[1]
    check_tensor(xs, "xs", (T, nx, B), xs.device)
    check_tensor(us, "us", (T, nu, B), xs.device)
    symbol, (dyn_p, cost_p) = problem_symbol("linearize", nx, nu, spec.dynamics, spec.stage_cost)
    empty = lambda *s: torch.empty(s, dtype=torch.float32, device=xs.device)
    outs = [empty(T, nx, nx, B), empty(T, nx, nu, B), empty(T, nx, B), empty(T, nu, B)]
    hess = [empty(T, nx, nx, B), empty(T, nu, nu, B), empty(T, nu, nx, B)] if hessians else [None] * 3
    with torch.cuda.device(xs.device):
        launch(symbol, xs, us, *outs, *hess, T, B, int(hessians), dyn_p, cost_p,
               step_constants(spec.dt))
    STATS.launches += 1
    return tuple(outs + (hess if hessians else []))
