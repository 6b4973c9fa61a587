"""K2: forward line search with in-kernel step-size selection.

Port of ``multi_agent_solver_tpu/ops/forward_select_pallas.py ::
forward_select_pallas_tiled`` in its two modes on the iLQR main path; the
CUDA kernel is ``csrc/forward_select.cu`` (one kernel, a template flag per
mode, one launch counter):

* :func:`rollout_cost` -- the initial rollout and its cost: alpha 0, zero
  gains, no clamp, merit +inf.  ``x0 [nx, B]``, ``us [T, nu, B]`` ->
  ``xs [T, nx, B]`` holding x_1..x_T, ``cost [B]``.
* :func:`forward_select` -- stage-out mode: every candidate alpha scored,
  the largest one that beats ``merit`` on an active problem re-rolled.
  ``xs [T, nx, B]`` (x_0..x_{T-1}), ``us [T, nu, B]`` and ``xT [nx, B]``
  are updated IN PLACE -- the port's one in-place update, the counterpart
  of the TPU kernel's input/output aliasing: an accepted problem's column
  becomes the new trajectory, a rejected or frozen one keeps the reference
  verbatim.  Returns ``(merit_new [B], accept [B] bool)``.

Stage costs see the integer stage index, as in the TPU kernel.
"""

from __future__ import annotations

import math

import torch

from ..integrators import integrate_rk4
from ..types import Tensor
from ._build import KernelStats, check_tensor, launch, problem_symbol, step_constants

STATS = KernelStats()
MAX_ALPHAS = 16   # candidate registers of the CUDA kernel


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


def rollout_cost_plain(spec, x0: Tensor, us: Tensor):
    """Plain PyTorch version of the K2 rollout mode."""
    STATS.plain_calls += 1
    T, nu, B = us.shape
    x = x0.T
    xs = torch.empty((T, x0.shape[0], B), dtype=torch.float32, device=x0.device)
    total = torch.zeros(B, dtype=torch.float32, device=x0.device)
    for t in range(T):
        u = us[t].T
        total = total + spec.stage_cost(x, u, t)
        x = integrate_rk4(x, u, spec.dt, spec.dynamics)
        xs[t] = x.T
    total = total + spec.terminal_cost(x)
    return xs, torch.where(total < math.inf, total, torch.full_like(total, math.inf))


def forward_select_plain(spec, xs, us, xT, k, K, merit, active, lb, ub, alphas):
    """Plain PyTorch version of the K2 select mode (same in-place contract)."""
    STATS.plain_calls += 1
    T, nx, B = xs.shape
    lbT = lb.T if lb is not None else None
    ubT = ub.T if ub is not None else None
    x_start = xs[0].T.clone()
    xa = [x_start for _ in alphas]
    ca = [torch.zeros(B, dtype=torch.float32, device=xs.device) for _ in alphas]
    for t in range(T):
        x_ref, u_ref, k_t, K_t = xs[t].T, us[t].T, k[t].T, K[t].permute(2, 0, 1)
        for a, alpha in enumerate(alphas):
            u = _control(xa[a], x_ref, u_ref, k_t, K_t, alpha, lbT, ubT)
            ca[a] = ca[a] + spec.stage_cost(xa[a], u, t)
            xa[a] = integrate_rk4(xa[a], u, spec.dt, spec.dynamics)

    best = merit.clone()
    sel = torch.zeros(B, dtype=torch.float32, device=xs.device)
    found = torch.zeros(B, dtype=torch.bool, device=xs.device)
    for a in range(len(alphas) - 1, -1, -1):
        total = ca[a] + spec.terminal_cost(xa[a])
        ok = (total < merit) & active
        sel = torch.where(ok, torch.full_like(sel, alphas[a]), sel)
        best = torch.where(ok, total, best)
        found = found | ok

    keep = found[:, None]
    x = x_start
    for t in range(T):
        x_ref, u_ref, k_t, K_t = xs[t].T, us[t].T, k[t].T, K[t].permute(2, 0, 1)
        u = _control(x, x_ref, u_ref, k_t, K_t, sel, lbT, ubT)
        x_next = integrate_rk4(x, u, spec.dt, spec.dynamics)
        xs[t] = torch.where(keep, x, x_ref).T
        us[t] = torch.where(keep, u, u_ref).T
        x = x_next
    xT.copy_(torch.where(keep, x, xT.T).T)
    return best, found


def rollout_cost(spec, x0: Tensor, us: Tensor):
    """K2 rollout mode on the card for CUDA tensors, plain for CPU tensors."""
    if x0.device.type == "cpu":
        return rollout_cost_plain(spec, x0, us)
    T, nu, B = us.shape
    nx = x0.shape[0]
    check_tensor(x0, "x0", (nx, B), x0.device)
    check_tensor(us, "us", (T, nu, B), x0.device)
    symbol, params = _symbol(spec, nx, nu)
    xs = torch.empty((T, nx, B), dtype=torch.float32, device=x0.device)
    cost = torch.empty(B, dtype=torch.float32, device=x0.device)
    with torch.cuda.device(x0.device):
        launch(symbol, 1, x0, xs, us, None, None, None, None, None, None, None,
               cost, None, T, B, *params, step_constants(spec.dt), (0.0,), 1)
    STATS.launches += 1
    return xs, cost


def forward_select(spec, xs, us, xT, k, K, merit, active, lb, ub, alphas):
    """K2 select mode on the card for CUDA tensors, plain for CPU tensors.

    ``lb``/``ub`` are ``[nu, B]`` absolute bounds or both None (no clamp);
    ``active [B]`` is bool.  Updates ``xs``, ``us`` and ``xT`` in place.
    """
    alphas = tuple(float(a) for a in alphas)
    if not 1 <= len(alphas) <= MAX_ALPHAS:
        raise ValueError(f"{len(alphas)} alphas; the kernel takes 1..{MAX_ALPHAS}")
    if (lb is None) != (ub is None):
        raise ValueError("pass both bounds or neither")
    if xs.device.type == "cpu":
        return forward_select_plain(spec, xs, us, xT, k, K, merit, active, lb, ub, alphas)
    T, nx, B = xs.shape
    nu = us.shape[1]
    dev = xs.device
    for t, name, shape in ((xs, "xs", (T, nx, B)), (us, "us", (T, nu, B)),
                           (xT, "xT", (nx, B)), (k, "k", (T, nu, B)),
                           (K, "K", (T, nu, nx, B)), (merit, "merit", (B,))):
        check_tensor(t, name, shape, dev)
    if lb is not None:
        check_tensor(lb, "lb", (nu, B), dev)
        check_tensor(ub, "ub", (nu, B), dev)
    if active.dtype != torch.bool or tuple(active.shape) != (B,) or active.device != dev \
            or not active.is_contiguous():
        raise ValueError("active: expected a contiguous bool tensor of shape (B,) on the card")
    symbol, params = _symbol(spec, nx, nu)
    merit_new = torch.empty(B, dtype=torch.float32, device=dev)
    accept = torch.empty(B, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        launch(symbol, 0, None, xs, us, xT, k, K, merit, active, lb, ub, merit_new,
               accept, T, B, *params, step_constants(spec.dt), alphas, len(alphas))
    STATS.launches += 1
    return merit_new, accept


def _symbol(spec, nx, nu):
    return problem_symbol("forward_select", nx, nu, spec.dynamics, spec.stage_cost,
                          spec.terminal_cost)
