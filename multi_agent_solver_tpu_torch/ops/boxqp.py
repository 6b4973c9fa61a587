"""Small box-constrained QP solves by exhaustive active-set enumeration.

PyTorch counterpart of ``multi_agent_solver_tpu/ops/boxqp.py``, batched
over the leading axes: the control-limited stage solve of the scan
backward pass,

    min_du  1/2 du' Quu du + qu' du   s.t.  lb <= du <= ub,

solved exactly by enumerating the 3^nu free / at-lower / at-upper
configurations in ``itertools.product`` order (as K5,
``ops/riccati.boxqp_lane_gains_plain``, enumerates them), solving each free
subsystem in closed form and taking the first whose KKT conditions hold.
Clamped dimensions get zero feedback rows.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import torch

from ..types import Tensor
from .small import solve_spd_small

FREE, AT_LB, AT_UB = 0, 1, 2


def boxqp_gains(Quu: Tensor, qu: Tensor, Qux: Tensor, lb: Tensor,
                ub: Tensor) -> Tuple[Tensor, Tensor]:
    """Exact box-QP feedforward ``k [..., nu]`` and control-limited feedback
    ``K [..., nu, nx]`` for ``Quu [..., nu, nu]`` (SPD, regularized),
    ``qu [..., nu]``, ``Qux [..., nu, nx]`` and delta bounds
    ``lb``, ``ub [..., nu]``."""
    nu, nx = qu.shape[-1], Qux.shape[-1]
    if nu > 4:
        raise ValueError("boxqp enumeration supports nu <= 4")
    best_k = torch.zeros_like(qu)
    best_K = torch.zeros_like(Qux)
    found = torch.zeros(qu.shape[:-1], dtype=torch.bool, device=qu.device)

    for config in itertools.product((FREE, AT_LB, AT_UB), repeat=nu):
        free = [i for i in range(nu) if config[i] == FREE]
        clamped = [i for i in range(nu) if config[i] != FREE]
        v = torch.stack([lb[..., i] if config[i] == AT_LB
                         else (ub[..., i] if config[i] == AT_UB else 0.0 * qu[..., i])
                         for i in range(nu)], -1)
        K = torch.zeros_like(Qux)
        du = v
        if free:
            Q_ff = Quu[..., free, :][..., :, free]
            rhs = qu[..., free]
            if clamped:
                Q_fc = Quu[..., free, :][..., :, clamped]
                rhs = rhs + torch.einsum("...ij,...j->...i", Q_fc, v[..., clamped])
            du_f = -solve_spd_small(Q_ff, rhs)
            K_f = -solve_spd_small(Q_ff, Qux[..., free, :])
            du = v.clone()
            du[..., free] = du_f
            K[..., free, :] = K_f

        grad = qu + torch.einsum("...ij,...j->...i", Quu, du)
        ok = torch.ones_like(found)
        for i in range(nu):
            if config[i] == FREE:
                ok = ok & (du[..., i] >= lb[..., i]) & (du[..., i] <= ub[..., i])
            elif config[i] == AT_LB:
                ok = ok & (grad[..., i] >= 0.0)
            else:
                ok = ok & (grad[..., i] <= 0.0)

        take = ok & ~found
        best_k = torch.where(take[..., None], du, best_k)
        best_K = torch.where(take[..., None, None], K, best_K)
        found = found | ok

    # Degenerate fallback: the unconstrained Newton step clipped to the box.
    du_unc = -solve_spd_small(Quu, qu)
    K_unc = -solve_spd_small(Quu, Qux)
    best_k = torch.where(found[..., None], best_k, torch.minimum(torch.maximum(du_unc, lb), ub))
    best_K = torch.where(found[..., None, None], best_K, K_unc)
    return best_k, best_K
