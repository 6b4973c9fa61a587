"""Dynamic bicycle model with linear tires.

PyTorch counterpart of ``multi_agent_solver_tpu/models/dynamic_bicycle.py``:
state ``(X, Y, psi, vx, vy, r)``, control ``(delta, ax)``,

    X_dot   = vx cos(psi) - vy sin(psi)
    Y_dot   = vx sin(psi) + vy cos(psi)
    psi_dot = r
    vx_dot  = ax + vy r
    vy_dot  = (Fyf cos(delta) + Fyr)/m - vx r
    r_dot   = (lf Fyf cos(delta) - lr Fyr)/Iz

with ``Fyf = Caf alpha_f``, ``Fyr = Car alpha_r``, ``alpha_f = delta - (vy
+ lf r)/max(vx, V_EPS)`` and ``alpha_r = -(vy - lr r)/max(vx, V_EPS)``
(``torch.maximum``: tangent 0.5 at the tie, as ``jnp.maximum``'s).  The
callable carries the tag of ``DynamicBicycle`` in ``csrc/problems.cuh``,
which computes the same expression in the same order.
"""

from __future__ import annotations

import torch

from ..types import Tensor, tag_device_fn

MASS = 1500.0       # kg
IZ = 2250.0         # kg m^2
LF = 1.2            # m, CoG -> front axle
LR = 1.3            # m, CoG -> rear axle
CAF = 8.0e4         # N/rad front cornering stiffness
CAR = 9.0e4         # N/rad rear cornering stiffness
V_EPS = 0.5         # m/s slip-angle speed floor


def dynamic_bicycle_model(x: Tensor, u: Tensor) -> Tensor:
    psi, vx, vy, r = x[..., 2], x[..., 3], x[..., 4], x[..., 5]
    delta, ax = u[..., 0], u[..., 1]
    vx_safe = torch.maximum(vx, torch.full_like(vx, V_EPS))
    alpha_f = delta - (vy + LF * r) / vx_safe
    alpha_r = -(vy - LR * r) / vx_safe
    fyf = CAF * alpha_f
    fyr = CAR * alpha_r
    cos_d = torch.cos(delta)
    return torch.stack(torch.broadcast_tensors(
        vx * torch.cos(psi) - vy * torch.sin(psi),
        vx * torch.sin(psi) + vy * torch.cos(psi),
        r,
        ax + vy * r,
        (fyf * cos_d + fyr) / MASS - vx * r,
        (LF * fyf * cos_d - LR * fyr) / IZ,
    ), dim=-1)


tag_device_fn(dynamic_bicycle_model, "dynamic_bicycle", (MASS, IZ, LF, LR, CAF, CAR, V_EPS))
