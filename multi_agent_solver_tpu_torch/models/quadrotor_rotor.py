"""Quadrotor with first-order rotor dynamics (nx = 16, nu = 4).

PyTorch counterpart of ``multi_agent_solver_tpu/models/quadrotor_rotor.py``:
the 12-state quadrotor (``models/quadrotor.py``) with each rotor's thrust a
first-order lag behind its command.  State ``(x, y, z, vx, vy, vz, phi,
theta, psi, p, q, r, w0, w1, w2, w3)``, control ``(c0, c1, c2, c3)``, the
commanded rotor thrusts; plus-configuration mixing:

    f     = w0 + w1 + w2 + w3
    tau_x = ARM * (w1 - w3)
    tau_y = ARM * (w2 - w0)
    tau_z = K_YAW * (w0 - w1 + w2 - w3)
    w_dot = (c - w) / TAU_ROTOR

The callable carries the tag of ``QuadrotorRotor`` in
``csrc/problems.cuh`` (parameters: the quadrotor's, then ARM, K_YAW and
1 / TAU_ROTOR as Python folds it), which computes the same expression in
the same order.
"""

from __future__ import annotations

import torch

from ..types import Tensor, tag_device_fn
from .quadrotor import GRAVITY, MASS, body_params, rigid_body

ARM = 0.2           # m rotor arm length
K_YAW = 0.05        # yaw moment per unit thrust differential
TAU_ROTOR = 0.05    # s rotor first-order time constant

HOVER_ROTOR_THRUST = MASS * GRAVITY / 4.0


def quadrotor_rotor_dynamics(x: Tensor, u: Tensor) -> Tensor:
    w0, w1, w2, w3 = x[..., 12], x[..., 13], x[..., 14], x[..., 15]
    f = w0 + w1 + w2 + w3
    tx = ARM * (w1 - w3)
    ty = ARM * (w2 - w0)
    tz = K_YAW * (w0 - w1 + w2 - w3)
    rows = rigid_body(x, f, tx, ty, tz)
    inv_tau = 1.0 / TAU_ROTOR
    rows += [(u[..., i] - x[..., 12 + i]) * inv_tau for i in range(4)]
    return torch.stack(torch.broadcast_tensors(*rows), dim=-1)


tag_device_fn(quadrotor_rotor_dynamics, "quadrotor_rotor",
              body_params() + (ARM, K_YAW, 1.0 / TAU_ROTOR))
