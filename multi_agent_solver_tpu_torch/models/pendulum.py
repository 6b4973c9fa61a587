"""Damped pendulum model (0 = upright).

PyTorch counterpart of ``multi_agent_solver_tpu/models/pendulum.py``:
state ``(theta, omega)``, control ``(torque,)``,

    omega_dot = (g/l) sin(theta) + u/(m l^2) - (b/(m l^2)) omega

with g = 9.81, l = m = 1, damping b = 0.1.  The callables carry no device
tag: the swing-up's stage cost reads the stage index, which the device
functions do not take, so on the card the pendulum runs the non-fused
path with the torch linearizer and K4's explicit mode at (2, 1).
"""

from __future__ import annotations

import torch

from ..types import Tensor

G = 9.81
L = 1.0
M = 1.0
B = 0.1


def pendulum_dynamics(x: Tensor, u: Tensor) -> Tensor:
    theta, omega = x[..., 0], x[..., 1]
    omega_dot = (G / L) * torch.sin(theta) + u[..., 0] / (M * L * L) - (B / (M * L * L)) * omega
    return torch.stack([omega, omega_dot], dim=-1)


def pendulum_state_jacobian(x: Tensor, u: Tensor) -> Tensor:
    """Analytic A = df/dx, ``[..., 2, 2]``."""
    z = torch.zeros_like(x[..., 0])
    return torch.stack([
        torch.stack([z, z + 1.0], -1),
        torch.stack([(G / L) * torch.cos(x[..., 0]), z - B / (M * L * L)], -1),
    ], -2)


def pendulum_control_jacobian(x: Tensor, u: Tensor) -> Tensor:
    """Analytic B = df/du, ``[..., 2, 1]``."""
    z = torch.zeros_like(x[..., 0])
    return torch.stack([z, z + 1.0 / (M * L * L)], -1)[..., None]
