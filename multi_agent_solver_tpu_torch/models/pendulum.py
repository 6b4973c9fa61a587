"""Damped pendulum model (0 = upright).

PyTorch counterpart of ``multi_agent_solver_tpu/models/pendulum.py``:
state ``(theta, omega)``, control ``(torque,)``,

    omega_dot = (g/l) sin(theta) + u/(m l^2) - (b/(m l^2)) omega

with g = 9.81, l = m = 1, damping b = 0.1.  ``pendulum_dynamics`` carries
the tag of ``Pendulum`` in ``csrc/problems.cuh``, which computes the same
expression in the same order (its parameters are the constants Python
folds: g/l, m l^2 and b/(m l^2)), so the pendulum runs on the kernels.
"""

from __future__ import annotations

import torch

from ..types import Tensor, tag_device_fn

G = 9.81
L = 1.0
M = 1.0
B = 0.1


def pendulum_dynamics(x: Tensor, u: Tensor) -> Tensor:
    theta, omega = x[..., 0], x[..., 1]
    omega_dot = (G / L) * torch.sin(theta) + u[..., 0] / (M * L * L) - (B / (M * L * L)) * omega
    return torch.stack([omega, omega_dot], dim=-1)


tag_device_fn(pendulum_dynamics, "pendulum", (G / L, M * L * L, B / (M * L * L)))


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
