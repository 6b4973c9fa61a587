"""Vertical rocket model with fuel-mass state.

PyTorch counterpart of ``multi_agent_solver_tpu/models/rocket.py``: state
``(h, v, m)``, control ``(thrust,)``,

    h_dot = v
    v_dot = thrust / max(m, 1e-6) - g
    m_dot = -thrust / v_exhaust

``max`` is ``torch.maximum``, whose tangent at the tie is 0.5, as
``jnp.maximum``'s.  The dynamics carry the tag of ``Rocket`` in
``csrc/problems.cuh`` (parameters g and v_exhaust), which computes the same
expression in the same order, so the rocket runs on the kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from ..types import Tensor, tag_device_fn

MASS_FLOOR = 1e-6


@dataclasses.dataclass(frozen=True)
class RocketParameters:
    """The reference's defaults."""

    initial_mass: float = 1.0
    gravity: float = 9.81
    exhaust_velocity: float = 25.0


def _mass(x: Tensor) -> Tensor:
    m = x[..., 2]
    return torch.maximum(m, torch.full_like(m, MASS_FLOOR))


def make_rocket_dynamics(params: RocketParameters):
    def dynamics(x: Tensor, u: Tensor) -> Tensor:
        thrust = u[..., 0]
        return torch.stack(
            torch.broadcast_tensors(x[..., 1], thrust / _mass(x) - params.gravity,
                                    -thrust / params.exhaust_velocity), dim=-1)

    return tag_device_fn(dynamics, "rocket", (params.gravity, params.exhaust_velocity))


def make_rocket_state_jacobian(params: RocketParameters):
    """Analytic A, ``[..., 3, 3]``, incl. d(v_dot)/dm = -thrust / m^2."""

    def jac(x: Tensor, u: Tensor) -> Tensor:
        mass = _mass(x)
        dv_dm, = torch.broadcast_tensors(-u[..., 0] / (mass * mass))
        z = torch.zeros_like(dv_dm)
        return torch.stack([
            torch.stack([z, torch.ones_like(z), z], -1),
            torch.stack([z, z, dv_dm], -1),
            torch.stack([z, z, z], -1),
        ], -2)

    return jac


def make_rocket_control_jacobian(params: RocketParameters):
    """Analytic B, ``[..., 3, 1]``."""

    def jac(x: Tensor, u: Tensor) -> Tensor:
        inv_m, _ = torch.broadcast_tensors(1.0 / _mass(x), u[..., 0])
        z = torch.zeros_like(inv_m)
        return torch.stack([z, inv_m, torch.full_like(z, -1.0 / params.exhaust_velocity)],
                           -1)[..., None]

    return jac
