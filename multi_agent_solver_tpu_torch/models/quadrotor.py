"""Quadrotor model (nx = 12, nu = 4).

PyTorch counterpart of ``multi_agent_solver_tpu/models/quadrotor.py``.
State ``(x, y, z, vx, vy, vz, phi, theta, psi, p, q, r)`` -- world
position, world velocity, ZYX Euler angles, body rates.  Control
``(f, tau_x, tau_y, tau_z)`` -- total thrust along body z and body torques.

    p_dot     = v
    v_dot     = [0, 0, -g] + R_wb(phi, theta, psi) @ [0, 0, f/m]
    eul_dot   = W(phi, theta) @ [p, q, r]          (ZYX Euler-rate map)
    omega_dot = J^{-1} (tau - omega x (J omega))   (diagonal inertia)

``W`` contains ``1/cos(theta)``, guarded by the signed floor ``C_EPS``
(``torch.where`` on ``cos(theta) >= 0`` of ``torch.maximum`` /
``torch.minimum``, whose tangents at the ties are 0.5, as JAX's).  The
callable carries the tag of ``Quadrotor`` in ``csrc/problems.cuh``
(parameters: ``body_params()``), which computes the same expression in the
same order.
"""

from __future__ import annotations

import torch

from ..types import Tensor, tag_device_fn

MASS = 1.0          # kg
GRAVITY = 9.81      # m/s^2
JX = 0.01           # kg m^2 body-x inertia
JY = 0.01           # kg m^2 body-y inertia
JZ = 0.02           # kg m^2 body-z inertia
C_EPS = 0.1         # cos(theta) floor guarding the Euler-rate singularity

HOVER_THRUST = MASS * GRAVITY


def body_params() -> tuple:
    """``QuadBody``'s parameters: the constants and the inertia differences
    that Python folds in double."""
    return (MASS, GRAVITY, JX, JY, JZ, C_EPS, JZ - JY, JX - JZ, JY - JX)


def rigid_body(x: Tensor, f: Tensor, tx: Tensor, ty: Tensor, tz: Tensor) -> list:
    """The twelve rigid-body rows of ``f(x, u)`` for thrust ``f`` and body
    torques ``tau``; shared with the rotor-lag model."""
    vx, vy, vz = x[..., 3], x[..., 4], x[..., 5]
    phi, theta, psi = x[..., 6], x[..., 7], x[..., 8]
    p, q, r = x[..., 9], x[..., 10], x[..., 11]

    sphi, cphi = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(theta), torch.cos(theta)
    spsi, cpsi = torch.sin(psi), torch.cos(psi)

    a = f / MASS
    ax = (cpsi * sth * cphi + spsi * sphi) * a
    ay = (spsi * sth * cphi - cpsi * sphi) * a
    az = (cth * cphi) * a - GRAVITY

    cth_safe = torch.where(cth >= 0.0, torch.maximum(cth, torch.full_like(cth, C_EPS)),
                           torch.minimum(cth, torch.full_like(cth, -C_EPS)))
    tth = sth / cth_safe
    phi_dot = p + (q * sphi + r * cphi) * tth
    theta_dot = q * cphi - r * sphi
    psi_dot = (q * sphi + r * cphi) / cth_safe

    p_dot = (tx - (JZ - JY) * q * r) / JX
    q_dot = (ty - (JX - JZ) * p * r) / JY
    r_dot = (tz - (JY - JX) * p * q) / JZ
    return [vx, vy, vz, ax, ay, az, phi_dot, theta_dot, psi_dot, p_dot, q_dot, r_dot]


def quadrotor_dynamics(x: Tensor, u: Tensor) -> Tensor:
    rows = rigid_body(x, u[..., 0], u[..., 1], u[..., 2], u[..., 3])
    return torch.stack(torch.broadcast_tensors(*rows), dim=-1)


tag_device_fn(quadrotor_dynamics, "quadrotor", body_params())
