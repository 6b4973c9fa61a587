"""Pendulum swing-up with an energy-shaping cost.

PyTorch counterpart of the problem half of
``multi_agent_solver_tpu/examples/pendulum_swing_up.py``: time-varying
stage weights blending an energy error early against upright shaping late
(quadratic schedule s^2), torque box +-5, a sinusoidal initial guess to
break symmetry, x0 = (pi - 0.05, 0), T = 60, dt = 0.05, and the example's
solver parameters.  The stage cost reads the stage index; it carries the
tag of ``PendulumSwingUp`` in ``csrc/problems.cuh`` (the horizon's span
T - 1 is one of its parameters), the terminal cost that of
``PendulumSwingUpTerminal``, so on the card the swing-up runs the fused
loop's general branch on the kernels: K2's rollout and select, K3 with
Hessians and K4 with the terminal cost in the kernel, as the JAX router
sends it.
"""

from __future__ import annotations

import math

import torch

from ..models import pendulum_dynamics
from ..models.pendulum import G, L, M
from ..ocp import OCP
from ..types import tag_device_fn

TORQUE_MAX = 5.0
HORIZON = 60
DT = 0.05
PARAMS = {"max_iterations": 1000, "tolerance": 1e-4, "max_ms": 5000}

W_ENERGY = 2.0
W_U = 0.05
W_SHAPE = 2.0
W_OMEGA = 0.05
WT_POS = 500.0
WT_VEL = 100.0
MGL = M * G * L


def _stage_cost(x, u, k):
    theta, omega, torque = x[..., 0], x[..., 1], u[..., 0]
    # Time-varying weights: energy matters early, shaping late.
    k = k if torch.is_tensor(k) else torch.tensor(k)
    s = k.to(x.dtype) / (float(HORIZON) - 1.0)
    late = s * s
    early = 1.0 - late
    w_energy_k = W_ENERGY * (0.2 + 0.8 * early)
    w_shape_k = W_SHAPE * (0.2 + 0.8 * late)
    w_omega_k = W_OMEGA * (0.2 + 0.8 * late)

    T_kin = 0.5 * M * L * L * omega ** 2
    V_pot = MGL * torch.cos(theta)
    energy_error = (T_kin + V_pot - MGL) / MGL
    upright_error = 1.0 - torch.cos(theta)

    return (
        w_energy_k * energy_error ** 2
        + w_shape_k * upright_error
        + w_omega_k * omega ** 2
        + W_U * torque ** 2
    )


tag_device_fn(_stage_cost, "pendulum_swing_up",
              (float(HORIZON) - 1.0, W_ENERGY, W_SHAPE, W_OMEGA, W_U, MGL, 0.5 * M * L * L))


def _terminal_cost(x):
    return WT_POS * (1.0 - torch.cos(x[..., 0])) + WT_VEL * x[..., 1] ** 2


tag_device_fn(_terminal_cost, "pendulum_swing_up_terminal", (WT_POS, WT_VEL))


def create_pendulum_swingup_ocp(dtype=torch.float32, device="cuda") -> OCP:
    """The example's problem, initialized on ``device``."""
    # Sinusoidal initial guess.
    ts = torch.arange(HORIZON, dtype=dtype) * DT
    initial_controls = (0.2 * TORQUE_MAX * torch.sin(2.0 * math.pi * ts))[:, None]
    ocp = OCP(
        state_dim=2,
        control_dim=1,
        horizon_steps=HORIZON,
        dt=DT,
        initial_state=torch.tensor([math.pi - 0.05, 0.0], dtype=dtype),
        dynamics=pendulum_dynamics,
        stage_cost=_stage_cost,
        terminal_cost=_terminal_cost,
        input_lower_bounds=torch.tensor([-TORQUE_MAX], dtype=dtype),
        input_upper_bounds=torch.tensor([TORQUE_MAX], dtype=dtype),
        initial_controls=initial_controls,
        device=device,
    )
    ocp.initialize_problem()
    return ocp
