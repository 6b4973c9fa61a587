"""Cart-pole swing-up example.

PyTorch counterpart of the problem half of
``multi_agent_solver_tpu/examples/cartpole_swing_up.py``: start hanging
down (theta = 0.05), drive the pole upright while keeping the cart near the
origin; force box +-12, a symmetry-breaking sinusoid seed, T = 60,
dt = 0.05, and the example's iLQR parameters.  The model's dynamics and
costs carry device tags, so the batched solve runs on the kernels (the
general cost branch: the cost is not quadratic).  The JAX example seeds
iLQR with an MPPI phase first; MPPI is not ported.
"""

from __future__ import annotations

import math

import torch

from ..models import cartpole_dynamics, cartpole_swing_up_stage_cost, cartpole_swing_up_terminal_cost
from ..ocp import OCP

FORCE_MAX = 12.0
HORIZON = 60
DT = 0.05
PARAMS = {"max_iterations": 300, "tolerance": 1e-7, "max_ms": 5000}


def create_cartpole_swingup_ocp(dtype=torch.float32, device="cuda") -> OCP:
    """The example's problem, initialized on ``device``."""
    ts = torch.arange(HORIZON, dtype=dtype)
    initial_controls = (2.0 * torch.sin(2.0 * math.pi * ts / HORIZON))[:, None]
    ocp = OCP(
        state_dim=4,
        control_dim=1,
        horizon_steps=HORIZON,
        dt=DT,
        initial_state=torch.tensor([0.0, 0.05, 0.0, 0.0], dtype=dtype),
        dynamics=cartpole_dynamics,
        stage_cost=cartpole_swing_up_stage_cost,
        terminal_cost=cartpole_swing_up_terminal_cost,
        input_lower_bounds=torch.tensor([-FORCE_MAX], dtype=dtype),
        input_upper_bounds=torch.tensor([FORCE_MAX], dtype=dtype),
        initial_controls=initial_controls,
        device=device,
    )
    ocp.initialize_problem()
    return ocp
