"""Single-track lane-following example (the headline benchmark problem).

PyTorch counterpart of the problem half of
``multi_agent_solver_tpu/examples/single_track_ocp.py``: kinematic bicycle,
cost ``10 y^2 + (v - 1)^2 + 0.1 (delta^2 + a^2)`` with its analytic
gradients and Hessians, zero terminal cost, input box delta in
[-0.7, 0.7], a in [-1, 1], T = 80, dt = 0.1, the model's analytic
Jacobians, and the example's solver parameters.  The stage cost is the
diagonal quadratic ``LANE_FOLLOW_COST``, whose device tag lets the batched
solve run it on the kernels.
"""

from __future__ import annotations

import torch

from ..models import single_track_control_jacobian, single_track_model, single_track_state_jacobian
from ..ocp import OCP, diagonal_quadratic_cost

W_LANE, W_SPEED, W_DELTA, W_ACC = 10.0, 1.0, 0.1, 0.1
DESIRED_VELOCITY = 1.0
PARAMS = {"max_iterations": 10, "tolerance": 1e-5, "max_ms": 100}

# 10 y^2 + (v - 1)^2 + 0.1 delta^2 + 0.1 a^2 as a diagonal quadratic, so it
# has a CUDA device function (csrc/problems.cuh DiagQuadratic).
LANE_FOLLOW_COST = diagonal_quadratic_cost(
    w_x=(0.0, W_LANE, 0.0, W_SPEED), r_x=(0.0, 0.0, 0.0, DESIRED_VELOCITY),
    w_u=(W_DELTA, W_ACC), r_u=(0.0, 0.0),
)


def create_single_track_lane_following_ocp(dtype=torch.float32, device="cuda") -> OCP:
    """The example's problem, x0 = (0, 1, 0, 0), initialized on ``device``."""

    def cost_state_gradient(x, u, t):
        z = torch.zeros_like(x[..., 0])
        return torch.stack([z, 2.0 * W_LANE * x[..., 1], z,
                            2.0 * W_SPEED * (x[..., 3] - DESIRED_VELOCITY)], -1)

    def cost_control_gradient(x, u, t):
        return torch.stack([2.0 * W_DELTA * u[..., 0], 2.0 * W_ACC * u[..., 1]], -1)

    def cost_state_hessian(x, u, t):
        return torch.diag_embed(torch.zeros_like(x) + x.new_tensor(
            [0.0, 2.0 * W_LANE, 0.0, 2.0 * W_SPEED]))

    def cost_control_hessian(x, u, t):
        return torch.diag_embed(torch.zeros_like(u) + u.new_tensor([2.0 * W_DELTA, 2.0 * W_ACC]))

    ocp = OCP(
        state_dim=4, control_dim=2, horizon_steps=80, dt=0.1,
        initial_state=torch.tensor([0.0, 1.0, 0.0, 0.0], dtype=dtype),
        dynamics=single_track_model, stage_cost=LANE_FOLLOW_COST,
        cost_state_gradient=cost_state_gradient, cost_control_gradient=cost_control_gradient,
        cost_state_hessian=cost_state_hessian, cost_control_hessian=cost_control_hessian,
        dynamics_state_jacobian=single_track_state_jacobian,
        dynamics_control_jacobian=single_track_control_jacobian,
        input_lower_bounds=torch.tensor([-0.7, -1.0], dtype=dtype),
        input_upper_bounds=torch.tensor([0.7, 1.0], dtype=dtype),
        device=device,
    )
    ocp.initialize_problem()
    return ocp
