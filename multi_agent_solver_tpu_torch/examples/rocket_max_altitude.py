"""Rocket maximum altitude with fuel-mass state bounds.

PyTorch counterpart of the problem half of
``multi_agent_solver_tpu/examples/rocket_max_altitude.py``: stage cost
``0.5 * 5e-3 * thrust^2``, terminal ``-15 h + 0.5 * 2 * v^2``, thrust box
[0, 20], mass state bounds [0, m0] (which iLQR ignores, as in the JAX
package and the reference: only its QP solvers enforce them), the constant
half-thrust initial guess, T = 50, dt = 0.1, exhaust velocity 50, the
example's analytic oracles and solver parameters.

The stage cost is ``ocp.diagonal_quadratic_cost`` with the thrust weight
alone (``DiagQuadratic<3, 1>``: the zero state terms add exact zeros), the
terminal cost carries the tag of ``RocketTerminal``; both are quadratic
and stationary, so on the card the batch runs the fused loop's main-path
branch (K2, K3's hoist, K1).
"""

from __future__ import annotations

import torch

from ..models import (RocketParameters, make_rocket_control_jacobian, make_rocket_dynamics,
                      make_rocket_state_jacobian)
from ..ocp import OCP, diagonal_quadratic_cost
from ..types import tag_device_fn

MAX_THRUST = 20.0
W_THRUST = 5e-3
W_TERMINAL_ALTITUDE = 15.0
W_TERMINAL_VELOCITY = 2.0
HORIZON = 50
DT = 0.1
PARAMETERS = RocketParameters(initial_mass=1.0, gravity=9.81, exhaust_velocity=50.0)
PARAMS = {"max_iterations": 25, "tolerance": 1e-6, "max_ms": 200}

STAGE_COST = diagonal_quadratic_cost(w_x=(0.0, 0.0, 0.0), r_x=(0.0, 0.0, 0.0),
                                     w_u=(0.5 * W_THRUST,), r_u=(0.0,))
ROCKET_DYNAMICS = make_rocket_dynamics(PARAMETERS)


def terminal_cost(x):
    return -W_TERMINAL_ALTITUDE * x[..., 0] + 0.5 * W_TERMINAL_VELOCITY * x[..., 1] ** 2


tag_device_fn(terminal_cost, "rocket_terminal",
              (-W_TERMINAL_ALTITUDE, 0.5 * W_TERMINAL_VELOCITY))


# The example's analytic cost derivatives.
def cost_control_gradient(x, u, t):
    return W_THRUST * u


def cost_control_hessian(x, u, t):
    return torch.full(u.shape[:-1] + (1, 1), W_THRUST, dtype=u.dtype, device=u.device)


def cost_state_gradient(x, u, t):
    return torch.zeros_like(x)


def cost_state_hessian(x, u, t):
    return torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)


def terminal_cost_gradient(x):
    z = torch.zeros_like(x[..., 0])
    return torch.stack([z - W_TERMINAL_ALTITUDE, W_TERMINAL_VELOCITY * x[..., 1], z], -1)


def terminal_cost_hessian(x):
    H = torch.zeros(x.shape + (3,), dtype=x.dtype, device=x.device)
    H[..., 1, 1] = W_TERMINAL_VELOCITY
    return H


def create_max_altitude_rocket_ocp(dtype=torch.float32, device="cuda") -> OCP:
    """The example's problem, initialized on ``device``."""
    big = torch.finfo(dtype).max
    m0 = PARAMETERS.initial_mass
    ocp = OCP(
        state_dim=3,
        control_dim=1,
        horizon_steps=HORIZON,
        dt=DT,
        initial_state=torch.tensor([0.0, 0.0, m0], dtype=dtype),
        dynamics=ROCKET_DYNAMICS,
        stage_cost=STAGE_COST,
        terminal_cost=terminal_cost,
        cost_control_gradient=cost_control_gradient,
        cost_control_hessian=cost_control_hessian,
        cost_state_gradient=cost_state_gradient,
        cost_state_hessian=cost_state_hessian,
        terminal_cost_gradient=terminal_cost_gradient,
        terminal_cost_hessian=terminal_cost_hessian,
        dynamics_state_jacobian=make_rocket_state_jacobian(PARAMETERS),
        dynamics_control_jacobian=make_rocket_control_jacobian(PARAMETERS),
        input_lower_bounds=torch.tensor([0.0], dtype=dtype),
        input_upper_bounds=torch.tensor([MAX_THRUST], dtype=dtype),
        # The reference's lower state bounds are std::numeric_limits<double>
        # ::min(), effectively 0 (its QP solvers enforce h, v >= 0 too).
        state_lower_bounds=torch.tensor([0.0, 0.0, 0.0], dtype=dtype),
        state_upper_bounds=torch.tensor([big, big, m0], dtype=dtype),
        initial_controls=torch.full((HORIZON, 1), MAX_THRUST / 2.0, dtype=dtype),
        device=device,
    )
    ocp.initialize_problem()
    ocp.verify_problem()
    return ocp
