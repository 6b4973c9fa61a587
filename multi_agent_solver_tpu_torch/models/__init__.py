"""Dynamics models (torch functions + analytic Jacobians)."""

from .cartpole import (
    cartpole_dynamics,
    cartpole_swing_up_stage_cost,
    cartpole_swing_up_terminal_cost,
)
from .dynamic_bicycle import dynamic_bicycle_model
from .lqr import make_linear_dynamics, quadratic_stage_cost, quadratic_terminal_cost
from .pendulum import pendulum_control_jacobian, pendulum_dynamics, pendulum_state_jacobian
from .quadrotor import HOVER_THRUST, quadrotor_dynamics
from .quadrotor_rotor import HOVER_ROTOR_THRUST, quadrotor_rotor_dynamics
from .rocket import (
    RocketParameters,
    make_rocket_control_jacobian,
    make_rocket_dynamics,
    make_rocket_state_jacobian,
)
from .single_track import (
    single_track_control_jacobian,
    single_track_model,
    single_track_state_jacobian,
)

__all__ = [
    "single_track_model",
    "single_track_state_jacobian",
    "single_track_control_jacobian",
    "pendulum_dynamics",
    "pendulum_state_jacobian",
    "pendulum_control_jacobian",
    "RocketParameters",
    "make_rocket_dynamics",
    "make_rocket_state_jacobian",
    "make_rocket_control_jacobian",
    "cartpole_dynamics",
    "cartpole_swing_up_stage_cost",
    "cartpole_swing_up_terminal_cost",
    "dynamic_bicycle_model",
    "quadrotor_dynamics",
    "HOVER_THRUST",
    "quadrotor_rotor_dynamics",
    "HOVER_ROTOR_THRUST",
    "make_linear_dynamics",
    "quadratic_stage_cost",
    "quadratic_terminal_cost",
]
