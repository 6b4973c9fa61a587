"""Multi-agent single-track example: cars tracking a circular path.

PyTorch counterpart of the problem half of
``multi_agent_solver_tpu/examples/multi_agent_single_track.py``: a car
starts at angle theta on a circle of radius 20, tangentially at v = 4;
cost ``(sqrt(x^2 + y^2) - 20)^2 + (v - 5)^2 + 1e-3 (delta^2 + a^2)``; zero
terminal cost; inputs bounded to +-0.5; T = 10, dt = 0.5.  The stage cost
carries the tag of ``CircularTrack`` in ``csrc/problems.cuh``, which sums
the same terms in the same order.  :func:`build_problem` spreads N such
cars on the circle, optionally coupled by the soft collision cost of
:func:`make_collision_cost` (``GaussianCollision`` on the card).
"""

from __future__ import annotations

import math

import torch

from ..agent import Agent
from ..models import single_track_model
from ..multi_agent import MultiAgentProblem
from ..ocp import OCP, zero_terminal_cost
from ..types import Tensor, tag_device_fn

TIME_STEPS = 10
DT = 0.5
TRACK_RADIUS = 20.0
TARGET_VELOCITY = 5.0
W_TRACK, W_SPEED, W_DELTA, W_ACC = 1.0, 1.0, 0.001, 0.001


def _stage_cost(x: Tensor, u: Tensor, t) -> Tensor:
    distance_from_track = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2) - TRACK_RADIUS
    speed_error = x[..., 3] - TARGET_VELOCITY
    return (
        W_TRACK * distance_from_track**2
        + W_SPEED * speed_error**2
        + W_DELTA * u[..., 0] ** 2
        + W_ACC * u[..., 1] ** 2
    )


tag_device_fn(_stage_cost, "circular_track",
              (TRACK_RADIUS, TARGET_VELOCITY, W_TRACK, W_SPEED, W_DELTA, W_ACC))


_terminal_cost = zero_terminal_cost


def create_single_track_circular_ocp(initial_theta: float, dtype=torch.float32,
                                     device="cuda") -> OCP:
    """One agent's problem, initialized (warm start rolled out and costed)
    on ``device``."""
    x0 = TRACK_RADIUS * math.cos(initial_theta)
    y0 = TRACK_RADIUS * math.sin(initial_theta)
    ocp = OCP(
        state_dim=4,
        control_dim=2,
        horizon_steps=TIME_STEPS,
        dt=DT,
        # Tangential start with some speed.
        initial_state=torch.tensor([x0, y0, 1.57 + initial_theta, 4.0], dtype=dtype),
        dynamics=single_track_model,
        stage_cost=_stage_cost,
        terminal_cost=_terminal_cost,
        input_lower_bounds=torch.full((2,), -0.5, dtype=dtype),
        input_upper_bounds=torch.full((2,), 0.5, dtype=dtype),
        device=device,
    )
    ocp.initialize_problem()
    return ocp


def make_collision_cost(weight: float, radius: float = 3.0):
    """Soft inter-agent collision cost ``weight exp(-d^2 / radius^2)``, ``d``
    the planar distance of the two cars.  Tagged ``gaussian_collision``
    with ``(weight, radius^2)``, ``radius^2`` computed as Python computes
    it; the device function divides by it, as the JAX expression does."""
    r2 = radius ** 2

    def collision_cost(x_i: Tensor, x_j: Tensor, t) -> Tensor:
        d2 = (x_i[..., 0] - x_j[..., 0]) ** 2 + (x_i[..., 1] - x_j[..., 1]) ** 2
        return weight * torch.exp(-d2 / r2)

    return tag_device_fn(collision_cost, "gaussian_collision", (weight, r2))


def build_problem(n_agents: int, coupling: float = 0.0, dtype=torch.float32,
                  device="cuda") -> MultiAgentProblem:
    """``n_agents`` cars at angles ``2 pi i / n_agents``, coupled by
    :func:`make_collision_cost` with weight ``coupling`` when it is > 0."""
    problem = MultiAgentProblem()
    for i in range(n_agents):
        theta = 2.0 * math.pi * i / n_agents
        problem.add_agent(Agent(i, create_single_track_circular_ocp(theta, dtype, device)))
    if coupling > 0.0:
        problem.inter_agent_cost = make_collision_cost(coupling)
    return problem
