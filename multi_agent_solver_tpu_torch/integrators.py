"""Fixed-step ODE integrators and horizon rollouts.

PyTorch counterpart of ``multi_agent_solver_tpu/integrators.py``.  Batch
axes lead: ``state [..., nx]``, ``control [..., nu]``; a horizon of
controls is ``[..., T, nu]``.  A Python loop over T replaces ``lax.scan``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .types import MotionModel, Tensor

Integrator = Callable[[Tensor, Tensor, float, MotionModel], Tensor]


def integrate_euler(state: Tensor, control: Tensor, dt: float, dynamics: MotionModel) -> Tensor:
    """Single explicit-Euler step."""
    return state + dt * dynamics(state, control)


def integrate_rk4(state: Tensor, control: Tensor, dt: float, dynamics: MotionModel) -> Tensor:
    """Single classic RK4 step; the control is held over the step."""
    k1 = dynamics(state, control)
    k2 = dynamics(state + 0.5 * dt * k1, control)
    k3 = dynamics(state + 0.5 * dt * k2, control)
    k4 = dynamics(state + dt * k3, control)
    return state + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


INTEGRATORS = {
    "euler": integrate_euler,
    "rk4": integrate_rk4,
}


def integrate_horizon(
    initial_state: Tensor,
    controls: Tensor,
    dt: float,
    dynamics: MotionModel,
    step: Integrator = integrate_rk4,
) -> Tensor:
    """Roll out the horizon: ``[..., nx]``, ``[..., T, nu]`` -> ``[..., T+1, nx]``."""
    states = [initial_state]
    for t in range(controls.shape[-2]):
        states.append(step(states[-1], controls[..., t, :], dt, dynamics))
    return torch.stack(states, dim=-2)
