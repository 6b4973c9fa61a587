"""Cart-pole model (underactuated swing-up benchmark).

PyTorch counterpart of ``multi_agent_solver_tpu/models/cartpole.py``:
state ``(p, theta, p_dot, theta_dot)`` with ``theta = 0`` hanging down and
``theta = pi`` upright, control ``(force,)`` on the cart, frictionless:

    denom     = m_c + m_p sin^2(theta)
    p_ddot    = [ f + m_p sin(theta) (l theta_dot^2 + g cos(theta)) ] / denom
    theta_ddot= [ -f cos(theta) - m_p l theta_dot^2 cos(theta) sin(theta)
                  - (m_c + m_p) g sin(theta) ] / (l denom)

with m_c = 1, m_p = 0.3, l = 0.5, g = 9.81, and the swing-up's stage and
terminal costs.  The three callables carry the tags of ``Cartpole``,
``CartpoleSwingUp`` and ``CartpoleSwingUpTerminal`` in
``csrc/problems.cuh``, which compute the same expressions in the same
order, so the cart-pole runs on the kernels.
"""

from __future__ import annotations

import torch

from ..types import Tensor, tag_device_fn

M_CART = 1.0
M_POLE = 0.3
L_POLE = 0.5
G = 9.81
# The stage and terminal weights: (1 + cos theta)^2, p^2, p_dot^2,
# theta_dot^2 and, for the stage, force^2.
STAGE_WEIGHTS = (10.0, 0.1, 0.05, 0.05, 0.001)
TERMINAL_WEIGHTS = (200.0, 2.0, 5.0, 5.0)


def cartpole_dynamics(x: Tensor, u: Tensor) -> Tensor:
    theta, p_dot, theta_dot = x[..., 1], x[..., 2], x[..., 3]
    f = u[..., 0]
    s, c = torch.sin(theta), torch.cos(theta)
    denom = M_CART + M_POLE * s * s
    p_ddot = (f + M_POLE * s * (L_POLE * theta_dot * theta_dot + G * c)) / denom
    theta_ddot = (
        -f * c
        - M_POLE * L_POLE * theta_dot * theta_dot * c * s
        - (M_CART + M_POLE) * G * s
    ) / (L_POLE * denom)
    return torch.stack([p_dot, theta_dot, p_ddot, theta_ddot], dim=-1)


# The device function's parameters; the last two are the products that
# Python folds in double above.
tag_device_fn(cartpole_dynamics, "cartpole",
              (M_CART, M_POLE, L_POLE, G, M_POLE * L_POLE, (M_CART + M_POLE) * G))


def cartpole_swing_up_stage_cost(x: Tensor, u: Tensor, t) -> Tensor:
    """Upright shaping: ``1 + cos(theta)`` vanishes at theta = pi."""
    w_up, w_p, w_v, w_w, w_u = STAGE_WEIGHTS
    upright = 1.0 + torch.cos(x[..., 1])
    return (
        w_up * upright * upright
        + w_p * x[..., 0] * x[..., 0]
        + w_v * x[..., 2] * x[..., 2]
        + w_w * x[..., 3] * x[..., 3]
        + w_u * u[..., 0] * u[..., 0]
    )


tag_device_fn(cartpole_swing_up_stage_cost, "cartpole_swing_up", STAGE_WEIGHTS)


def cartpole_swing_up_terminal_cost(x: Tensor) -> Tensor:
    w_up, w_p, w_v, w_w = TERMINAL_WEIGHTS
    upright = 1.0 + torch.cos(x[..., 1])
    return (
        w_up * upright * upright
        + w_p * x[..., 0] * x[..., 0]
        + w_v * x[..., 2] * x[..., 2]
        + w_w * x[..., 3] * x[..., 3]
    )


tag_device_fn(cartpole_swing_up_terminal_cost, "cartpole_swing_up_terminal", TERMINAL_WEIGHTS)
