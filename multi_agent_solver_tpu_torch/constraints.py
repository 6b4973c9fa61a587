"""Augmented-Lagrangian constraint helpers.

PyTorch counterpart of ``multi_agent_solver_tpu/constraints.py`` (the
reference's ``constraint_helpers.hpp:17-114``).  Pure functions over
explicit multiplier state; a constraint ``g(x, u) -> [m]`` of one
problem's stage is mapped over the horizon and any leading batch axes by
``torch.func.vmap``, as the JAX package vmaps it, so it may be written on
``x[..., i]`` (the port's convention, which the kernels need) or on one
problem's vectors.

Trajectories are time-major, ``states [..., T+1, nx]`` and
``controls [..., T, nu]``; multipliers are ``[..., T, m]`` and ``rho`` is
one value per problem (``[...]``).

Conventions (the reference's):

* equality AL term     ``lambda^T g + (rho/2) ||g||^2``
* inequality PHR term  ``(1/2rho)(||max(0, lambda + rho g)||^2 - ||lambda||^2)``
* multiplier updates   ``lambda += rho g``  /  ``lambda = max(0, lambda + rho g)``
* penalty schedule     ``rho *= factor`` while a violation norm exceeds the
  tolerance

The fused batched iLQR (``solvers/ilqr.py``) keeps its own batch-innermost
copy of the horizon evaluation and the norms; ``eval_constraints_horizon``
serves its non-fused path and the single-problem solve.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .derivatives import map_leading
from .types import ConstraintsFunction, Tensor


def eval_constraints_horizon(constraint: ConstraintsFunction, states: Tensor,
                             controls: Tensor) -> Tensor:
    """The constraint at ``(x_t, u_t)``, ``t = 0..T-1``: ``[..., T, m]``."""
    return map_leading(constraint, states[..., :-1, :], controls, lead=controls.shape[:-1])


def _per_problem(rho, like: Tensor) -> Tensor:
    """``rho [...]`` broadcast against ``[..., T, m]``."""
    return torch.as_tensor(rho, dtype=like.dtype, device=like.device)[..., None, None]


def equality_al_term(residuals: Tensor, multipliers: Tensor, rho) -> Tensor:
    """Sum over the horizon of ``lambda^T g + (rho/2)||g||^2``: ``[...]``."""
    rho = torch.as_tensor(rho, dtype=residuals.dtype, device=residuals.device)
    return ((multipliers * residuals).sum((-2, -1))
            + 0.5 * rho * (residuals ** 2).sum((-2, -1)))


def inequality_phr_term(residuals: Tensor, multipliers: Tensor, rho) -> Tensor:
    """Sum over the horizon of the PHR inequality term: ``[...]``."""
    r = _per_problem(rho, residuals)
    combined_plus = torch.maximum(multipliers + r * residuals, residuals.new_zeros(()))
    return (0.5 / r[..., 0, 0]) * (combined_plus ** 2 - multipliers ** 2).sum((-2, -1))


def compute_augmented_cost(spec, states: Tensor, controls: Tensor,
                           eq_multipliers: Optional[Tensor],
                           ineq_multipliers: Optional[Tensor], rho) -> Tensor:
    """Objective plus the AL terms of the spec's constraints."""
    cost = spec.cost(states, controls)
    if spec.eq_dim > 0:
        g = eval_constraints_horizon(spec.equality_constraints, states, controls)
        cost = cost + equality_al_term(g, eq_multipliers, rho)
    if spec.ineq_dim > 0:
        h = eval_constraints_horizon(spec.inequality_constraints, states, controls)
        cost = cost + inequality_phr_term(h, ineq_multipliers, rho)
    return cost


def update_lagrange_multipliers(spec, states: Tensor, controls: Tensor,
                                eq_multipliers: Optional[Tensor],
                                ineq_multipliers: Optional[Tensor],
                                rho) -> Tuple[Optional[Tensor], Optional[Tensor]]:
    """Dual ascent: ``lambda + rho g`` and ``max(0, mu + rho h)``."""
    new_eq, new_ineq = eq_multipliers, ineq_multipliers
    if spec.eq_dim > 0:
        g = eval_constraints_horizon(spec.equality_constraints, states, controls)
        new_eq = eq_multipliers + _per_problem(rho, g) * g
    if spec.ineq_dim > 0:
        h = eval_constraints_horizon(spec.inequality_constraints, states, controls)
        new_ineq = torch.maximum(ineq_multipliers + _per_problem(rho, h) * h, h.new_zeros(()))
    return new_eq, new_ineq


def violation_norms(spec, states: Tensor, controls: Tensor) -> Tuple[Tensor, Tensor]:
    """Whole-horizon violation norms ``sqrt(sum_t ||g_t||^2)`` and
    ``sqrt(sum_t ||max(0, h_t)||^2)`` (0 without the constraint)."""
    zero = states.new_zeros(states.shape[:-2])
    eq_norm = ineq_norm = zero
    if spec.eq_dim > 0:
        g = eval_constraints_horizon(spec.equality_constraints, states, controls)
        eq_norm = torch.sqrt((g ** 2).sum((-2, -1)))
    if spec.ineq_dim > 0:
        h = eval_constraints_horizon(spec.inequality_constraints, states, controls)
        ineq_norm = torch.sqrt((torch.maximum(h, h.new_zeros(())) ** 2).sum((-2, -1)))
    return eq_norm, ineq_norm


def increase_penalty_parameter(rho, spec, states: Tensor, controls: Tensor,
                               tolerance: float, factor: float = 1.5) -> Tensor:
    """``rho * factor`` where a violation norm exceeds ``tolerance``."""
    eq_norm, ineq_norm = violation_norms(spec, states, controls)
    rho = torch.as_tensor(rho, dtype=states.dtype, device=states.device)
    return torch.where((eq_norm > tolerance) | (ineq_norm > tolerance), rho * factor, rho)


def clamp_controls(controls: Tensor, lower: Tensor, upper: Tensor) -> Tensor:
    """Elementwise box clamp ``min(max(u, lower), upper)`` (NaN stays NaN)."""
    return torch.minimum(torch.maximum(controls, lower), upper)
