"""Finite-difference derivative oracles with the reference's epsilons.

PyTorch counterpart of ``multi_agent_solver_tpu/finite_differences.py``.
The port's default derivatives are exact (``derivatives.py``, by
``torch.func``); this module gives the ``fd`` parity mode the reference's
central differences and epsilon choices:

* shooting cost gradient: ``eps = max(1e-6, 1e-8 |u|)``
* dynamics Jacobians:     ``eps = 1e-6``
* cost gradients:         ``eps = 1e-6``
* cost Hessians:          ``eps = 1e-5``, a 3-point diagonal and a 4-point
  cross stencil
* cross term / constraint Jacobians: ``eps = 1e-6``

Every probe direction of a stencil is evaluated at once by
``torch.func.vmap`` over the perturbations, as the JAX package batches
them with ``jax.vmap``; each stencil is the JAX package's expression in
its order of operations.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.func import vmap

from .integrators import integrate_horizon, integrate_rk4
from .types import Tensor


def safe_eval(fn, *args) -> Tensor:
    """``fn(*args)`` with non-finite values mapped to 0.0."""
    value = fn(*args)
    return torch.where(torch.isfinite(value), value, torch.zeros_like(value))


def _eye(n: int, like: Tensor, eps: float) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device) * eps


def fd_jacobian(fn: Callable[[Tensor], Tensor], x: Tensor, eps: float = 1e-6) -> Tensor:
    """Central-difference Jacobian of ``fn`` at ``x``: ``[len(fn(x)), len(x)]``;
    the ``2n`` probes evaluated by one ``vmap`` each side."""
    eye = _eye(x.shape[0], x, eps)
    f_plus = vmap(lambda d: fn(x + d))(eye)     # [n, m]
    f_minus = vmap(lambda d: fn(x - d))(eye)
    return ((f_plus - f_minus) / (2.0 * eps)).T


def fd_gradient(fn: Callable[[Tensor], Tensor], x: Tensor, eps: float = 1e-6) -> Tensor:
    """Central-difference gradient of a scalar function."""
    eye = _eye(x.shape[0], x, eps)
    f_plus = vmap(lambda d: fn(x + d))(eye)
    f_minus = vmap(lambda d: fn(x - d))(eye)
    return (f_plus - f_minus) / (2.0 * eps)


def fd_hessian(fn: Callable[[Tensor], Tensor], x: Tensor, eps: float = 1e-5) -> Tensor:
    """The reference's Hessian stencil: 3-point diagonal, 4-point off the
    diagonal, non-finite probes read as 0 (:func:`safe_eval`)."""
    n = x.shape[0]
    eye = _eye(n, x, eps)
    sfn = lambda y: safe_eval(fn, y)

    f0 = sfn(x)
    f_plus = vmap(lambda d: sfn(x + d))(eye)
    f_minus = vmap(lambda d: sfn(x - d))(eye)
    diag = (f_plus - 2.0 * f0 + f_minus) / (eps * eps)

    # Every (i, j) pair: x + s_i eps e_i + s_j eps e_j.
    di = eye[:, None, :].expand(n, n, n)
    dj = eye[None, :, :].expand(n, n, n)
    probe = lambda s_i, s_j: vmap(vmap(lambda a, b: sfn(x + a + b)))(s_i * di, s_j * dj)
    f_pp = probe(1.0, 1.0)
    f_pm = probe(1.0, -1.0)
    f_mp = probe(-1.0, 1.0)
    f_mm = probe(-1.0, -1.0)
    off = (f_pp - f_pm - f_mp + f_mm) / (4.0 * eps * eps)

    on_diag = torch.eye(n, dtype=torch.bool, device=x.device)
    return torch.where(on_diag, torch.diag_embed(diag), off)


def fd_cross_term(fn_xu: Callable[[Tensor, Tensor], Tensor], x: Tensor, u: Tensor,
                  eps: float = 1e-6) -> Tensor:
    """4-point mixed-partial stencil ``d^2 l / du dx``: ``[nu, nx]``."""
    ex = _eye(x.shape[0], x, eps)
    eu = _eye(u.shape[0], u, eps)
    sfn = lambda a, b: safe_eval(fn_xu, a, b)

    def entry(du, dx):
        f_pp = sfn(x + dx, u + du)
        f_pm = sfn(x - dx, u + du)
        f_mp = sfn(x + dx, u - du)
        f_mm = sfn(x - dx, u - du)
        return (f_pp - f_pm - f_mp + f_mm) / (4.0 * eps * eps)

    return vmap(lambda du: vmap(lambda dx: entry(du, dx))(ex))(eu)


def finite_differences_gradient(initial_state: Tensor, controls: Tensor, dynamics,
                                objective_function, dt: float) -> Tensor:
    """Central-difference gradient of the total cost with respect to every
    control entry, ``eps = max(1e-6, 1e-8 |u_ti|)``: all ``2 T nu``
    rollouts of the horizon in one ``vmap`` over the perturbations.
    ``controls [T, nu]`` in, ``[T, nu]`` out."""
    T, nu = controls.shape
    flat = controls.reshape(-1)
    eps = torch.maximum(torch.full_like(flat, 1e-6), 1e-8 * torch.abs(flat))   # [T nu]
    basis = torch.eye(T * nu, dtype=controls.dtype, device=controls.device) * eps[:, None]

    def rollout_cost(u_flat):
        u = u_flat.reshape(T, nu)
        xs = integrate_horizon(initial_state, u, dt, dynamics, integrate_rk4)
        return objective_function(xs, u)

    cost_plus = vmap(lambda d: rollout_cost(flat + d))(basis)
    cost_minus = vmap(lambda d: rollout_cost(flat - d))(basis)
    grad = (cost_plus - cost_minus) / (2.0 * eps)
    return grad.reshape(T, nu)
