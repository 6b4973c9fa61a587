"""Linear-quadratic building blocks for LQR-style problems.

PyTorch counterpart of ``multi_agent_solver_tpu/models/lqr.py``: linear
dynamics ``f(x, u) = A x + B u`` and the quadratic costs ``x'Qx + u'Ru``
and ``x'Qf x``.  Each is written on ``x[..., i]``, so batch and time axes
broadcast, and sums its products in a fixed order (the products taken at
once, the sums one add at a time): ``f_i = (A x)_i + (B u)_i`` with each
product summed from column 0; ``x'Qx`` as ``(x Q) x``,
both sums from index 0.  The callables carry the tags of ``Linear<NX, NU>``,
``Quadratic<NX, NU>`` and ``QuadraticTerminal<NX>`` in
``csrc/problems.cuh``, which sum the same products in the same order; the
tags' float parameters are the matrices, row-major (A then B; Q then R).
A linear model comes in any size, so its tag names its dims
(``linear_4x4``).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..types import Tensor, tag_device_fn


def _rows(M) -> tuple:
    """A matrix as a tuple of rows of Python floats."""
    M = torch.as_tensor(M, dtype=torch.float64).detach().cpu()
    if M.dim() != 2:
        raise ValueError(f"expected a matrix, got shape {tuple(M.shape)}")
    return tuple(tuple(float(v) for v in row) for row in M.tolist())


def _constant(M: tuple):
    """``get(like)``: ``M`` as a tensor in ``like``'s dtype and on its
    device, kept once per (dtype, device).  Inside a ``torch.func``
    transform it is made afresh: a tensor made there belongs to the
    transform's level and may not outlive it."""
    made = {}

    def get(like: Tensor) -> Tensor:
        key = (like.dtype, like.device)
        if key in made:
            return made[key]
        t = torch.tensor(M, dtype=like.dtype, device=like.device)
        if not torch._C._are_functorch_transforms_active():
            made[key] = t
        return t

    return get


def _row_sums(P: Tensor) -> Tensor:
    """``sum_j P[..., j]`` from ``j = 0``, one add at a time."""
    s = P[..., 0]
    for j in range(1, P.shape[-1]):
        s = s + P[..., j]
    return s


def _form(M: Tensor, v: Tensor) -> Tensor:
    """``v' M v`` as ``(v M) v``: ``w_j = sum_i v_i M_ij``, then
    ``sum_j w_j v_j``, each sum from index 0."""
    P = v[..., :, None] * M                      # [..., i, j] = v_i M_ij
    w = P[..., 0, :]
    for i in range(1, M.shape[0]):
        w = w + P[..., i, :]
    return _row_sums(w * v)


def make_linear_dynamics(A, B) -> Callable:
    """Continuous dynamics ``f(x, u) = A x + B u``, tagged
    ``linear_{nx}x{nu}`` with the entries of A then B, row-major."""
    A, B = _rows(A), _rows(B)
    nx, nu = len(A), len(B[0])
    if len(A[0]) != nx or len(B) != nx:
        raise ValueError(f"A must be nx x nx and B nx x nu; got {len(A)}x{len(A[0])}, "
                         f"{len(B)}x{nu}")

    A_t, B_t = _constant(A), _constant(B)

    def dynamics(x: Tensor, u: Tensor) -> Tensor:
        return _row_sums(x[..., None, :] * A_t(x)) + _row_sums(u[..., None, :] * B_t(u))

    return tag_device_fn(dynamics, f"linear_{nx}x{nu}",
                         [v for row in A for v in row] + [v for row in B for v in row])


def quadratic_stage_cost(Q, R) -> Callable:
    """``l(x, u, t) = x'Qx + u'Ru``, tagged ``quadratic`` with the entries of
    Q then R, row-major."""
    Q, R = _rows(Q), _rows(R)
    Q_t, R_t = _constant(Q), _constant(R)

    def stage(x: Tensor, u: Tensor, t) -> Tensor:
        return _form(Q_t(x), x) + _form(R_t(u), u)

    return tag_device_fn(stage, "quadratic",
                         [v for row in Q for v in row] + [v for row in R for v in row])


def quadratic_terminal_cost(Qf) -> Callable:
    """``lT(x) = x'Qf x``, tagged ``quadratic_terminal`` with the entries of
    Qf, row-major."""
    Qf = _rows(Qf)
    Qf_t = _constant(Qf)

    def terminal(x: Tensor) -> Tensor:
        return _form(Qf_t(x), x)

    return tag_device_fn(terminal, "quadratic_terminal", [v for row in Qf for v in row])
