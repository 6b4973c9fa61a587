"""Closed-form linear algebra for tiny matrices (n <= 4), batched over the
leading axes.

PyTorch counterpart of ``multi_agent_solver_tpu/ops/small.py``: the
positive-definiteness test and the SPD solves of the scan backward pass,
as determinant / adjugate arithmetic in the JAX package's order of
operations.  For n > 4 the generic Cholesky path is used.  These are plain
tensor code on every device: the JAX package computes them in XLA, not in
a Pallas kernel.
"""

from __future__ import annotations

import torch

from ..types import Tensor


def _det2(a00, a01, a10, a11):
    return a00 * a11 - a01 * a10


def det_small(Q: Tensor) -> Tensor:
    """Determinant by cofactor expansion for n <= 4: ``[..., n, n] -> [...]``."""
    n = Q.shape[-1]
    if n == 1:
        return Q[..., 0, 0]
    if n == 2:
        return _det2(Q[..., 0, 0], Q[..., 0, 1], Q[..., 1, 0], Q[..., 1, 1])
    if n == 3:
        return (
            Q[..., 0, 0] * _det2(Q[..., 1, 1], Q[..., 1, 2], Q[..., 2, 1], Q[..., 2, 2])
            - Q[..., 0, 1] * _det2(Q[..., 1, 0], Q[..., 1, 2], Q[..., 2, 0], Q[..., 2, 2])
            + Q[..., 0, 2] * _det2(Q[..., 1, 0], Q[..., 1, 1], Q[..., 2, 0], Q[..., 2, 1])
        )
    if n == 4:
        det = 0.0
        sign = 1.0
        for j in range(4):
            cols = [c for c in range(4) if c != j]
            minor = Q[..., 1:, :][..., :, cols]
            det = det + sign * Q[..., 0, j] * det_small(minor)
            sign = -sign
        return det
    raise ValueError(f"det_small supports n <= 4, got {n}")


def leading_minors_positive(Q: Tensor) -> Tensor:
    """Sylvester's criterion: every leading principal minor > 0 (for n > 4
    a Cholesky factorization that succeeds with finite entries)."""
    n = Q.shape[-1]
    if n > 4:
        chol, info = torch.linalg.cholesky_ex(Q)
        return (info == 0) & torch.isfinite(chol).all((-2, -1))
    ok = Q[..., 0, 0] > 0.0
    for k in range(2, n + 1):
        ok = ok & (det_small(Q[..., :k, :k]) > 0.0)
    return ok


def inv_small(Q: Tensor) -> Tensor:
    """Explicit inverse for n <= 4: adjugate (n <= 3), block Schur (n = 4)."""
    n = Q.shape[-1]
    if n == 1:
        return 1.0 / Q
    if n == 2:
        det = det_small(Q)
        adj = torch.stack([
            torch.stack([Q[..., 1, 1], -Q[..., 0, 1]], -1),
            torch.stack([-Q[..., 1, 0], Q[..., 0, 0]], -1),
        ], -2)
        return adj / det[..., None, None]
    if n == 3:
        det = det_small(Q)
        cof = []
        for i in range(3):
            row = []
            for j in range(3):
                rows = [r for r in range(3) if r != j]   # transposed: the adjugate
                cols = [c for c in range(3) if c != i]
                minor = Q[..., rows, :][..., :, cols]
                row.append(((-1.0) ** (i + j)) * det_small(minor))
            cof.append(torch.stack(row, -1))
        return torch.stack(cof, -2) / det[..., None, None]
    if n == 4:
        A, B = Q[..., :2, :2], Q[..., :2, 2:]
        C, D = Q[..., 2:, :2], Q[..., 2:, 2:]
        Ai = inv_small(A)
        S = D - C @ Ai @ B
        Si = inv_small(S)
        AiB = Ai @ B
        CAi = C @ Ai
        top = torch.cat([Ai + AiB @ Si @ CAi, -AiB @ Si], -1)
        return torch.cat([top, torch.cat([-Si @ CAi, Si], -1)], -2)
    return torch.linalg.inv(Q)


def solve_spd_small(Q: Tensor, rhs: Tensor) -> Tensor:
    """Solve SPD ``Q x = rhs`` (``rhs [..., n]`` or ``[..., n, k]``)."""
    n = Q.shape[-1]
    vector = rhs.dim() == Q.dim() - 1
    if n > 4:
        chol = torch.linalg.cholesky(Q)
        out = torch.cholesky_solve(rhs[..., None] if vector else rhs, chol)
        return out[..., 0] if vector else out
    Qi = inv_small(Q)
    if vector:
        return torch.einsum("...ij,...j->...i", Qi, rhs)
    return Qi @ rhs


def reg_levels(reg_init: float, factor: float, num_levels: int, like: Tensor) -> Tensor:
    """The cumulative ladder ``reg_init (factor^j - 1) / (factor - 1)`` in
    the dtype of ``like``, as the JAX package computes it."""
    j = torch.arange(num_levels, dtype=like.dtype, device=like.device)
    return reg_init * (factor ** j - 1.0) / (factor - 1.0)


def psd_solve_with_escalation(Q: Tensor, rhs: Tensor, reg_init: float = 1e-6,
                              factor: float = 10.0, num_levels: int = 16):
    """Solve ``(Q + c_j I) x = rhs`` for the first level ``c_j`` of the
    cumulative ladder whose shifted ``Q`` passes Sylvester's test (the
    last level when none does).  Returns ``(x, level_index)``."""
    n = Q.shape[-1]
    levels = reg_levels(reg_init, factor, num_levels, Q)
    eye = torch.eye(n, dtype=Q.dtype, device=Q.device)
    candidates = Q[None] + levels.reshape((-1,) + (1,) * Q.dim()) * eye
    ok = leading_minors_positive(candidates)                      # [levels, ...]
    idx = torch.where(ok.any(0), torch.argmax(ok.to(torch.uint8), 0),
                      torch.full_like(ok[0], num_levels - 1, dtype=torch.int64))
    Q_reg = Q + levels[idx][..., None, None] * eye
    return solve_spd_small(Q_reg, rhs), idx
