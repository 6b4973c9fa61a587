"""K1: backward Riccati pass with in-kernel linearization (stationary cost).

Port of ``multi_agent_solver_tpu/ops/riccati_pallas.py ::
riccati_fusedlin_pallas_tiled``; the CUDA kernel is ``csrc/riccati.cu``.
The plain version below ports ``_stage_core``, ``_gauss_jordan_solve``,
``_det_rect`` and ``_terminal_into_scratch`` onto lists of ``[B]`` tensors,
in the same order of operations.

Layout (batch innermost): ``xs [T, nx, B]`` stage states x_0..x_{T-1},
``us [T, nu, B]``, time-constant Hessians ``lxx [nx, nx, B]``,
``luu [nu, nu, B]``, ``lux [nu, nx, B]``, terminal states ``xT [nx, B]``
in; gains ``k [T, nu, B]``, ``K [T, nu, nx, B]`` out.
"""

from __future__ import annotations

from typing import List

import torch
from torch.func import jvp

from ..types import Tensor
from ._build import KernelStats, check_tensor, launch, problem_symbol, step_constants
from .linearize import _basis, stage_derivatives

STATS = KernelStats()


def reg_ladder(reg_init: float, reg_factor: float, reg_levels: int) -> tuple:
    """Cumulative regularization levels ``reg_init (f^j - 1) / (f - 1)``,
    computed in double as the reference does (passed on as float32)."""
    return tuple(
        float(reg_init * (reg_factor**j - 1.0) / (reg_factor - 1.0))
        for j in range(reg_levels)
    )


def _det_rect(M, rows, cols):
    """Determinant of M[rows][:, cols] by first-row expansion."""
    if len(rows) == 1:
        return M[rows[0]][cols[0]]
    total = None
    for pos, c in enumerate(cols):
        m = _det_rect(M, rows[1:], [cc for cc in cols if cc != c])
        term = M[rows[0]][c] * m
        if total is None:
            total = term
        elif pos % 2 == 0:
            total = total + term
        else:
            total = total - term
    return total


def _gauss_jordan_solve(Q: List[List[Tensor]], rhs: List[List[Tensor]], n: int, m: int):
    """Solve Q X = rhs, unrolled, without pivoting (Q is SPD after
    regularization, so the diagonal pivots are safe)."""
    A = [[Q[i][j] for j in range(n)] for i in range(n)]
    X = [[rhs[i][j] for j in range(m)] for i in range(n)]
    for col in range(n):
        inv_piv = 1.0 / A[col][col]
        for j in range(col, n):
            A[col][j] = A[col][j] * inv_piv
        for j in range(m):
            X[col][j] = X[col][j] * inv_piv
        for row in range(n):
            if row == col:
                continue
            factor = A[row][col]
            for j in range(col, n):
                A[row][j] = A[row][j] - factor * A[col][j]
            for j in range(m):
                X[row][j] = X[row][j] - factor * X[col][j]
    return X


def _stage_core(A, Bm, lx, lu, lxx, luu, lux, v_x, v_xx, nx, nu, reg_levels):
    """One Riccati stage on lists of ``[B]`` tensors: Q-terms, the
    regularization ladder, gains, value recursion.  Returns
    ``(k_t, K_t, new_vx, new_vxx)`` (new_vxx not yet symmetrized)."""
    q_x = [lx[j] + sum(A[i][j] * v_x[i] for i in range(nx)) for j in range(nx)]
    q_u = [lu[j] + sum(Bm[i][j] * v_x[i] for i in range(nx)) for j in range(nu)]
    vA = [[sum(v_xx[i][kk] * A[kk][j] for kk in range(nx)) for j in range(nx)]
          for i in range(nx)]
    q_xx = [[lxx[i][j] + sum(A[kk][i] * vA[kk][j] for kk in range(nx))
             for j in range(nx)] for i in range(nx)]
    q_ux = [[lux[i][j] + sum(Bm[kk][i] * vA[kk][j] for kk in range(nx))
             for j in range(nx)] for i in range(nu)]
    vB = [[sum(v_xx[i][kk] * Bm[kk][j] for kk in range(nx)) for j in range(nu)]
          for i in range(nx)]
    q_uu = [[luu[i][j] + sum(Bm[kk][i] * vB[kk][j] for kk in range(nx))
             for j in range(nu)] for i in range(nu)]

    # Smallest cumulative level whose shifted q_uu passes Sylvester's test.
    def minors_ok(shift):
        Qs = [[q_uu[i][j] + (shift if i == j else 0.0) for j in range(nu)]
              for i in range(nu)]
        ok = Qs[0][0] > 0.0
        for kdim in range(2, nu + 1):
            ok = ok & (_det_rect(Qs, list(range(kdim)), list(range(kdim))) > 0.0)
        return ok

    best = torch.full_like(q_uu[0][0], reg_levels[-1])
    for level in reversed(reg_levels):
        best = torch.where(minors_ok(level), torch.full_like(best, level), best)

    q_uu_reg = [[q_uu[i][j] + (best if i == j else 0.0) for j in range(nu)]
                for i in range(nu)]
    rhs = [[q_u[i]] + [q_ux[i][j] for j in range(nx)] for i in range(nu)]
    sol = _gauss_jordan_solve(q_uu_reg, rhs, nu, nx + 1)
    k_t = [-sol[i][0] for i in range(nu)]
    K_t = [[-sol[i][1 + j] for j in range(nx)] for i in range(nu)]

    q_uu_k = [sum(q_uu[i][j] * k_t[j] for j in range(nu)) for i in range(nu)]
    new_vx = [
        q_x[j]
        + sum(K_t[u][j] * q_u[u] for u in range(nu))
        + sum(q_ux[u][j] * k_t[u] for u in range(nu))
        + sum(K_t[u][j] * q_uu_k[u] for u in range(nu))
        for j in range(nx)
    ]
    KQ = [[sum(K_t[u][i] * q_ux[u][j] for u in range(nu)) for j in range(nx)]
          for i in range(nx)]
    KqK = [[sum(K_t[u][i] * sum(q_uu[u][v] * K_t[v][j] for v in range(nu))
                for u in range(nu)) for j in range(nx)] for i in range(nx)]
    new_vxx = [[q_xx[i][j] + KQ[i][j] + KQ[j][i] + KqK[i][j] for j in range(nx)]
               for i in range(nx)]
    return k_t, K_t, new_vx, new_vxx


def terminal_derivatives(terminal_fn, xT: Tensor):
    """``(phi_x, phi_xx)`` of ``terminal_fn`` at ``xT [B, nx]`` by jvp and
    jvp over jvp, as lists of ``[B]`` tensors; upper triangle mirrored."""
    nx = xT.shape[-1]
    zeros = torch.zeros_like(xT[..., 0])
    grad_j = lambda a, j: jvp(terminal_fn, (a,), (_basis(nx, j, a),))[1] + zeros
    vx = [grad_j(xT, j) for j in range(nx)]
    vxx = [[None] * nx for _ in range(nx)]
    for i in range(nx):
        for j in range(i, nx):
            h = jvp(lambda a: grad_j(a, i), (xT,), (_basis(nx, j, xT),))[1] + zeros
            vxx[i][j] = vxx[j][i] = h
    return vx, vxx


def riccati_fusedlin_plain(spec, xs, us, lxx, luu, lux, xT, reg_levels: tuple):
    """Plain PyTorch version of the K1 kernel (same layout and outputs)."""
    STATS.plain_calls += 1
    T, nx, B = xs.shape
    nu = us.shape[1]
    x = xs.permute(0, 2, 1)
    u = us.permute(0, 2, 1)
    # Real stage times, as the float lane values the TPU kernel passes.
    t = torch.arange(T, dtype=xs.dtype, device=xs.device)[:, None].expand(T, B)
    A_all, B_all, lx_all, lu_all = stage_derivatives(spec, x, u, t)
    v_x, v_xx = terminal_derivatives(spec.terminal_cost, xT.T)
    Lxx = [[lxx[i, j] for j in range(nx)] for i in range(nx)]
    Luu = [[luu[i, j] for j in range(nu)] for i in range(nu)]
    Lux = [[lux[i, j] for j in range(nx)] for i in range(nu)]
    k = torch.empty((T, nu, B), dtype=torch.float32, device=xs.device)
    K = torch.empty((T, nu, nx, B), dtype=torch.float32, device=xs.device)
    for s in range(T - 1, -1, -1):
        A = [[A_all[s, :, i, j] for j in range(nx)] for i in range(nx)]
        Bm = [[B_all[s, :, i, j] for j in range(nu)] for i in range(nx)]
        lx = [lx_all[s, :, j] for j in range(nx)]
        lu = [lu_all[s, :, j] for j in range(nu)]
        k_t, K_t, v_x, new_vxx = _stage_core(
            A, Bm, lx, lu, Lxx, Luu, Lux, v_x, v_xx, nx, nu, reg_levels)
        k[s] = torch.stack(k_t)
        K[s] = torch.stack([torch.stack(row) for row in K_t])
        v_xx = [[0.5 * (new_vxx[i][j] + new_vxx[j][i]) for j in range(nx)]
                for i in range(nx)]
    return k, K


def riccati_fusedlin(spec, xs, us, lxx, luu, lux, xT, reg_levels: tuple):
    """K1 on the card for CUDA tensors, the plain version for CPU tensors.
    ``reg_levels`` is the ladder of :func:`reg_ladder`."""
    if xs.device.type == "cpu":
        return riccati_fusedlin_plain(spec, xs, us, lxx, luu, lux, xT, reg_levels)
    T, nx, B = xs.shape
    nu = us.shape[1]
    dev = xs.device
    for t, name, shape in ((xs, "xs", (T, nx, B)), (us, "us", (T, nu, B)),
                           (lxx, "lxx", (nx, nx, B)), (luu, "luu", (nu, nu, B)),
                           (lux, "lux", (nu, nx, B)), (xT, "xT", (nx, B))):
        check_tensor(t, name, shape, dev)
    symbol, (dyn_p, cost_p, term_p) = problem_symbol(
        "riccati_fusedlin", nx, nu, spec.dynamics, spec.stage_cost, spec.terminal_cost)
    k = torch.empty((T, nu, B), dtype=torch.float32, device=dev)
    K = torch.empty((T, nu, nx, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(symbol, xs, us, lxx, luu, lux, xT, k, K, T, B, dyn_p, cost_p, term_p,
               step_constants(spec.dt), tuple(reg_levels), len(reg_levels))
    STATS.launches += 1
    return k, K
