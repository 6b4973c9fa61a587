"""K1, K4 and K5: the backward Riccati passes and the box-QP stage solve.

Ports of ``multi_agent_solver_tpu/ops/riccati_pallas.py``:

* :func:`riccati_fusedlin` -- K1, ``riccati_fusedlin_pallas_tiled``: the
  pass with in-kernel linearization, stationary cost;
* :func:`riccati_backward` -- K4, ``riccati_backward_pallas_tiled`` with its
  terminal function in the kernel: the pass on precomputed stacks;
* :func:`riccati_backward_explicit` -- K4's explicit-terminal mode (the
  given ``vx0 [nx, B]``, ``vxx0 [nx, nx, B]`` in place of the terminal
  function), and :func:`riccati_backward_pallas`, its batch-first wrapper
  (``riccati_backward_pallas``: ``[B, T, ...]`` stacks, converted once to
  the port's layout and back), the backward pass of the non-fused path;
* :func:`boxqp_lane_gains_plain` -- K5, ``_boxqp_lane_gains``: the exact
  box-QP stage solve that K1 and K4 run under ``bound_mode="boxqp"`` (a
  device function inside both CUDA kernels, so it has no launch of its own).

The CUDA kernels are ``csrc/riccati.cu``.  The plain versions below port
``_stage_core``, ``_boxqp_lane_gains``, ``_gauss_jordan_solve``,
``_det_rect`` and ``_terminal_into_scratch`` onto lists of ``[B]`` tensors,
in the same order of operations.

Layout (batch innermost): ``xs [T, nx, B]`` stage states x_0..x_{T-1},
``us [T, nu, B]``, terminal states ``xT [nx, B]``; K1 takes time-constant
Hessians ``lxx [nx, nx, B]``, ``luu [nu, nu, B]``, ``lux [nu, nx, B]``; K4
takes ``A [T, nx, nx, B]``, ``B [T, nx, nu, B]``, ``lx [T, nx, B]``,
``lu [T, nu, B]`` and Hessian stacks ``[H, ..., B]`` with ``H = T`` or
``H = 1`` (``hess_tconst``: one block for every stage).  Under boxqp both
take the delta bounds ``lb``, ``ub`` ``[T, nu, B]`` (the box around the
current controls).  Out: gains ``k [T, nu, B]``, ``K [T, nu, nx, B]``.
K1 takes the Jacobian mode (``discrete=False``: the Jacobians of the
continuous dynamics).  Launches are counted per kernel and mode:
``STATS`` (K1), ``CONT_STATS`` (K1, continuous), ``BACKWARD_STATS`` (K4),
``EXPLICIT_STATS`` (K4 explicit-terminal) and ``BOXQP_STATS`` (K5).
"""

from __future__ import annotations

import itertools
from typing import List

import torch

from ..types import Tensor
from ._build import (KernelStats, check_tensor, launch, problem_symbol, stage_major,
                     step_constants)
from .linearize import stage_derivatives, terminal_derivatives

STATS = KernelStats()            # K1
CONT_STATS = KernelStats()       # K1 in the continuous Jacobian mode
BACKWARD_STATS = KernelStats()   # K4
EXPLICIT_STATS = KernelStats()   # K4 in the explicit-terminal mode
# K5 runs inside K1 and K4: one count for each of their launches (or
# plain calls) under boxqp.
BOXQP_STATS = KernelStats()
# (nx, nu) with an instantiation of K4's explicit-terminal mode
# (csrc/riccati_explicit*.cu), and those instantiated in clamp mode alone
# (the LQR's: a boxqp launch raises NotImplementedError).
EXPLICIT_DIMS = ((4, 2), (2, 1), (6, 3), (8, 4), (4, 1), (4, 4), (6, 2), (3, 1), (12, 4),
                 (16, 4))
EXPLICIT_CLAMP_ONLY = ((4, 4), (12, 4), (16, 4))


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


def boxqp_lane_gains_plain(q_uu_reg, q_u, q_ux, lb, ub, nu, nx):
    """Plain PyTorch version of K5 on lists of ``[B]`` tensors.

    Enumerates the 3^nu free / at-lower / at-upper configurations, solves
    each free subsystem with the unpivoted Gauss-Jordan and takes the first
    configuration whose KKT conditions hold; clamped dimensions get zero
    feedback rows.  Where none holds, the unconstrained Newton step clipped
    to the box, with full feedback.  Returns ``(k [nu], K [nu][nx])``.
    """
    FREE, AT_LB, AT_UB = 0, 1, 2
    zeros = 0.0 * q_u[0]
    best_k = [zeros for _ in range(nu)]
    best_K = [[zeros for _ in range(nx)] for _ in range(nu)]
    found = zeros > 1.0

    for config in itertools.product((FREE, AT_LB, AT_UB), repeat=nu):
        free = [i for i in range(nu) if config[i] == FREE]
        clamped = [i for i in range(nu) if config[i] != FREE]
        v = [lb[i] if config[i] == AT_LB else (ub[i] if config[i] == AT_UB else zeros)
             for i in range(nu)]
        du = list(v)
        K = [[zeros for _ in range(nx)] for _ in range(nu)]
        if free:
            sub = [[q_uu_reg[i][j] for j in free] for i in free]
            rhs = [[q_u[i] + sum(q_uu_reg[i][c] * v[c] for c in clamped)]
                   + [q_ux[i][j] for j in range(nx)] for i in free]
            sol = _gauss_jordan_solve(sub, rhs, len(free), nx + 1)
            for pos, i in enumerate(free):
                du[i] = -sol[pos][0]
                K[i] = [-sol[pos][1 + j] for j in range(nx)]

        grad = [q_u[i] + sum(q_uu_reg[i][j] * du[j] for j in range(nu)) for i in range(nu)]
        ok = zeros <= 0.0
        for i in range(nu):
            if config[i] == FREE:
                ok = ok & ((du[i] >= lb[i]) & (du[i] <= ub[i]))
            elif config[i] == AT_LB:
                ok = ok & (grad[i] >= 0.0)
            else:
                ok = ok & (grad[i] <= 0.0)

        take = ok & ~found
        for i in range(nu):
            best_k[i] = torch.where(take, du[i], best_k[i])
            best_K[i] = [torch.where(take, K[i][j], best_K[i][j]) for j in range(nx)]
        found = found | ok

    rhs = [[q_u[i]] + [q_ux[i][j] for j in range(nx)] for i in range(nu)]
    sol = _gauss_jordan_solve(q_uu_reg, rhs, nu, nx + 1)
    for i in range(nu):
        unc = torch.minimum(torch.maximum(-sol[i][0], lb[i]), ub[i])
        best_k[i] = torch.where(found, best_k[i], unc)
        best_K[i] = [torch.where(found, best_K[i][j], -sol[i][1 + j]) for j in range(nx)]
    return best_k, best_K


def _stage_core(A, Bm, lx, lu, lxx, luu, lux, v_x, v_xx, nx, nu, reg_levels,
                boxqp=False, lb=None, ub=None):
    """One Riccati stage on lists of ``[B]`` tensors: Q-terms, the
    regularization ladder, gains (the box-QP gains of K5 under ``boxqp``,
    with the stage's delta bounds ``lb``, ``ub``), value recursion.  Returns
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
    if boxqp:
        k_t, K_t = boxqp_lane_gains_plain(q_uu_reg, q_u, q_ux, lb, ub, nu, nx)
    else:
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


def _rows(a: Tensor, s: int):
    """Stage ``s`` of a ``[T or 1, ..., B]`` stack as nested lists of ``[B]``
    tensors (stage 0 of a one-stage stack)."""
    a = a[s if a.shape[0] > 1 else 0]
    if a.dim() == 2:
        return [a[i] for i in range(a.shape[0])]
    return [[a[i, j] for j in range(a.shape[1])] for i in range(a.shape[0])]


def _backward_recursion(stage_inputs, value, T, nx, nu, reg_levels, lb, ub, device):
    """The stage recursion shared by the plain K1 and K4: the terminal
    value ``value = (v_x, v_xx)`` (lists of ``[B]`` tensors), then stages
    T-1 .. 0, ``stage_inputs(s)`` giving ``(A, Bm, lx, lu, lxx, luu, lux)``
    as nested lists of ``[B]`` tensors."""
    v_x, v_xx = value
    B = v_x[0].shape[0]
    boxqp = lb is not None
    BOXQP_STATS.plain_calls += int(boxqp)
    k = torch.empty((T, nu, B), dtype=torch.float32, device=device)
    K = torch.empty((T, nu, nx, B), dtype=torch.float32, device=device)
    for s in range(T - 1, -1, -1):
        bounds = (_rows(lb, s), _rows(ub, s)) if boxqp else (None, None)
        k_t, K_t, v_x, new_vxx = _stage_core(
            *stage_inputs(s), v_x, v_xx, nx, nu, reg_levels, boxqp, *bounds)
        k[s] = torch.stack(k_t)
        K[s] = torch.stack([torch.stack(row) for row in K_t])
        v_xx = [[0.5 * (new_vxx[i][j] + new_vxx[j][i]) for j in range(nx)]
                for i in range(nx)]
    return k, K


def riccati_fusedlin_plain(spec, xs, us, lxx, luu, lux, xT, reg_levels: tuple, lb=None, ub=None,
                           discrete: bool = True):
    """Plain PyTorch version of the K1 kernel (same layout and outputs)."""
    (STATS if discrete else CONT_STATS).plain_calls += 1
    T, nx, B = xs.shape
    nu = us.shape[1]
    x = xs.permute(0, 2, 1)
    u = us.permute(0, 2, 1)
    # Real stage times, as the float lane values the TPU kernel passes.
    t = torch.arange(T, dtype=xs.dtype, device=xs.device)[:, None].expand(T, B)
    A_all, B_all, lx_all, lu_all = stage_derivatives(spec, x, u, t, discrete)
    hess = [_rows(h[None], 0) for h in (lxx, luu, lux)]

    def stage_inputs(s):
        A = [[A_all[s, :, i, j] for j in range(nx)] for i in range(nx)]
        Bm = [[B_all[s, :, i, j] for j in range(nu)] for i in range(nx)]
        lx = [lx_all[s, :, j] for j in range(nx)]
        lu = [lu_all[s, :, j] for j in range(nu)]
        return (A, Bm, lx, lu, *hess)

    return _backward_recursion(stage_inputs, terminal_derivatives(spec.terminal_cost, xT.T), T,
                               nx, nu, reg_levels, lb, ub, xs.device)


def _check_bounds(lb, ub, T, nu, B, dev):
    if (lb is None) != (ub is None):
        raise ValueError("pass both delta bounds or neither")
    if lb is not None:
        check_tensor(lb, "lb", (T, nu, B), dev)
        check_tensor(ub, "ub", (T, nu, B), dev)


def riccati_fusedlin(spec, xs, us, lxx, luu, lux, xT, reg_levels: tuple, lb=None, ub=None,
                     discrete: bool = True):
    """K1 on the card for CUDA tensors, the plain version for CPU tensors.
    ``reg_levels`` is the ladder of :func:`reg_ladder`; ``lb``/``ub``
    ``[T, nu, B]`` delta bounds select the box-QP gains (K5);
    ``discrete=False`` the continuous Jacobian mode."""
    if xs.device.type == "cpu":
        return riccati_fusedlin_plain(spec, xs, us, lxx, luu, lux, xT, reg_levels, lb, ub,
                                      discrete)
    T, nx, B = xs.shape
    nu = us.shape[1]
    dev = xs.device
    for t, name, shape in ((xs, "xs", (T, nx, B)), (us, "us", (T, nu, B)),
                           (lxx, "lxx", (nx, nx, B)), (luu, "luu", (nu, nu, B)),
                           (lux, "lux", (nu, nx, B)), (xT, "xT", (nx, B))):
        check_tensor(t, name, shape, dev)
    _check_bounds(lb, ub, T, nu, B, dev)
    symbol, (dyn_p, cost_p, term_p) = problem_symbol(
        "riccati_fusedlin", nx, nu, spec.dynamics, spec.stage_cost, spec.terminal_cost)
    k = torch.empty((T, nu, B), dtype=torch.float32, device=dev)
    K = torch.empty((T, nu, nx, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(symbol, xs, us, lxx, luu, lux, lb, ub, xT, k, K, T, B, int(discrete), dyn_p, cost_p,
               term_p, step_constants(spec.dt), tuple(reg_levels), len(reg_levels))
    (STATS if discrete else CONT_STATS).launches += 1
    BOXQP_STATS.launches += int(lb is not None)
    return k, K


def riccati_backward_plain(spec, A, Bm, lx, lu, lxx, luu, lux, xT, reg_levels: tuple,
                           lb=None, ub=None):
    """Plain PyTorch version of the K4 kernel (same layout and outputs);
    Hessian stacks with one stage are read for every stage."""
    BACKWARD_STATS.plain_calls += 1
    T, nx, _, B = A.shape
    nu = Bm.shape[2]
    stacks = (A, Bm, lx, lu, lxx, luu, lux)
    return _backward_recursion(lambda s: tuple(_rows(a, s) for a in stacks),
                               terminal_derivatives(spec.terminal_cost, xT.T), T, nx, nu,
                               reg_levels, lb, ub, A.device)


def riccati_backward(spec, A, Bm, lx, lu, lxx, luu, lux, xT, reg_levels: tuple,
                     lb=None, ub=None):
    """K4 on the card for CUDA tensors, the plain version for CPU tensors.

    The Hessian stacks carry ``T`` stages or one (``hess_tconst``: the
    kernel reads that block once); ``lb``/``ub`` ``[T, nu, B]`` delta
    bounds select the box-QP gains (K5).  K4 evaluates only the terminal
    cost, so its instantiation is named by the dynamics (which fix nx, nu)
    and the terminal cost.
    """
    if A.device.type == "cpu":
        return riccati_backward_plain(spec, A, Bm, lx, lu, lxx, luu, lux, xT, reg_levels, lb, ub)
    T, nx, _, B = A.shape
    nu = Bm.shape[2]
    dev = A.device
    H = lxx.shape[0]
    if H not in (1, T):
        raise ValueError(f"Hessian stacks carry {H} stages, expected 1 or {T}")
    for t, name, shape in ((A, "A", (T, nx, nx, B)), (Bm, "Bm", (T, nx, nu, B)),
                           (lx, "lx", (T, nx, B)), (lu, "lu", (T, nu, B)),
                           (lxx, "lxx", (H, nx, nx, B)), (luu, "luu", (H, nu, nu, B)),
                           (lux, "lux", (H, nu, nx, B)), (xT, "xT", (nx, B))):
        check_tensor(t, name, shape, dev)
    _check_bounds(lb, ub, T, nu, B, dev)
    symbol, (_, term_p) = problem_symbol(
        "riccati_backward", nx, nu, spec.dynamics, spec.terminal_cost)
    k = torch.empty((T, nu, B), dtype=torch.float32, device=dev)
    K = torch.empty((T, nu, nx, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(symbol, A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT, k, K, T, B, int(H == 1), term_p,
               tuple(reg_levels), len(reg_levels))
    BACKWARD_STATS.launches += 1
    BOXQP_STATS.launches += int(lb is not None)
    return k, K


def riccati_backward_explicit_plain(A, Bm, lx, lu, lxx, luu, lux, vx0, vxx0, reg_levels: tuple,
                                    lb=None, ub=None):
    """Plain PyTorch version of K4's explicit-terminal mode (same layout and
    outputs as :func:`riccati_backward_explicit`)."""
    EXPLICIT_STATS.plain_calls += 1
    T, nx, _, B = A.shape
    nu = Bm.shape[2]
    stacks = (A, Bm, lx, lu, lxx, luu, lux)
    value = (_rows(vx0[None], 0), _rows(vxx0[None], 0))
    return _backward_recursion(lambda s: tuple(_rows(a, s) for a in stacks), value, T, nx, nu,
                               reg_levels, lb, ub, A.device)


def riccati_backward_explicit(A, Bm, lx, lu, lxx, luu, lux, vx0, vxx0, reg_levels: tuple,
                              lb=None, ub=None):
    """K4's explicit-terminal mode on the card for CUDA tensors, the plain
    version for CPU tensors: the stage recursion on ``[T, ..., B]`` stacks
    (per-stage Hessians) from the given terminal value ``vx0 [nx, B]``,
    ``vxx0 [nx, nx, B]``; ``lb``/``ub`` ``[T, nu, B]`` delta bounds select
    the box-QP gains (K5).  It runs no user function, so it is instantiated
    per ``(nx, nu)`` (:data:`EXPLICIT_DIMS`)."""
    if A.device.type == "cpu":
        return riccati_backward_explicit_plain(A, Bm, lx, lu, lxx, luu, lux, vx0, vxx0,
                                               reg_levels, lb, ub)
    return launch_riccati_explicit(A, Bm, lx, lu, lxx, luu, lux, vx0, vxx0, reg_levels, lb, ub)


def launch_riccati_explicit(A, Bm, lx, lu, lxx, luu, lux, vx0, vxx0, reg_levels: tuple,
                            lb=None, ub=None):
    """The CUDA launch of K4's explicit-terminal mode."""
    T, nx, _, B = A.shape
    nu = Bm.shape[2]
    dev = A.device
    if (nx, nu) not in EXPLICIT_DIMS:
        raise NotImplementedError(
            f"K4's explicit-terminal mode has no instantiation for (nx, nu) = {(nx, nu)} "
            f"(csrc/riccati_explicit*.cu has {EXPLICIT_DIMS}; ROADMAP: queue 1, model zoo "
            "and derivative oracles)")
    for t, name, shape in ((A, "A", (T, nx, nx, B)), (Bm, "Bm", (T, nx, nu, B)),
                           (lx, "lx", (T, nx, B)), (lu, "lu", (T, nu, B)),
                           (lxx, "lxx", (T, nx, nx, B)), (luu, "luu", (T, nu, nu, B)),
                           (lux, "lux", (T, nu, nx, B)), (vx0, "vx0", (nx, B)),
                           (vxx0, "vxx0", (nx, nx, B))):
        check_tensor(t, name, shape, dev)
    _check_bounds(lb, ub, T, nu, B, dev)
    k = torch.empty((T, nu, B), dtype=torch.float32, device=dev)
    K = torch.empty((T, nu, nx, B), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        launch(f"mas_riccati_explicit__{nx}x{nu}", A, Bm, lx, lu, lxx, luu, lux, lb, ub, vx0,
               vxx0, k, K, T, B, tuple(reg_levels), len(reg_levels))
    EXPLICIT_STATS.launches += 1
    BOXQP_STATS.launches += int(lb is not None)
    return k, K


def riccati_backward_pallas(A, Bm, lx, lu, lxx, luu, lux, vx0, vxx0, reg_init: float = 1e-6,
                            reg_factor: float = 10.0, reg_levels: int = 16, lb=None, ub=None,
                            explicit=None):
    """Batched Riccati backward pass on batch-first stacks (the JAX
    package's ``riccati_backward_pallas``): ``A [B, T, nx, nx]``,
    ``Bm [B, T, nx, nu]``, ``lx [B, T, nx]``, ``lu [B, T, nu]``, Hessians
    ``[B, T, ...]``, the terminal value ``vx0 [B, nx]``, ``vxx0 [B, nx, nx]``
    and optional delta bounds ``lb``/``ub`` ``[B, T, nu]``; returns float32
    ``k [B, T, nu]``, ``K [B, T, nu, nx]``.  The stacks are converted once
    to ``[T, ..., B]`` and the gains back.  ``explicit`` is the
    explicit-mode function (None: :func:`riccati_backward_explicit`;
    :func:`riccati_backward_explicit_plain` runs the plain version on any
    device)."""
    explicit = riccati_backward_explicit if explicit is None else explicit
    levels = reg_ladder(reg_init, reg_factor, reg_levels)
    bounds = (stage_major(lb), stage_major(ub)) if lb is not None else (None, None)
    k, K = explicit(
        *(stage_major(a) for a in (A, Bm, lx, lu, lxx, luu, lux, vx0, vxx0)), levels, *bounds)
    return k.movedim(-1, 0), K.movedim(-1, 0)
