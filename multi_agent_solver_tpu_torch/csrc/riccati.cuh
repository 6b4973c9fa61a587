// The iLQR backward Riccati passes: K1 (in-kernel linearization, stationary
// quadratic cost), K4 (precomputed stacks) and the box-QP stage solve K5
// that both run under bound_mode="boxqp".
//
// K1 replaces multi_agent_solver_tpu/ops/riccati_pallas.py ::
// riccati_fusedlin_pallas_tiled (kernel _make_fusedlin_kernel, helpers
// _stage_core, _gauss_jordan_solve, _det_rect, _terminal_into_scratch).
// K4 replaces riccati_backward_pallas_tiled (kernel _make_kernel) in its
// fused-loop mode (terminal function in the kernel) and in its
// explicit-terminal mode (terminal_fn=None: the kernel reads vx0 / vxx0,
// the mode of riccati_backward_pallas), K5 _boxqp_lane_gains.
//
// What K1 computes, per problem b: phi_x / phi_xx of the terminal cost at
// x_T (second-order duals, upper triangle mirrored), then for t = T-1 .. 0
//   A, B  = d step(x_t, u_t) / d(x, u) through RK4 (DISCRETE; otherwise
//           the Jacobians of the continuous dynamics f(x_t, u_t), the
//           reference's "continuous" mode), lx, lu = d l / d(x, u)
//   Q-terms from the value function (v_x, v_xx),
//   the smallest of the cumulative regularization levels whose shifted
//   q_uu passes Sylvester's test, Gauss-Jordan without pivoting for
//   [k | K] = -q_uu_reg^-1 [q_u | q_ux], and the value recursion with a
//   symmetrized v_xx.
// The time-constant cost Hessians lxx / luu / lux are read once.
//
// Layout: batch innermost.  x [T, NX, B], u [T, NU, B], lxx [NX, NX, B],
// luu [NU, NU, B], lux [NU, NX, B], xT [NX, B] in; k [T, NU, B],
// K [T, NU, NX, B] out.  Neighbouring threads read neighbouring addresses.
//
// What limits it on the H100: not the bytes (it reads x, u and writes k,
// K: (T (NX + NU) + T NU (1 + NX)) 4 bytes a problem) but the instructions
// issued for the arithmetic of a sequential recursion -- per stage a dual
// RK4 step and the small dense algebra.  Design: one thread per problem,
// the whole recursion in registers (the TPU kernel's VMEM scratch carry
// becomes v_x / v_xx registers), the t loop inside the thread (the TPU's
// sequential grid axis).  The linearization (stage_derivatives_live) seeds
// tangents only for the state components the dynamics read and the
// controls (4 of 6 at the single track: psi, v, delta, a), writes the
// other columns of A exactly, takes sin and cos of psi by one sincosf an
// evaluation and tan(delta) once a step (5 accurate calls a stage), and
// gives K3's A, B, lx, lu bit for bit.  It does not depend on the carry,
// so the compiler can overlap it with the previous stage's algebra.
//
// K4 runs the same stage recursion on A [T, NX, NX, B], B [T, NX, NU, B],
// lx [T, NX, B], lu [T, NU, B] and cost Hessians lxx [H, NX, NX, B],
// luu [H, NU, NU, B], lux [H, NU, NX, B] with H = T (per stage) or H = 1
// (hess_tconst: read once), x_T [NX, B] for the in-kernel terminal value
// -- or, in the explicit-terminal mode (H = T), the given value
// v_x0 [NX, B], v_xx0 [NX, NX, B] -- and under boxqp the delta bounds
// lb / ub [T, NU, B]; k [T, NU, B], K [T, NU, NX, B] out.  The explicit
// mode runs no user function, so it is instantiated per (NX, NU) alone
// (riccati_explicit*.cu); Sylvester's test and Gauss-Jordan are written
// for any NU, the box QP for NU <= 4 (81 configurations).  It is bound by bytes: at NX = 4, NU = 2 it reads
// 68 floats a stage and problem (40 with hess_tconst) and writes 10, with
// no derivative arithmetic.  Design: one thread per problem, the t loop
// inside the thread from T-1 down to 0, (v_x, v_xx) in registers,
// coalesced batch-innermost loads -- above backward_group_max_b problems;
// smaller launches, which that leaves latency-bound on a few SMs, run
// riccati_backward_group_kernel (a group of lanes a problem, below).
//
// K5 (boxqp_gains) replaces the unconstrained gain solve of a stage: the
// 3^NU free / at-lower / at-upper configurations are enumerated at compile
// time in itertools.product order, each free subsystem solved with the
// same Gauss-Jordan, and the first configuration whose KKT conditions hold
// (exact comparisons, in _boxqp_lane_gains' order) is taken; clamped rows
// get zero feedback, and the clipped Newton step is the fallback.
#pragma once

#include <cuda_runtime.h>

#include "problems.cuh"

namespace mas {

constexpr int MAX_REG_LEVELS = 32;
struct RegLevels {
  float v[MAX_REG_LEVELS];
  int n;
};

// Determinant of the K x K block of Q on rows R0 .. R0 + K - 1 and the
// columns in the bit set `cols` (ascending), expanded along its first row
// exactly as riccati_pallas._det_rect does: the first term, then the
// others added and subtracted in turn.
template <int N, int K>
struct DetRect {
  static __device__ __forceinline__ float eval(const float (&Q)[N][N], int r0, unsigned cols) {
    float total = 0.0f;
    int pos = 0;
#pragma unroll
    for (int c = 0; c < N; ++c) {
      if (!(cols & (1u << c))) continue;
      const float term = Q[r0][c] * DetRect<N, K - 1>::eval(Q, r0 + 1, cols & ~(1u << c));
      if (pos == 0)
        total = term;
      else if (pos % 2 == 0)
        total = total + term;
      else
        total = total - term;
      ++pos;
    }
    return total;
  }
};

template <int N>
struct DetRect<N, 1> {
  static __device__ __forceinline__ float eval(const float (&Q)[N][N], int r0, unsigned cols) {
    float v = 0.0f;
#pragma unroll
    for (int c = 0; c < N; ++c)
      if (cols & (1u << c)) v = Q[r0][c];
    return v;
  }
};

// Sylvester's test of q + shift I: every leading minor, from the 1 x 1
// block up, > 0.  EAGER computes every minor (no short circuit, so no
// branch; the same verdict).
template <int NU, bool EAGER, int K = 2>
__device__ __forceinline__ bool minors_from(const float (&Q)[NU][NU], bool ok) {
  if constexpr (K > NU) {
    return ok;
  } else {
    if constexpr (EAGER)
      return minors_from<NU, EAGER, K + 1>(
          Q, ok & (DetRect<NU, K>::eval(Q, 0, (1u << K) - 1u) > 0.0f));
    else
      return minors_from<NU, EAGER, K + 1>(
          Q, ok && (DetRect<NU, K>::eval(Q, 0, (1u << K) - 1u) > 0.0f));
  }
}

template <int NU, bool EAGER = false>
__device__ __forceinline__ bool sylvester_ok(const float (&q)[NU][NU], float shift) {
  float Q[NU][NU];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) Q[i][j] = q[i][j] + (i == j ? shift : 0.0f);
  return minors_from<NU, EAGER>(Q, Q[0][0] > 0.0f);
}

// Solve Q X = rhs by Gauss-Jordan without pivoting (Q is SPD after
// regularization), in riccati_pallas._gauss_jordan_solve's order.
template <int N, int M>
__device__ __forceinline__ void gauss_jordan(float (&A)[N][N], float (&X)[N][M]) {
#pragma unroll
  for (int col = 0; col < N; ++col) {
    const float inv_piv = 1.0f / A[col][col];
#pragma unroll
    for (int j = col; j < N; ++j) A[col][j] = A[col][j] * inv_piv;
#pragma unroll
    for (int j = 0; j < M; ++j) X[col][j] = X[col][j] * inv_piv;
#pragma unroll
    for (int row = 0; row < N; ++row) {
      if (row == col) continue;
      const float factor = A[row][col];
#pragma unroll
      for (int j = col; j < N; ++j) A[row][j] = A[row][j] - factor * A[col][j];
#pragma unroll
      for (int j = 0; j < M; ++j) X[row][j] = X[row][j] - factor * X[col][j];
    }
  }
}

// K5: the box-QP stage solve.  Configuration c gives dimension i the side
// box_side(c, i) -- dimension 0 is the slowest digit, as in
// itertools.product((FREE, AT_LB, AT_UB), repeat=NU).
enum : int { FREE = 0, AT_LB = 1, AT_UB = 2 };

__host__ __device__ constexpr int pow3(int n) { return n == 0 ? 1 : 3 * pow3(n - 1); }

template <int NU>
__host__ __device__ constexpr int box_side(int c, int i) { return (c / pow3(NU - 1 - i)) % 3; }

template <int NU>
__host__ __device__ constexpr int box_n_free(int c) {
  int n = 0;
  for (int i = 0; i < NU; ++i) n += box_side<NU>(c, i) == FREE ? 1 : 0;
  return n;
}

// The dimension of the p-th free variable of configuration c.
template <int NU>
__host__ __device__ constexpr int box_free_dim(int c, int p) {
  for (int i = 0; i < NU; ++i) {
    if (box_side<NU>(c, i) == FREE) {
      if (p == 0) return i;
      --p;
    }
  }
  return 0;
}

// Configurations C .. 3^NU - 1, in order: solve the free subsystem, test
// the KKT conditions, take the first that holds.
template <int NX, int NU, int C>
__device__ __forceinline__ void boxqp_configs(
    const float (&Q)[NU][NU], const float (&q_u)[NU], const float (&q_ux)[NU][NX],
    const float (&lb)[NU], const float (&ub)[NU], float zeros, bool base_ok, bool& found,
    float (&k)[NU], float (&K)[NU][NX]) {
  if constexpr (C < pow3(NU)) {
    constexpr int NF = box_n_free<NU>(C);
    float v[NU], du[NU], Kc[NU][NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int side = box_side<NU>(C, i);
      v[i] = side == AT_LB ? lb[i] : (side == AT_UB ? ub[i] : zeros);
      du[i] = v[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) Kc[i][j] = zeros;
    }
    if constexpr (NF > 0) {
      float S[NF][NF], X[NF][NX + 1];
#pragma unroll
      for (int p = 0; p < NF; ++p) {
        const int i = box_free_dim<NU>(C, p);
#pragma unroll
        for (int q = 0; q < NF; ++q) S[p][q] = Q[i][box_free_dim<NU>(C, q)];
        float s = 0.0f;
#pragma unroll
        for (int c = 0; c < NU; ++c)
          if (box_side<NU>(C, c) != FREE) s = s + Q[i][c] * v[c];
        X[p][0] = q_u[i] + s;
#pragma unroll
        for (int j = 0; j < NX; ++j) X[p][1 + j] = q_ux[i][j];
      }
      gauss_jordan<NF, NX + 1>(S, X);
#pragma unroll
      for (int p = 0; p < NF; ++p) {
        const int i = box_free_dim<NU>(C, p);
        du[i] = -X[p][0];
#pragma unroll
        for (int j = 0; j < NX; ++j) Kc[i][j] = -X[p][1 + j];
      }
    }
    bool ok = base_ok;
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < NU; ++j) s = s + Q[i][j] * du[j];
      const float grad = q_u[i] + s;
      const int side = box_side<NU>(C, i);
      if (side == FREE)
        ok = ok && (du[i] >= lb[i] && du[i] <= ub[i]);
      else if (side == AT_LB)
        ok = ok && (grad >= 0.0f);
      else
        ok = ok && (grad <= 0.0f);
    }
    if (ok && !found) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        k[i] = du[i];
#pragma unroll
        for (int j = 0; j < NX; ++j) K[i][j] = Kc[i][j];
      }
    }
    found = found || ok;
    boxqp_configs<NX, NU, C + 1>(Q, q_u, q_ux, lb, ub, zeros, base_ok, found, k, K);
  }
}

// Exact box-constrained gains for the regularized q_uu (Q), with the
// unconstrained Newton step clipped to the box (full feedback) where no
// configuration passes.  zeros = 0 q_u[0] as in the TPU kernel, so a
// non-finite q_u takes the fallback there and here alike.
template <int NX, int NU>
__device__ __forceinline__ void boxqp_gains(
    const float (&Q)[NU][NU], const float (&q_u)[NU], const float (&q_ux)[NU][NX],
    const float (&lb)[NU], const float (&ub)[NU], float (&k)[NU], float (&K)[NU][NX]) {
  const float zeros = 0.0f * q_u[0];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    k[i] = zeros;
#pragma unroll
    for (int j = 0; j < NX; ++j) K[i][j] = zeros;
  }
  bool found = zeros > 1.0f;
  boxqp_configs<NX, NU, 0>(Q, q_u, q_ux, lb, ub, zeros, zeros <= 0.0f, found, k, K);

  float Qc[NU][NU], X[NU][NX + 1];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) Qc[i][j] = Q[i][j];
    X[i][0] = q_u[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) X[i][1 + j] = q_ux[i][j];
  }
  gauss_jordan<NU, NX + 1>(Qc, X);
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    if (!found) k[i] = clamp_nan(-X[i][0], lb[i], ub[i]);
#pragma unroll
    for (int j = 0; j < NX; ++j)
      if (!found) K[i][j] = -X[i][1 + j];
  }
}

// The regularization level of a stage: the smallest cumulative level
// whose shifted q_uu passes Sylvester's test (the largest level when none
// does), a level at a time with an early exit.  Where a launch fills the
// card, testing every level without a branch, as ladder_level_group does,
// measured slower (kernel_times.py, 262,144 problems, T = 80, NVIDIA H100
// 80GB HBM3, 700 W: K1 2.29 -> 2.52 ms, K4 explicit 2.08 -> 2.16).
template <int NU>
__device__ __forceinline__ float ladder_level(const float (&q_uu)[NU][NU], const RegLevels& reg) {
  float best = reg.v[reg.n - 1];
  for (int j = 0; j < reg.n; ++j) {
    if (sylvester_ok<NU>(q_uu, reg.v[j])) {
      best = reg.v[j];
      break;
    }
  }
  return best;
}

// A stage's gains from its Q-terms at the regularization level `best`:
// [k | K] = -q_uu_reg^-1 [q_u | q_ux] by Gauss-Jordan, or K5's box-QP gains
// under BOXQP with the delta bounds lb / ub.
template <int NX, int NU, bool BOXQP>
__device__ __forceinline__ void stage_gains(const float (&q_uu)[NU][NU], const float (&q_u)[NU],
                                            const float (&q_ux)[NU][NX], const float (&lb)[NU],
                                            const float (&ub)[NU], float best, float (&k)[NU],
                                            float (&K)[NU][NX]) {
  float Qr[NU][NU];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) Qr[i][j] = q_uu[i][j] + (i == j ? best : 0.0f);
  if constexpr (BOXQP) {
    boxqp_gains<NX, NU>(Qr, q_u, q_ux, lb, ub, k, K);
  } else {
    float X[NU][NX + 1];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      X[i][0] = q_u[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) X[i][1 + j] = q_ux[i][j];
    }
    gauss_jordan<NU, NX + 1>(Qr, X);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      k[i] = -X[i][0];
#pragma unroll
      for (int j = 0; j < NX; ++j) K[i][j] = -X[i][1 + j];
    }
  }
}

// One Riccati stage (riccati_pallas._stage_core): updates (vx, vxx) in
// place to the new symmetrized value function.  BOXQP takes the gains
// from K5 with the stage's delta bounds lb / ub (unused otherwise).
template <int NX, int NU, bool BOXQP>
__device__ __forceinline__ void stage_core(
    const float (&A)[NX][NX], const float (&Bm)[NX][NU], const float (&lx)[NX],
    const float (&lu)[NU], const float (&lxx)[NX][NX], const float (&luu)[NU][NU],
    const float (&lux)[NU][NX], const float (&lb)[NU], const float (&ub)[NU],
    float (&vx)[NX], float (&vxx)[NX][NX], const RegLevels& reg, float (&k)[NU],
    float (&K)[NU][NX]) {
  float q_x[NX], q_u[NU], q_xx[NX][NX], q_ux[NU][NX], q_uu[NU][NU];
  float vA[NX][NX], vB[NX][NU];
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    float s = A[0][j] * vx[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) s = s + A[i][j] * vx[i];
    q_x[j] = lx[j] + s;
  }
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    float s = Bm[0][j] * vx[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) s = s + Bm[i][j] * vx[i];
    q_u[j] = lu[j] + s;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = vxx[i][0] * A[0][j];
#pragma unroll
      for (int kk = 1; kk < NX; ++kk) s = s + vxx[i][kk] * A[kk][j];
      vA[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = A[0][i] * vA[0][j];
#pragma unroll
      for (int kk = 1; kk < NX; ++kk) s = s + A[kk][i] * vA[kk][j];
      q_xx[i][j] = lxx[i][j] + s;
    }
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = Bm[0][i] * vA[0][j];
#pragma unroll
      for (int kk = 1; kk < NX; ++kk) s = s + Bm[kk][i] * vA[kk][j];
      q_ux[i][j] = lux[i][j] + s;
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float s = vxx[i][0] * Bm[0][j];
#pragma unroll
      for (int kk = 1; kk < NX; ++kk) s = s + vxx[i][kk] * Bm[kk][j];
      vB[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float s = Bm[0][i] * vB[0][j];
#pragma unroll
      for (int kk = 1; kk < NX; ++kk) s = s + Bm[kk][i] * vB[kk][j];
      q_uu[i][j] = luu[i][j] + s;
    }

  stage_gains<NX, NU, BOXQP>(q_uu, q_u, q_ux, lb, ub, ladder_level<NU>(q_uu, reg), k, K);

  // Value recursion with the unregularized q_uu.
  float q_uu_k[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = q_uu[i][0] * k[0];
#pragma unroll
    for (int j = 1; j < NU; ++j) s = s + q_uu[i][j] * k[j];
    q_uu_k[i] = s;
  }
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    float s1 = K[0][j] * q_u[0], s2 = q_ux[0][j] * k[0], s3 = K[0][j] * q_uu_k[0];
#pragma unroll
    for (int u = 1; u < NU; ++u) {
      s1 = s1 + K[u][j] * q_u[u];
      s2 = s2 + q_ux[u][j] * k[u];
      s3 = s3 + K[u][j] * q_uu_k[u];
    }
    vx[j] = ((q_x[j] + s1) + s2) + s3;
  }
  float KQ[NX][NX], nv[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float s = K[0][i] * q_ux[0][j];
#pragma unroll
      for (int u = 1; u < NU; ++u) s = s + K[u][i] * q_ux[u][j];
      KQ[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float kqk = 0.0f;
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        float s = q_uu[u][0] * K[0][j];
#pragma unroll
        for (int v = 1; v < NU; ++v) s = s + q_uu[u][v] * K[v][j];
        kqk = (u == 0) ? K[u][i] * s : kqk + K[u][i] * s;
      }
      nv[i][j] = ((q_xx[i][j] + KQ[i][j]) + KQ[j][i]) + kqk;
    }
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) vxx[i][j] = 0.5f * (nv[i][j] + nv[j][i]);
}

// Cost Hessians of stage t from [H, NX, NX, B] / [H, NU, NU, B] /
// [H, NU, NX, B] stacks.
template <int NX, int NU>
__device__ __forceinline__ void load_hessians(
    const float* __restrict__ lxx_in, const float* __restrict__ luu_in,
    const float* __restrict__ lux_in, size_t t, int b, size_t sB, float (&lxx)[NX][NX],
    float (&luu)[NU][NU], float (&lux)[NU][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) lxx[i][j] = lxx_in[((t * NX + i) * NX + j) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) luu[i][j] = luu_in[((t * NU + i) * NU + j) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) lux[i][j] = lux_in[((t * NU + i) * NX + j) * sB + b];
}

// Delta bounds of stage t from [T, NU, B] stacks.
template <int NU>
__device__ __forceinline__ void load_bounds(const float* __restrict__ lb_in,
                                            const float* __restrict__ ub_in, size_t t, int b,
                                            size_t sB, float (&lb)[NU], float (&ub)[NU]) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    lb[i] = lb_in[(t * NU + i) * sB + b];
    ub[i] = ub_in[(t * NU + i) * sB + b];
  }
}

// Terminal value function (riccati_pallas._terminal_into_scratch): phi_x,
// and phi_xx from its upper triangle (inner tangent i, outer tangent j),
// mirrored.  Shared by K1 and K4.
// Past HESSIAN_FULL_MAX states, column by column (problems.cuh: seed_col).
template <int NX, typename Term>
__device__ __forceinline__ void terminal_value(const Term& term, const float* __restrict__ xT,
                                               int b, size_t sB, float (&vx)[NX],
                                               float (&vxx)[NX][NX]) {
  if constexpr (NX <= HESSIAN_FULL_MAX) {
    using D2 = Dual<Dual<float, NX>, NX>;
    D2 z[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) z[i] = seed2<NX>(xT[i * sB + b], i);
    const D2 r = term(z);
#pragma unroll
    for (int j = 0; j < NX; ++j) vx[j] = r.v.d[j];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = i; j < NX; ++j) {
        vxx[i][j] = r.d[j].d[i];
        vxx[j][i] = r.d[j].d[i];
      }
  } else {
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xT[i * sB + b];
    static_for<NX>([&](auto j_) {
      constexpr int j = decltype(j_)::value;
      using DC = Dual<Dual<float, NX>, 1>;
      DC z[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) z[i] = seed_col<NX>(x[i], i, j);
      const DC r = term(z);
      if constexpr (j == 0) {
#pragma unroll
        for (int i = 0; i < NX; ++i) vx[i] = r.v.d[i];
      }
#pragma unroll
      for (int i = 0; i <= j; ++i) {
        vxx[i][j] = r.d[0].d[i];
        vxx[j][i] = r.d[0].d[i];
      }
    });
  }
}

// The explicit-terminal mode's initial value (the TPU kernel with
// terminal_fn=None): the given v_x0 [NX, B] and v_xx0 [NX, NX, B].
struct GivenValue {
  static GivenValue from(const float*) { return GivenValue{}; }
};

template <int NX>
__device__ __forceinline__ void initial_value(const GivenValue&, const float* __restrict__ vx0,
                                              const float* __restrict__ vxx0, int b, size_t sB,
                                              float (&vx)[NX], float (&vxx)[NX][NX]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    vx[i] = vx0[i * sB + b];
#pragma unroll
    for (int j = 0; j < NX; ++j) vxx[i][j] = vxx0[(i * NX + j) * sB + b];
  }
}

// The in-kernel terminal mode: the value of the terminal cost at x_T.
template <int NX, typename Term>
__device__ __forceinline__ void initial_value(const Term& term, const float* __restrict__ xT,
                                              const float*, int b, size_t sB, float (&vx)[NX],
                                              float (&vxx)[NX][NX]) {
  terminal_value<NX>(term, xT, b, sB, vx, vxx);
}

template <int NX, int NU>
__device__ __forceinline__ void store_gains(float* __restrict__ k_out, float* __restrict__ K_out,
                                            size_t t, int b, size_t sB, const float (&k)[NU],
                                            const float (&K)[NU][NX]) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    k_out[(t * NU + i) * sB + b] = k[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) K_out[((t * NU + i) * NX + j) * sB + b] = K[i][j];
  }
}

template <typename Dyn, typename Cost, typename Term, bool BOXQP, bool DISCRETE>
__global__ void __launch_bounds__(128) riccati_fusedlin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ lxx_in, const float* __restrict__ luu_in,
    const float* __restrict__ lux_in, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, const float* __restrict__ xT,
    float* __restrict__ k_out, float* __restrict__ K_out, Dyn dyn, Cost cost, Term term,
    Step h, RegLevels reg, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
  load_hessians<NX, NU>(lxx_in, luu_in, lux_in, 0, b, sB, lxx, luu, lux);
  float vx[NX], vxx[NX][NX];
  terminal_value<NX>(term, xT, b, sB, vx, vxx);

  for (int t = T - 1; t >= 0; --t) {
    const size_t st = static_cast<size_t>(t);
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xs[(st * NX + i) * sB + b];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = us[(st * NU + i) * sB + b];
    float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
    // The absolute stage t, as the float the TPU kernel builds (t_lane).
    stage_derivatives_live<DISCRETE>(dyn, cost, h, x, u, A, Bm, lx, lu, static_cast<float>(t));
    float lb[NU], ub[NU];
    if constexpr (BOXQP) load_bounds<NU>(lb_in, ub_in, st, b, sB, lb, ub);
    float k[NU], K[NU][NX];
    stage_core<NX, NU, BOXQP>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, vx, vxx, reg, k, K);
    store_gains<NX, NU>(k_out, K_out, st, b, sB, k, K);
  }
}

// K4: the stage recursion on precomputed stacks.  Term = GivenValue is the
// explicit-terminal mode: xT then carries v_x0 and vxx0 v_xx0; otherwise
// the terminal value is derived in the kernel from x_T (vxx0 unused).
template <typename Term, int NX, int NU, bool BOXQP, bool HCONST>
__global__ void __launch_bounds__(128) riccati_backward_kernel(
    const float* __restrict__ A_in, const float* __restrict__ B_in,
    const float* __restrict__ lx_in, const float* __restrict__ lu_in,
    const float* __restrict__ lxx_in, const float* __restrict__ luu_in,
    const float* __restrict__ lux_in, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, const float* __restrict__ xT,
    const float* __restrict__ vxx0, float* __restrict__ k_out, float* __restrict__ K_out,
    Term term, RegLevels reg, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
  if constexpr (HCONST) load_hessians<NX, NU>(lxx_in, luu_in, lux_in, 0, b, sB, lxx, luu, lux);
  float vx[NX], vxx[NX][NX];
  initial_value<NX>(term, xT, vxx0, b, sB, vx, vxx);

  for (int t = T - 1; t >= 0; --t) {
    const size_t st = static_cast<size_t>(t);
    float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i][j] = A_in[((st * NX + i) * NX + j) * sB + b];
#pragma unroll
      for (int j = 0; j < NU; ++j) Bm[i][j] = B_in[((st * NX + i) * NU + j) * sB + b];
      lx[i] = lx_in[(st * NX + i) * sB + b];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) lu[i] = lu_in[(st * NU + i) * sB + b];
    if constexpr (!HCONST) load_hessians<NX, NU>(lxx_in, luu_in, lux_in, st, b, sB, lxx, luu, lux);
    float lb[NU], ub[NU];
    if constexpr (BOXQP) load_bounds<NU>(lb_in, ub_in, st, b, sB, lb, ub);
    float k[NU], K[NU][NX];
    stage_core<NX, NU, BOXQP>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, vx, vxx, reg, k, K);
    store_gains<NX, NU>(k_out, K_out, st, b, sB, k, K);
  }
}

// K4 for launches too small to fill the card (the games' 64 to 1,024 cars
// at T = 10): a group of G lanes a problem (G: NX rounded up to a power of
// two), 32-thread blocks, so that 64 problems spread over 16 SMs instead
// of sitting in one block of the one-thread kernel.  There the one-thread
// kernel's time is the length of one thread's chain -- each stage's ~820
// operations in a row, after loads of the stage's inputs that nothing
// overlaps -- and not its bytes (it reaches < 1% of its byte bound).  The
// group shortens both:
// * lane j owns column j of the NX x NX and NU x NX products (vA, q_xx,
//   q_ux; q_x and the new v_x's element j; nv through KQ and K^T q_uu K),
//   each element summed in the one-thread kernel's order;
// * every lane computes q_u, vB, q_uu and the gains (Gauss-Jordan or K5)
//   whole, in the same order, from the full q_ux that the group exchanges
//   by shuffles, and holds the carry (v_x, v_xx) whole: the group's columns
//   of the new v_x and nv are shuffled to every lane, which symmetrizes
//   v_xx as the one-thread kernel does;
// * the lanes test the regularization levels side by side and take the
//   smallest that passes (ladder_level_group): the one-thread kernel's
//   search, a level at a time with an early exit, took about half of a
//   stage's time here;
// * the next stage's inputs, which do not depend on the carry, are loaded
//   while the current stage computes, each lane a share, into registers,
//   and staged in the group's shared-memory tile at the top of the stage;
// * lane j writes K's column j and, where j < NU, k_j.
// So the outputs are the one-thread kernel's bit for bit.  A problem costs
// about twice the one-thread kernel's instructions (far more with the
// box QP at NU = 4, which every lane runs whole), so where a launch of one
// thread a problem fills the card that kernel is faster:
// launch_backward_one picks by the launch's size (backward_group_max_b).
constexpr int BACKWARD_GROUP_BLOCK = 32;

__host__ __device__ constexpr int backward_group_lanes(int nx) {
  return nx <= 1 ? 1 : nx <= 2 ? 2 : nx <= 4 ? 4 : nx <= 8 ? 8 : nx <= 16 ? 16 : 32;
}

// Where a stage's inputs sit in a group's tile: the stage's stacks (A, B,
// lx, lu, the delta bounds under BOXQP), then the Hessians (written every
// stage, or once under hess_tconst).  STRIDE: the tile's floats rounded up
// to whole rows of banks, plus G, so that the groups of a warp sit G banks
// apart and the warp's reads of one element, or of G consecutive ones a
// group, hit distinct banks.
template <int NX, int NU, bool BOXQP, int G>
struct BackwardTile {
  static constexpr int A = 0, BM = A + NX * NX, LX = BM + NX * NU, LU = LX + NX,
                       LB = LU + NU, UB = LB + (BOXQP ? NU : 0), LXX = UB + (BOXQP ? NU : 0),
                       LUU = LXX + NX * NX, LUX = LUU + NU * NU, SIZE = LUX + NU * NX;
  static constexpr int STRIDE = (SIZE + 31) / 32 * 32 + G;
};

__host__ __device__ constexpr int share_of(int n, int g) { return n > 0 ? (n + g - 1) / g : 1; }

// A lane's share of one stack's stage t: elements a, a + G, ... of its N a
// stage, at tile[e] for element e.
template <int N, int G>
struct Share {
  float v[share_of(N, G)];

  __device__ __forceinline__ void load(const float* __restrict__ src, size_t t, int a, int b,
                                       size_t sB) {
#pragma unroll
    for (int r = 0; r < share_of(N, G); ++r) {
      const int e = a + r * G;
      if (e < N) v[r] = src[(t * N + e) * sB + b];
    }
  }

  __device__ __forceinline__ void store(float* tile, int a) const {
#pragma unroll
    for (int r = 0; r < share_of(N, G); ++r) {
      const int e = a + r * G;
      if (e < N) tile[e] = v[r];
    }
  }
};

template <int NX, int NU, bool BOXQP, int G>
struct StageShare {
  Share<NX * NX, G> A;
  Share<NX * NU, G> Bm;
  Share<NX, G> lx;
  Share<NU, G> lu;
  Share<BOXQP ? NU : 0, G> lb, ub;
};

template <int NX, int NU, int G>
struct HessianShare {
  Share<NX * NX, G> lxx;
  Share<NU * NU, G> luu;
  Share<NU * NX, G> lux;
};

// v[i] for a lane-dependent i, by selects (indexing a register array with
// it would move the array to local memory).
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float r = v[0];
#pragma unroll
  for (int c = 1; c < N; ++c) r = i == c ? v[c] : r;
  return r;
}

// ladder_level for a group of G lanes, which test the levels side by side:
// lane a tests levels a, a + G, ... (lv, its levels, loaded once) and the
// group takes the smallest that passes, by shuffles.  The serial loop's
// early exit costs a dependent chain of ~40 cycles a level, and a warp
// waits for the group that climbs furthest; here the tests are
// independent, and each lane makes at most MAX_REG_LEVELS / G of them.
template <int NU, int G>
__device__ __forceinline__ float ladder_level_group(const float (&q_uu)[NU][NU],
                                                    const float (&lv)[MAX_REG_LEVELS / G],
                                                    const RegLevels& reg, int a, unsigned mask) {
  constexpr int R = MAX_REG_LEVELS / G;
  int first = MAX_REG_LEVELS;
#pragma unroll
  for (int r = R - 1; r >= 0; --r) {
    // Every slot tested, without a branch (no short circuit).
    const bool pass = (a + r * G < reg.n) & sylvester_ok<NU, true>(q_uu, lv[r]);
    first = pass ? a + r * G : first;
  }
#pragma unroll
  for (int o = G / 2; o > 0; o /= 2) {
    const int other = __shfl_xor_sync(mask, first, o, G);
    first = other < first ? other : first;
  }
  // Every lane of the group holds the same `first`: lane first % G sends
  // its level first / G.
  const float v = __shfl_sync(mask, pick<R>(lv, first / G), first % G, G);
  return first < reg.n ? v : reg.v[reg.n - 1];
}

// One stage of the group kernel on the stage's inputs in `tile` (layout L),
// lane j's column: the gains k whole and K's column j (Kj), and (vx, vxx)
// updated in place, whole, in every lane of the group (`mask`).
template <int NX, int NU, bool BOXQP, int G, typename L>
__device__ __forceinline__ void stage_core_group(const float* tile, int a, int j, unsigned mask,
                                                 const RegLevels& reg,
                                                 const float (&lv)[MAX_REG_LEVELS / G],
                                                 float (&vx)[NX], float (&vxx)[NX][NX],
                                                 float (&k)[NU], float (&Kj)[NU]) {
  const float *A = tile + L::A, *Bm = tile + L::BM, *lx = tile + L::LX, *lu = tile + L::LU,
              *lxx = tile + L::LXX, *luu = tile + L::LUU, *lux = tile + L::LUX;
  float s = A[j] * vx[0];
#pragma unroll
  for (int i = 1; i < NX; ++i) s = s + A[i * NX + j] * vx[i];
  const float q_xj = lx[j] + s;
  float q_u[NU];
#pragma unroll
  for (int c = 0; c < NU; ++c) {
    float s = Bm[c] * vx[0];
#pragma unroll
    for (int i = 1; i < NX; ++i) s = s + Bm[i * NU + c] * vx[i];
    q_u[c] = lu[c] + s;
  }
  float vAj[NX], q_xxj[NX], q_uxj[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float s = vxx[i][0] * A[j];
#pragma unroll
    for (int kk = 1; kk < NX; ++kk) s = s + vxx[i][kk] * A[kk * NX + j];
    vAj[i] = s;
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float s = A[i] * vAj[0];
#pragma unroll
    for (int kk = 1; kk < NX; ++kk) s = s + A[kk * NX + i] * vAj[kk];
    q_xxj[i] = lxx[i * NX + j] + s;
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = Bm[i] * vAj[0];
#pragma unroll
    for (int kk = 1; kk < NX; ++kk) s = s + Bm[kk * NU + i] * vAj[kk];
    q_uxj[i] = lux[i * NX + j] + s;
  }
  float vB[NX][NU], q_uu[NU][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float s = vxx[i][0] * Bm[c];
#pragma unroll
      for (int kk = 1; kk < NX; ++kk) s = s + vxx[i][kk] * Bm[kk * NU + c];
      vB[i][c] = s;
    }
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int c = 0; c < NU; ++c) {
      float s = Bm[i] * vB[0][c];
#pragma unroll
      for (int kk = 1; kk < NX; ++kk) s = s + Bm[kk * NU + i] * vB[kk][c];
      q_uu[i][c] = luu[i * NU + c] + s;
    }
  float q_ux[NU][NX];
#pragma unroll
  for (int c = 0; c < NX; ++c)
#pragma unroll
    for (int u = 0; u < NU; ++u) q_ux[u][c] = __shfl_sync(mask, q_uxj[u], c, G);
  float lb[NU], ub[NU];
  if constexpr (BOXQP) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lb[i] = tile[L::LB + i];
      ub[i] = tile[L::UB + i];
    }
  }
  float K[NU][NX];
  stage_gains<NX, NU, BOXQP>(q_uu, q_u, q_ux, lb, ub,
                             ladder_level_group<NU, G>(q_uu, lv, reg, a, mask), k, K);
#pragma unroll
  for (int u = 0; u < NU; ++u) Kj[u] = pick<NX>(K[u], j);

  // Value recursion with the unregularized q_uu: column j of v_x and nv.
  float q_uu_k[NU], q_uu_Kj[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = q_uu[i][0] * k[0], t = q_uu[i][0] * Kj[0];
#pragma unroll
    for (int c = 1; c < NU; ++c) {
      s = s + q_uu[i][c] * k[c];
      t = t + q_uu[i][c] * Kj[c];
    }
    q_uu_k[i] = s;
    q_uu_Kj[i] = t;
  }
  float s1 = Kj[0] * q_u[0], s2 = q_uxj[0] * k[0], s3 = Kj[0] * q_uu_k[0];
#pragma unroll
  for (int u = 1; u < NU; ++u) {
    s1 = s1 + Kj[u] * q_u[u];
    s2 = s2 + q_uxj[u] * k[u];
    s3 = s3 + Kj[u] * q_uu_k[u];
  }
  const float vxj = ((q_xj + s1) + s2) + s3;
  float nvj[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    float kq_ij = K[0][i] * q_uxj[0], kq_ji = Kj[0] * q_ux[0][i], kqk = K[0][i] * q_uu_Kj[0];
#pragma unroll
    for (int u = 1; u < NU; ++u) {
      kq_ij = kq_ij + K[u][i] * q_uxj[u];
      kq_ji = kq_ji + Kj[u] * q_ux[u][i];
      kqk = kqk + K[u][i] * q_uu_Kj[u];
    }
    nvj[i] = ((q_xxj[i] + kq_ij) + kq_ji) + kqk;
  }
#pragma unroll
  for (int c = 0; c < NX; ++c) vx[c] = __shfl_sync(mask, vxj, c, G);
  float nv[NX][NX];
#pragma unroll
  for (int c = 0; c < NX; ++c)
#pragma unroll
    for (int i = 0; i < NX; ++i) nv[i][c] = __shfl_sync(mask, nvj[i], c, G);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int c = 0; c < NX; ++c) vxx[i][c] = 0.5f * (nv[i][c] + nv[c][i]);
}

template <typename Term, int NX, int NU, bool BOXQP, bool HCONST>
__global__ void __launch_bounds__(BACKWARD_GROUP_BLOCK) riccati_backward_group_kernel(
    const float* __restrict__ A_in, const float* __restrict__ B_in,
    const float* __restrict__ lx_in, const float* __restrict__ lu_in,
    const float* __restrict__ lxx_in, const float* __restrict__ luu_in,
    const float* __restrict__ lux_in, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, const float* __restrict__ xT,
    const float* __restrict__ vxx0, float* __restrict__ k_out, float* __restrict__ K_out,
    Term term, RegLevels reg, int T, int B) {
  constexpr int G = backward_group_lanes(NX);
  using L = BackwardTile<NX, NU, BOXQP, G>;
  static_assert(32 % G == 0 && G >= NX, "a group is a power of two within a warp");
  __shared__ float tiles[BACKWARD_GROUP_BLOCK / G][L::STRIDE];
  const int b = blockIdx.x * (BACKWARD_GROUP_BLOCK / G) + threadIdx.x / G;
  if (b >= B) return;  // the whole group leaves: its lanes share b
  const int a = threadIdx.x % G;
  const int j = a < NX ? a : NX - 1;  // lanes past NX repeat the last column, write nothing
  float* tile = tiles[threadIdx.x / G];
  const unsigned mask = group_mask<G>();
  const size_t sB = static_cast<size_t>(B);

  float vx[NX], vxx[NX][NX];
  initial_value<NX>(term, xT, vxx0, b, sB, vx, vxx);
  float lv[MAX_REG_LEVELS / G];  // this lane's regularization levels
#pragma unroll
  for (int r = 0; r < MAX_REG_LEVELS / G; ++r)
    lv[r] = a + r * G < reg.n ? reg.v[a + r * G] : 0.0f;
  StageShare<NX, NU, BOXQP, G> next;
  HessianShare<NX, NU, G> hess;
  // Stage t's share into `next` (and `hess`, the Hessians of stage t, or of
  // the one stage under HCONST).
  const auto load = [&](size_t t) {
    next.A.load(A_in, t, a, b, sB);
    next.Bm.load(B_in, t, a, b, sB);
    next.lx.load(lx_in, t, a, b, sB);
    next.lu.load(lu_in, t, a, b, sB);
    if constexpr (BOXQP) {
      next.lb.load(lb_in, t, a, b, sB);
      next.ub.load(ub_in, t, a, b, sB);
    }
    if (!HCONST || t + 1 == static_cast<size_t>(T)) {
      const size_t th = HCONST ? 0 : t;
      hess.lxx.load(lxx_in, th, a, b, sB);
      hess.luu.load(luu_in, th, a, b, sB);
      hess.lux.load(lux_in, th, a, b, sB);
    }
  };
  if (T > 0) load(static_cast<size_t>(T - 1));

  for (int t = T - 1; t >= 0; --t) {
    const size_t st = static_cast<size_t>(t);
    __syncwarp(mask);  // the group is done with the last stage's tile
    next.A.store(tile + L::A, a);
    next.Bm.store(tile + L::BM, a);
    next.lx.store(tile + L::LX, a);
    next.lu.store(tile + L::LU, a);
    if constexpr (BOXQP) {
      next.lb.store(tile + L::LB, a);
      next.ub.store(tile + L::UB, a);
    }
    if (!HCONST || t == T - 1) {
      hess.lxx.store(tile + L::LXX, a);
      hess.luu.store(tile + L::LUU, a);
      hess.lux.store(tile + L::LUX, a);
    }
    __syncwarp(mask);
    load(t > 0 ? st - 1 : 0);  // in flight while this stage computes (no branch: at t = 0, unused)
    float k[NU], Kj[NU];
    stage_core_group<NX, NU, BOXQP, G, L>(tile, a, j, mask, reg, lv, vx, vxx, k, Kj);
    if (a < NX) {
#pragma unroll
      for (int u = 0; u < NU; ++u) K_out[((st * NU + u) * NX + a) * sB + b] = Kj[u];
    }
    if (a < NU) k_out[(st * NU + a) * sB + b] = pick<NU>(k, a);
  }
}

inline int reg_levels_from(const float* levels, int n_levels, RegLevels& reg) {
  if (n_levels < 1 || n_levels > MAX_REG_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  reg.n = n_levels;
  for (int j = 0; j < n_levels; ++j) reg.v[j] = levels[j];
  return 0;
}

constexpr int BLOCK = 128;

// lb == nullptr: clamp mode; else boxqp with delta bounds lb / ub [T, NU, B].
// BOXQP_MODES false instantiates the clamp mode alone (a model without
// input bounds never runs K5, whose box QP at NU = 4 is the costliest part
// of a build): a boxqp launch then returns cudaErrorNotSupported, which the
// wrappers raise as NotImplementedError.
template <typename Dyn, typename Cost, typename Term, bool BOXQP_MODES = true>
int launch_riccati_fusedlin(const float* xs, const float* us, const float* lxx,
                            const float* luu, const float* lux, const float* lb,
                            const float* ub, const float* xT, float* k, float* K, int T, int B,
                            int discrete, const float* dyn_p, const float* cost_p,
                            const float* term_p, const float* step_p, const float* levels,
                            int n_levels, cudaStream_t stream) {
  RegLevels reg;
  if (const int err = reg_levels_from(levels, n_levels, reg)) return err;
  const int grid = (B + BLOCK - 1) / BLOCK;
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Term term = Term::from(term_p);
  const Step h = Step::from(step_p);
#define MAS_FUSEDLIN(BOX, DISC)                                                      \
  riccati_fusedlin_kernel<Dyn, Cost, Term, BOX, DISC><<<grid, BLOCK, 0, stream>>>( \
      xs, us, lxx, luu, lux, lb, ub, xT, k, K, dyn, cost, term, h, reg, T, B)
  if (lb != nullptr) {
    if constexpr (!BOXQP_MODES)
      return static_cast<int>(cudaErrorNotSupported);
    else if (discrete)
      MAS_FUSEDLIN(true, true);
    else
      MAS_FUSEDLIN(true, false);
  } else if (discrete)
    MAS_FUSEDLIN(false, true);
  else
    MAS_FUSEDLIN(false, false);
#undef MAS_FUSEDLIN
  return static_cast<int>(cudaGetLastError());
}

// The largest launch, in problems, that K4 runs on the group kernel (a
// group of lanes a problem) at (NX, NU) in clamp or boxqp mode; larger
// ones run one thread a problem.  Each is the largest batch of
// kernel_times.py's K4 sweep (64 to 65,536 problems, T = 10, device time,
// NVIDIA H100 80GB HBM3, 700 W) at which the group kernel was faster, on
// every stack it times at those dimensions: at (4, 2) the game's stacks
// (group 0.0217 / 0.0422 ms at 16,384 / 32,768 problems against 0.0501 /
// 0.0597) and seeded ones in the explicit mode (clamp 0.0232 / 0.0454
// against 0.0336 / 0.0427).  At (8, 4) with the box QP every lane runs
// the whole 81-configuration solve, and the group kernel is ahead only
// at 64 problems (1.35 against 1.41 ms; 1.43 against 1.42 at 256).
template <int NX, int NU, bool BOXQP>
constexpr int backward_group_max_b() {
  if constexpr (NX <= 2) return 8192;
  else if constexpr (NX <= 4) return 16384;
  else if constexpr (NX <= 6) return BOXQP ? 4096 : 8192;
  else return BOXQP ? 64 : 8192;
}

template <typename Term, int NX, int NU, bool BOXQP, bool HCONST>
void launch_backward_group(const float* A, const float* Bm, const float* lx, const float* lu,
                           const float* lxx, const float* luu, const float* lux,
                           const float* lb, const float* ub, const float* xT,
                           const float* vxx0, float* k, float* K, const Term& term,
                           const RegLevels& reg, int T, int B, cudaStream_t stream) {
  constexpr int per_block = BACKWARD_GROUP_BLOCK / backward_group_lanes(NX);
  const int grid = (B + per_block - 1) / per_block;
  riccati_backward_group_kernel<Term, NX, NU, BOXQP, HCONST>
      <<<grid, BACKWARD_GROUP_BLOCK, 0, stream>>>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT,
                                                  vxx0, k, K, term, reg, T, B);
}

// The group launcher's explicit instantiation (DECL: template) or its
// extern declaration (DECL: extern template), so that a heavy
// instantiation can be compiled in a source of its own, in parallel.
#define MAS_BACKWARD_GROUP(DECL, TERM, NX, NU, BOXQP, HCONST)                                 \
  DECL void mas::launch_backward_group<TERM, NX, NU, BOXQP, HCONST>(                          \
      const float*, const float*, const float*, const float*, const float*, const float*,     \
      const float*, const float*, const float*, const float*, const float*, float*, float*,   \
      const TERM&, const mas::RegLevels&, int, int, cudaStream_t)

template <typename Term, int NX, int NU, bool BOXQP, bool HCONST>
void launch_backward_one(const float* A, const float* Bm, const float* lx, const float* lu,
                         const float* lxx, const float* luu, const float* lux, const float* lb,
                         const float* ub, const float* xT, const float* vxx0, float* k,
                         float* K, const Term& term, const RegLevels& reg, int T, int B,
                         cudaStream_t stream) {
  if (B <= backward_group_max_b<NX, NU, BOXQP>()) {
    launch_backward_group<Term, NX, NU, BOXQP, HCONST>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT,
                                                       vxx0, k, K, term, reg, T, B, stream);
    return;
  }
  const int grid = (B + BLOCK - 1) / BLOCK;
  riccati_backward_kernel<Term, NX, NU, BOXQP, HCONST><<<grid, BLOCK, 0, stream>>>(
      A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT, vxx0, k, K, term, reg, T, B);
}

// The dynamics only fix (NX, NU): K4 evaluates the terminal cost alone.
// lb == nullptr: clamp mode; hess_tconst != 0: Hessian stacks of one stage.
template <typename Dyn, typename Term>
int launch_riccati_backward(const float* A, const float* Bm, const float* lx, const float* lu,
                            const float* lxx, const float* luu, const float* lux,
                            const float* lb, const float* ub, const float* xT, float* k,
                            float* K, int T, int B, int hess_tconst, const float* term_p,
                            const float* levels, int n_levels, cudaStream_t stream) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  RegLevels reg;
  if (const int err = reg_levels_from(levels, n_levels, reg)) return err;
  const Term term = Term::from(term_p);
  const bool box = lb != nullptr;
  if (box && hess_tconst)
    launch_backward_one<Term, NX, NU, true, true>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT,
                                                  nullptr, k, K, term, reg, T, B, stream);
  else if (box)
    launch_backward_one<Term, NX, NU, true, false>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT,
                                                   nullptr, k, K, term, reg, T, B, stream);
  else if (hess_tconst)
    launch_backward_one<Term, NX, NU, false, true>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT,
                                                   nullptr, k, K, term, reg, T, B, stream);
  else
    launch_backward_one<Term, NX, NU, false, false>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT,
                                                    nullptr, k, K, term, reg, T, B, stream);
  return static_cast<int>(cudaGetLastError());
}

// K4's explicit-terminal mode: per-stage Hessian stacks (H = T), the
// initial value v_x0 [NX, B], v_xx0 [NX, NX, B] given.  lb == nullptr: clamp
// mode, else boxqp with delta bounds lb / ub [T, NU, B]; BOXQP_MODES as in
// launch_riccati_fusedlin.
template <int NX, int NU, bool BOXQP_MODES = true>
int launch_riccati_explicit(const float* A, const float* Bm, const float* lx, const float* lu,
                            const float* lxx, const float* luu, const float* lux,
                            const float* lb, const float* ub, const float* vx0,
                            const float* vxx0, float* k, float* K, int T, int B,
                            const float* levels, int n_levels, cudaStream_t stream) {
  RegLevels reg;
  if (const int err = reg_levels_from(levels, n_levels, reg)) return err;
  const GivenValue given{};
  if (lb != nullptr) {
    if constexpr (!BOXQP_MODES)
      return static_cast<int>(cudaErrorNotSupported);
    else
      launch_backward_one<GivenValue, NX, NU, true, false>(A, Bm, lx, lu, lxx, luu, lux, lb,
                                                           ub, vx0, vxx0, k, K, given, reg, T,
                                                           B, stream);
  } else
    launch_backward_one<GivenValue, NX, NU, false, false>(A, Bm, lx, lu, lxx, luu, lux, lb,
                                                          ub, vx0, vxx0, k, K, given, reg, T,
                                                          B, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas
