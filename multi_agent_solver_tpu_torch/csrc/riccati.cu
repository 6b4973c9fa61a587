// K1: the iLQR backward Riccati pass with in-kernel linearization, for a
// stationary quadratic cost.
//
// Replaces multi_agent_solver_tpu/ops/riccati_pallas.py ::
// riccati_fusedlin_pallas_tiled (kernel _make_fusedlin_kernel, helpers
// _stage_core, _gauss_jordan_solve, _det_rect, _terminal_into_scratch).
//
// What it computes, per problem b: phi_x / phi_xx of the terminal cost at
// x_T (second-order duals, upper triangle mirrored), then for t = T-1 .. 0
//   A, B  = d step(x_t, u_t) / d(x, u) through RK4, lx, lu = d l / d(x, u)
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
// What bounds it on the H100: not the bytes (it reads x, u and writes k,
// K: (T (NX + NU) + T NU (1 + NX)) 4 bytes a problem) but the arithmetic
// of a sequential recursion -- per stage a 6-tangent dual RK4 step
// (12 sin/cos/tan) and the small dense algebra.  Design: one thread per
// problem, the whole recursion in registers (the TPU kernel's VMEM scratch
// carry becomes v_x / v_xx registers), the t loop inside the thread (the
// TPU's sequential grid axis), the dual pass giving all NX + NU Jacobian
// columns at once.  The linearization does not depend on the carry, so
// the compiler can overlap it with the previous stage's algebra.
#include <cuda_runtime.h>

#include "problems.cuh"

namespace mas {

constexpr int MAX_REG_LEVELS = 32;
struct RegLevels {
  float v[MAX_REG_LEVELS];
  int n;
};

// Determinant of the leading k x k block of Q (k <= 3), expanded along
// the first row exactly as riccati_pallas._det_rect does.
template <int NU>
__device__ __forceinline__ bool sylvester_ok(const float (&q)[NU][NU], float shift) {
  float Q[NU][NU];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) Q[i][j] = q[i][j] + (i == j ? shift : 0.0f);
  bool ok = Q[0][0] > 0.0f;
  if constexpr (NU >= 2) {
    const float d2 = Q[0][0] * Q[1][1] - Q[0][1] * Q[1][0];
    ok = ok && (d2 > 0.0f);
  }
  if constexpr (NU >= 3) {
    const float m0 = Q[1][1] * Q[2][2] - Q[1][2] * Q[2][1];
    const float m1 = Q[1][0] * Q[2][2] - Q[1][2] * Q[2][0];
    const float m2 = Q[1][0] * Q[2][1] - Q[1][1] * Q[2][0];
    const float d3 = Q[0][0] * m0 - Q[0][1] * m1 + Q[0][2] * m2;
    ok = ok && (d3 > 0.0f);
  }
  static_assert(NU <= 3, "Sylvester test written out for NU <= 3");
  return ok;
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

// One Riccati stage (riccati_pallas._stage_core, clamp mode): updates
// (vx, vxx) in place to the new symmetrized value function.
template <int NX, int NU>
__device__ __forceinline__ void stage_core(
    const float (&A)[NX][NX], const float (&Bm)[NX][NU], const float (&lx)[NX],
    const float (&lu)[NU], const float (&lxx)[NX][NX], const float (&luu)[NU][NU],
    const float (&lux)[NU][NX], float (&vx)[NX], float (&vxx)[NX][NX],
    const RegLevels& reg, float (&k)[NU], float (&K)[NU][NX]) {
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

  // Smallest cumulative level whose shifted q_uu passes Sylvester's test
  // (the largest level when none does).
  float best = reg.v[reg.n - 1];
  for (int j = 0; j < reg.n; ++j) {
    if (sylvester_ok<NU>(q_uu, reg.v[j])) {
      best = reg.v[j];
      break;
    }
  }

  float Qr[NU][NU], X[NU][NX + 1];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
#pragma unroll
    for (int j = 0; j < NU; ++j) Qr[i][j] = q_uu[i][j] + (i == j ? best : 0.0f);
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

template <typename Dyn, typename Cost, typename Term>
__global__ void __launch_bounds__(128) riccati_fusedlin_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    const float* __restrict__ lxx_in, const float* __restrict__ luu_in,
    const float* __restrict__ lux_in, const float* __restrict__ xT,
    float* __restrict__ k_out, float* __restrict__ K_out,
    Dyn dyn, Cost cost, Term term, Step h, RegLevels reg, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);

  float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) lxx[i][j] = lxx_in[(i * NX + j) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) luu[i][j] = luu_in[(i * NU + j) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) lux[i][j] = lux_in[(i * NX + j) * sB + b];

  // Terminal value function: phi_x, and phi_xx from its upper triangle
  // (inner tangent i, outer tangent j), mirrored.
  float vx[NX], vxx[NX][NX];
  {
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
  }

  for (int t = T - 1; t >= 0; --t) {
    float x[NX], u[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xs[(static_cast<size_t>(t) * NX + i) * sB + b];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = us[(static_cast<size_t>(t) * NU + i) * sB + b];
    float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
    stage_derivatives(dyn, cost, h, x, u, A, Bm, lx, lu);
    float k[NU], K[NU][NX];
    stage_core<NX, NU>(A, Bm, lx, lu, lxx, luu, lux, vx, vxx, reg, k, K);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      k_out[(static_cast<size_t>(t) * NU + i) * sB + b] = k[i];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        K_out[((static_cast<size_t>(t) * NU + i) * NX + j) * sB + b] = K[i][j];
    }
  }
}

template <typename Dyn, typename Cost, typename Term>
int launch_riccati_fusedlin(const float* xs, const float* us, const float* lxx,
                            const float* luu, const float* lux, const float* xT,
                            float* k, float* K, int T, int B, const float* dyn_p,
                            const float* cost_p, const float* term_p,
                            const float* step_p, const float* levels, int n_levels,
                            cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_REG_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  RegLevels reg;
  reg.n = n_levels;
  for (int j = 0; j < n_levels; ++j) reg.v[j] = levels[j];
  const int block = 128;
  const int grid = (B + block - 1) / block;
  riccati_fusedlin_kernel<Dyn, Cost, Term><<<grid, block, 0, stream>>>(
      xs, us, lxx, luu, lux, xT, k, K, Dyn::from(dyn_p), Cost::from(cost_p),
      Term::from(term_p), Step::from(step_p), reg, T, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

extern "C" int mas_riccati_fusedlin__single_track__diag_quadratic__zero(
    const float* xs, const float* us, const float* lxx, const float* luu,
    const float* lux, const float* xT, float* k, float* K, int T, int B,
    const float* dyn_p, const float* cost_p, const float* term_p,
    const float* step_p, const float* levels, int n_levels, void* stream) {
  using namespace mas;
  return launch_riccati_fusedlin<SingleTrack, DiagQuadratic<4, 2>, ZeroTerminal>(
      xs, us, lxx, luu, lux, xT, k, K, T, B, dyn_p, cost_p, term_p, step_p,
      levels, n_levels, static_cast<cudaStream_t>(stream));
}
