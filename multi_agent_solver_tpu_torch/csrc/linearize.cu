// K3: whole-horizon linearization, one (problem, stage) per thread.
//
// Replaces multi_agent_solver_tpu/ops/linearize_pallas.py ::
// linearize_pallas_tiled (kernel _make_kernel).
//
// What it computes at every (t, b): A = d step / dx and B = d step / du
// through RK4, the cost gradient lx, lu and, with `hessians`, the cost
// Hessians lxx, luu, lux -- upper triangles from jvp-over-jvp, mirrored,
// exactly as the TPU kernel symmetrizes them.
//
// Layout: batch innermost.  x [T, NX, B], u [T, NU, B] in; A [T, NX, NX, B],
// B [T, NX, NU, B], lx [T, NX, B], lu [T, NU, B], lxx [T, NX, NX, B],
// luu [T, NU, NU, B], lux [T, NU, NX, B] out.
//
// What bounds it on the H100: the output bytes (4 (NX NX + NX NU + NX + NU
// + NX NX + NU NU + NU NX) bytes per stage against 4 (NX + NU) read); the
// duals' arithmetic is small.  Design: the TPU's parallel (b, t) grid
// becomes a flat thread index t * B + b, so a warp reads and writes 32
// neighbouring problems of one stage, coalesced.  One Dual<float, NX+NU>
// pass gives A, B, lx, lu; one Dual<Dual<float, NX+NU>, NX+NU> pass of the
// stage cost gives every Hessian entry.  The main path calls it once, on
// one stage, to hoist the time-constant Hessians of a stationary cost.
#include <cuda_runtime.h>

#include "problems.cuh"

namespace mas {

template <typename Dyn, typename Cost, bool HESSIANS>
__global__ void __launch_bounds__(128) linearize_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ A_out, float* __restrict__ B_out, float* __restrict__ lx_out,
    float* __restrict__ lu_out, float* __restrict__ lxx_out, float* __restrict__ luu_out,
    float* __restrict__ lux_out, Dyn dyn, Cost cost, Step h, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU, NZ = NX + NU;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t sB = static_cast<size_t>(B);
  if (idx >= static_cast<size_t>(T) * sB) return;
  const size_t t = idx / sB, b = idx % sB;

  float x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[(t * NX + i) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = us[(t * NU + i) * sB + b];

  float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
  stage_derivatives(dyn, cost, h, x, u, A, Bm, lx, lu);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) A_out[((t * NX + i) * NX + j) * sB + b] = A[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) B_out[((t * NX + i) * NU + j) * sB + b] = Bm[i][j];
    lx_out[(t * NX + i) * sB + b] = lx[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) lu_out[(t * NU + i) * sB + b] = lu[i];

  if constexpr (HESSIANS) {
    // r.d[q].d[p] = d^2 l / dz_p dz_q, z = (x, u); entry (p, q) with p the
    // inner (gradient) direction and q the outer one, as the TPU kernel's
    // jvp of lgrad_p along e_q.
    using D2 = Dual<Dual<float, NZ>, NZ>;
    D2 xd[NX], ud[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) xd[i] = seed2<NZ>(x[i], i);
#pragma unroll
    for (int i = 0; i < NU; ++i) ud[i] = seed2<NZ>(u[i], NX + i);
    const D2 r = cost(xd, ud);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = i; j < NX; ++j) {
        const float hij = r.d[j].d[i];
        lxx_out[((t * NX + i) * NX + j) * sB + b] = hij;
        lxx_out[((t * NX + j) * NX + i) * sB + b] = hij;
      }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = i; j < NU; ++j) {
        const float hij = r.d[NX + j].d[NX + i];
        luu_out[((t * NU + i) * NU + j) * sB + b] = hij;
        luu_out[((t * NU + j) * NU + i) * sB + b] = hij;
      }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        lux_out[((t * NU + i) * NX + j) * sB + b] = r.d[j].d[NX + i];
  }
}

template <typename Dyn, typename Cost>
int launch_linearize(const float* xs, const float* us, float* A, float* Bm, float* lx,
                     float* lu, float* lxx, float* luu, float* lux, int T, int B,
                     int hessians, const float* dyn_p, const float* cost_p,
                     const float* step_p, cudaStream_t stream) {
  const int block = 128;
  const size_t n = static_cast<size_t>(T) * static_cast<size_t>(B);
  const int grid = static_cast<int>((n + block - 1) / block);
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Step h = Step::from(step_p);
  if (hessians)
    linearize_kernel<Dyn, Cost, true><<<grid, block, 0, stream>>>(
        xs, us, A, Bm, lx, lu, lxx, luu, lux, dyn, cost, h, T, B);
  else
    linearize_kernel<Dyn, Cost, false><<<grid, block, 0, stream>>>(
        xs, us, A, Bm, lx, lu, lxx, luu, lux, dyn, cost, h, T, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

extern "C" int mas_linearize__single_track__diag_quadratic(
    const float* xs, const float* us, float* A, float* Bm, float* lx, float* lu,
    float* lxx, float* luu, float* lux, int T, int B, int hessians,
    const float* dyn_p, const float* cost_p, const float* step_p, void* stream) {
  using namespace mas;
  return launch_linearize<SingleTrack, DiagQuadratic<4, 2>>(
      xs, us, A, Bm, lx, lu, lxx, luu, lux, T, B, hessians, dyn_p, cost_p, step_p,
      static_cast<cudaStream_t>(stream));
}
