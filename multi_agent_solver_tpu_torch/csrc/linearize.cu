// K3: whole-horizon linearization, one (problem, stage) per thread, and K7:
// the same derivatives on a flat grid of problem-stages with batch-first
// I/O.
//
// K3 replaces multi_agent_solver_tpu/ops/linearize_pallas.py ::
// linearize_pallas_tiled (kernel _make_kernel), K7 linearize_pallas (the
// same kernel on a flat B T lane grid).
//
// What K3 computes at every (t, b): A = d step / dx and B = d step / du
// through RK4 (DISCRETE; otherwise the Jacobians of the continuous dynamics
// f(x, u), the reference's jacobian_mode "continuous"), the cost gradient
// lx, lu and, with `hessians`, the cost Hessians lxx, luu, lux -- upper
// triangles from jvp-over-jvp, mirrored, exactly as the TPU kernel
// symmetrizes them.
//
// Layout: batch innermost.  x [T, NX, B], u [T, NU, B] in; A [T, NX, NX, B],
// B [T, NX, NU, B], lx [T, NX, B], lu [T, NU, B], lxx [T, NX, NX, B],
// luu [T, NU, NU, B], lux [T, NU, NX, B] out.  Context mode (a Coupled
// stage cost, problems.cuh) also reads ctx [T, K, C, B]: the stage cost at
// (t, b) sees ctx[t, :, :, b], a constant of the derivatives -- K
// neighbours summed in a loop that is not unrolled, each in first-order
// duals for the gradient and second-order duals for the Hessians.
//
// What bounds it on the H100: the output bytes (4 (NX NX + NX NU + NX + NU
// + NX NX + NU NU + NU NX) bytes per stage against 4 (NX + NU) read); the
// duals' arithmetic is small.  Design: the TPU's parallel (b, t) grid
// becomes a flat thread index t * B + b, so a warp reads and writes 32
// neighbouring problems of one stage, coalesced.  One Dual<float, NX+NU>
// pass gives A, B, lx, lu; one Dual<Dual<float, NX+NU>, NX+NU> pass of the
// stage cost gives every Hessian entry.  The fused loop calls it once, on
// one stage, to hoist the time-constant Hessians of a stationary cost;
// on its other branches over the whole horizon, with Hessians (the
// quadratic hoist, and every iteration of the general branch) or without
// (every iteration of the quadratic and separate-kernel stationary
// branches).
//
// K7 computes K3's outputs, Hessians always, in either Jacobian mode, on
// the non-fused path's batch-first stacks ([B, T, ...], the layout of the
// torch glue around it).  Bound, as K3's: the output bytes.  Design: one
// thread per lane of the flat B T grid and K3's device code
// (stage_derivatives, stage_hessians); a thread's 58 output floats (at
// NX = 4, NU = 2) are contiguous, so a warp's stores stride by that record
// and coalesce only in part -- the price of the batch-first layout.
#include <cuda_runtime.h>

#include "problems.cuh"

namespace mas {

template <typename Dyn, typename Cost, bool HESSIANS, bool DISCRETE>
__global__ void __launch_bounds__(128) linearize_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ A_out, float* __restrict__ B_out, float* __restrict__ lx_out,
    float* __restrict__ lu_out, float* __restrict__ lxx_out, float* __restrict__ luu_out,
    float* __restrict__ lux_out, const float* __restrict__ ctx, Dyn dyn, Cost cost, Step h,
    int T, int B, int n_ctx, int c_ctx) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t sB = static_cast<size_t>(B);
  if (idx >= static_cast<size_t>(T) * sB) return;
  const size_t t = idx / sB, b = idx % sB;

  float x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[(t * NX + i) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = us[(t * NU + i) * sB + b];

  const CtxView cv = ctx_view(ctx, static_cast<int>(t), n_ctx, c_ctx, sB, b);
  float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
  stage_derivatives<DISCRETE>(dyn, cost, h, x, u, A, Bm, lx, lu, cv);
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
    float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
    stage_hessians<NX, NU>(cost, x, u, cv, lxx, luu, lux);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) lxx_out[((t * NX + i) * NX + j) * sB + b] = lxx[i][j];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) luu_out[((t * NU + i) * NU + j) * sB + b] = luu[i][j];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) lux_out[((t * NU + i) * NX + j) * sB + b] = lux[i][j];
  }
}

// K7: lane l = b T + t of the flat grid is one problem-stage.  Batch-first
// I/O: xs [B, T + 1, NX] (stage t of problem b at (b (T + 1) + t) NX),
// us [B, T, NU]; A [B T, NX, NX], B [B T, NX, NU], lx [B T, NX], lu [B T, NU],
// lxx [B T, NX, NX], luu [B T, NU, NU], lux [B T, NU, NX].  Hessians
// always.  The TPU kernel hands each lane its stage index as a float; the
// device cost functions of problems.cuh take none, so nothing reads it.
template <typename Dyn, typename Cost, bool DISCRETE>
__global__ void __launch_bounds__(128) linearize_flat_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ A_out, float* __restrict__ B_out, float* __restrict__ lx_out,
    float* __restrict__ lu_out, float* __restrict__ lxx_out, float* __restrict__ luu_out,
    float* __restrict__ lux_out, Dyn dyn, Cost cost, Step h, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  const size_t l = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t sT = static_cast<size_t>(T);
  if (l >= sT * static_cast<size_t>(B)) return;
  const size_t b = l / sT, t = l % sT;

  float x[NX], u[NU];
  const float* xl = xs + (b * (sT + 1) + t) * NX;
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xl[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = us[l * NU + i];

  float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
  stage_derivatives<DISCRETE>(dyn, cost, h, x, u, A, Bm, lx, lu);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) A_out[(l * NX + i) * NX + j] = A[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) B_out[(l * NX + i) * NU + j] = Bm[i][j];
    lx_out[l * NX + i] = lx[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) lu_out[l * NU + i] = lu[i];

  float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
  stage_hessians<NX, NU>(cost, x, u, CtxView(), lxx, luu, lux);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) lxx_out[(l * NX + i) * NX + j] = lxx[i][j];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NU; ++j) luu_out[(l * NU + i) * NU + j] = luu[i][j];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) lux_out[(l * NU + i) * NX + j] = lux[i][j];
}

constexpr int LIN_BLOCK = 128;

template <typename Dyn, typename Cost, bool DISCRETE>
void launch_linearize_mode(const float* xs, const float* us, float* A, float* Bm, float* lx,
                           float* lu, float* lxx, float* luu, float* lux, const float* ctx,
                           int T, int B, int n_ctx, int c_ctx, int hessians, const Dyn& dyn,
                           const Cost& cost, const Step& h, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(T) * static_cast<size_t>(B);
  const int grid = static_cast<int>((n + LIN_BLOCK - 1) / LIN_BLOCK);
  if (hessians)
    linearize_kernel<Dyn, Cost, true, DISCRETE><<<grid, LIN_BLOCK, 0, stream>>>(
        xs, us, A, Bm, lx, lu, lxx, luu, lux, ctx, dyn, cost, h, T, B, n_ctx, c_ctx);
  else
    linearize_kernel<Dyn, Cost, false, DISCRETE><<<grid, LIN_BLOCK, 0, stream>>>(
        xs, us, A, Bm, lx, lu, lxx, luu, lux, ctx, dyn, cost, h, T, B, n_ctx, c_ctx);
}

template <typename Dyn, typename Cost>
int launch_linearize(const float* xs, const float* us, float* A, float* Bm, float* lx,
                     float* lu, float* lxx, float* luu, float* lux, const float* ctx, int T,
                     int B, int n_ctx, int c_ctx, int hessians, int discrete,
                     const float* dyn_p, const float* cost_p, const float* step_p,
                     cudaStream_t stream) {
  if (takes_context<Cost>::value != (ctx != nullptr) || n_ctx < 0 ||
      (ctx != nullptr && c_ctx < Dyn::NX))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Step h = Step::from(step_p);
  if (discrete)
    launch_linearize_mode<Dyn, Cost, true>(xs, us, A, Bm, lx, lu, lxx, luu, lux, ctx, T, B,
                                           n_ctx, c_ctx, hessians, dyn, cost, h, stream);
  else
    launch_linearize_mode<Dyn, Cost, false>(xs, us, A, Bm, lx, lu, lxx, luu, lux, ctx, T, B,
                                            n_ctx, c_ctx, hessians, dyn, cost, h, stream);
  return static_cast<int>(cudaGetLastError());
}

template <typename Dyn, typename Cost>
int launch_linearize_flat(const float* xs, const float* us, float* A, float* Bm, float* lx,
                          float* lu, float* lxx, float* luu, float* lux, int T, int B,
                          int discrete, const float* dyn_p, const float* cost_p,
                          const float* step_p, cudaStream_t stream) {
  if (takes_context<Cost>::value) return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(T) * static_cast<size_t>(B);
  const int grid = static_cast<int>((n + LIN_BLOCK - 1) / LIN_BLOCK);
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Step h = Step::from(step_p);
  if (discrete)
    linearize_flat_kernel<Dyn, Cost, true><<<grid, LIN_BLOCK, 0, stream>>>(
        xs, us, A, Bm, lx, lu, lxx, luu, lux, dyn, cost, h, T, B);
  else
    linearize_flat_kernel<Dyn, Cost, false><<<grid, LIN_BLOCK, 0, stream>>>(
        xs, us, A, Bm, lx, lu, lxx, luu, lux, dyn, cost, h, T, B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

// One C entry point per (dynamics, stage cost) the kernels can evaluate.
#define MAS_LINEARIZE(NAME, DYN, COST)                                                     \
  extern "C" int mas_linearize__##NAME(                                                    \
      const float* xs, const float* us, float* A, float* Bm, float* lx, float* lu,         \
      float* lxx, float* luu, float* lux, const float* ctx, int T, int B, int n_ctx,       \
      int c_ctx, int hessians, int discrete, const float* dyn_p, const float* cost_p,      \
      const float* step_p, void* stream) {                                                 \
    return mas::launch_linearize<DYN, COST>(xs, us, A, Bm, lx, lu, lxx, luu, lux, ctx, T,  \
                                            B, n_ctx, c_ctx, hessians, discrete, dyn_p,    \
                                            cost_p, step_p,                                \
                                            static_cast<cudaStream_t>(stream));            \
  }

// K7's entry points, for the stage costs without a context.
#define MAS_LINEARIZE_FLAT(NAME, DYN, COST)                                                \
  extern "C" int mas_linearize_flat__##NAME(                                               \
      const float* xs, const float* us, float* A, float* Bm, float* lx, float* lu,         \
      float* lxx, float* luu, float* lux, int T, int B, int discrete, const float* dyn_p,  \
      const float* cost_p, const float* step_p, void* stream) {                            \
    return mas::launch_linearize_flat<DYN, COST>(xs, us, A, Bm, lx, lu, lxx, luu, lux, T,  \
                                                 B, discrete, dyn_p, cost_p, step_p,       \
                                                 static_cast<cudaStream_t>(stream));       \
  }

using LaneFollowCost = mas::DiagQuadratic<4, 2>;
MAS_LINEARIZE(single_track__diag_quadratic, mas::SingleTrack, LaneFollowCost)
MAS_LINEARIZE(single_track__circular_track, mas::SingleTrack, mas::CircularTrack)
using CoupledTrack = mas::Coupled<mas::CircularTrack, mas::GaussianCollision>;
MAS_LINEARIZE(single_track__coupled_circular_track_gaussian_collision, mas::SingleTrack,
              CoupledTrack)
MAS_LINEARIZE_FLAT(single_track__diag_quadratic, mas::SingleTrack, LaneFollowCost)
MAS_LINEARIZE_FLAT(single_track__circular_track, mas::SingleTrack, mas::CircularTrack)
