// K3: whole-horizon linearization, one (problem, stage) per thread (a lane
// group per problem-stage in the context mode), and K7:
// the same derivatives on a flat grid of problem-stages with batch-first
// I/O.
//
// K3's kernels and their launch are in linearize.cuh (K8 runs them too);
// this header holds K3's launchers, its hoist mode, K7 and the entry-point
// macros, which linearize.cu and linearize_zoo.cu instantiate.
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
// stage cost, problems.cuh; the TPU kernel's ctx_l, linearize_pallas.py:
// 55-69, 149-222) also reads ctx [T, K, C, B]: the stage cost at (t, b)
// sees ctx[t, :, :, b], a constant of the derivatives.  It runs on
// linearize_group_kernel, a group of G lanes per (problem, stage) -- G = 32
// over 8 neighbours, else 8, and 1 once the launch would pass 32,768 lanes
// (group_lanes) -- because one thread per problem-stage summed all K pair
// costs in a row, in first-order duals and again in second-order duals (49
// floats a value), and put the 64-car game's 640 problem-stages on 5 SMs.
// Lane l sums the pair costs of neighbours l, l + G, ... in index order, a
// fixed xor-shuffle tree (offsets G/2 ... 1) sums the group's partial
// duals, base + sum is the cost, and every lane then holds the same duals;
// the lanes share the output writes.  Its bound at the game's shapes is
// 0.15-0.98 us of bytes.  The tree re-associates the neighbour sum, so the
// context mode is not bit for bit the one-thread kernel's: it is held to
// its plain version at rtol 1e-5 with a floor of 1e-5 of each output's
// scale, as before.
//
// What bounds it on the H100: the output bytes (4 (NX NX + NX NU + NX + NU
// + NX NX + NU NU + NU NX) bytes per stage against 4 (NX + NU) read); the
// duals' arithmetic is small.  Design: the TPU's parallel (b, t) grid
// becomes a flat thread index t * B + b, so a warp reads and writes 32
// neighbouring problems of one stage, coalesced.  One Dual<float, NX+NU>
// pass gives A, B, lx, lu; one Dual<Dual<float, NX+NU>, NX+NU> pass of the
// stage cost gives every Hessian entry.  The fused loop calls it over the
// whole horizon, with Hessians (every iteration of the general branch) or
// without (every iteration of the quadratic and separate-kernel
// stationary branches).
//
// K3's hoist mode (linearize_hessians_kernel): the cost Hessians alone,
// which the fused loop hoists once a solve for a quadratic cost -- on one
// stage for a stationary one (the main path), over the horizon otherwise
// (the quadratic time-varying branch, every fused AL solve) -- where the
// TPU driver runs K3 whole and keeps its last three outputs
// (multi_agent_solver_tpu/solvers/ilqr.py:1088-1097).  One thread a
// (problem, stage) at the flat index t B + b, as K3: it loads (x_t, u_t),
// runs stage_hessians -- K3's device function, so the Hessians are K3's
// floats -- and writes lxx, luu and lux in K3's layout: no dynamics, no
// first-order pass, 4 (NX NX + NU NU + NU NX) bytes written and 4 (NX + NU)
// read a stage, which bound it (0.0106 ms at one stage of 262,144
// problems, 0.851 ms over 80 stages).  Its arithmetic is one pass of the
// stage cost in second-order duals, most of it products by the seeds'
// zeros, which IEEE arithmetic does not fold, so over the horizon its
// issue slots may bind it as much as its bytes.
//
// K7 computes K3's outputs, Hessians always, in either Jacobian mode, on
// the non-fused path's batch-first stacks ([B, T, ...], the layout of the
// torch glue around it).  Bound, as K3's: the output bytes.  Design: one
// thread per lane of the flat B T grid and K3's device code
// (stage_derivatives, stage_hessians); a thread's 58 output floats (at
// NX = 4, NU = 2) are contiguous, so a warp staging its 32 lanes' outputs
// in shared memory writes each array as one contiguous span, coalesced as
// K3's batch-innermost stores (linearize_flat_kernel).
#pragma once

#include <cuda_runtime.h>

#include "linearize.cuh"

namespace mas {

// K3's hoist mode: lxx [T, NX, NX, B], luu [T, NU, NU, B], lux [T, NU, NX,
// B] of the stage cost at xs [T, NX, B], us [T, NU, B].
template <typename Cost, int NX, int NU>
__global__ void __launch_bounds__(128) linearize_hessians_kernel(
    const float* __restrict__ xs, const float* __restrict__ us, float* __restrict__ lxx_out,
    float* __restrict__ luu_out, float* __restrict__ lux_out, Cost cost, int T, int B) {
  static_assert(!takes_context<Cost>::value, "a hoist with a context runs K3's context mode");
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t sB = static_cast<size_t>(B);
  if (idx >= static_cast<size_t>(T) * sB) return;
  const size_t t = idx / sB, b = idx % sB;
  float x[NX], u[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[(t * NX + i) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = us[(t * NU + i) * sB + b];
  float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
  stage_hessians<NX, NU>(cost, x, u, CtxView(), static_cast<float>(t), lxx, luu, lux);
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


// K7's staging: a warp's lanes' values of one output array, N floats a
// lane, in shared memory at a lane stride of N | 1 floats (odd: the warp's
// 32 stores of one entry fall in 32 banks).  span_out writes the warp's
// lanes l0 .. l0 + lanes - 1 of the array, the contiguous span
// [l0 N, (l0 + lanes) N) of out, consecutive lanes on consecutive floats.
template <int N>
__device__ __forceinline__ void stage_in(float* staged, int lane, const float* v) {
#pragma unroll
  for (int k = 0; k < N; ++k) staged[lane * (N | 1) + k] = v[k];
}

template <int N>
__device__ __forceinline__ void span_out(float* __restrict__ out, const float* staged, size_t l0,
                                         int lanes, int lane) {
  for (int i = lane; i < lanes * N; i += 32) out[l0 * N + i] = staged[(i / N) * (N | 1) + i % N];
}

// K7: lane l = b T + t of the flat grid is one problem-stage.  Batch-first
// I/O: xs [B, T + 1, NX] (stage t of problem b at row b (T + 1) + t = l +
// l / T), us [B, T, NU]; A [B T, NX, NX], B [B T, NX, NU], lx [B T, NX],
// lu [B T, NU], lxx [B T, NX, NX], luu [B T, NU, NU], lux [B T, NU, NX].
// Hessians always.  The TPU kernel hands each lane its stage index as a
// float, and so does this one (a cost with TAKES_STAGE reads it).  A warp is 32 consecutive lanes, so its share of every array is
// one contiguous span: the warp reads its rows of xs (a jump of one row at
// each problem boundary) and its us into shared memory, a thread evaluates
// its lane with K3's device functions in K3's order (the outputs are K3's
// floats, transposed), and the warp stages A, B, lx and lu in shared memory
// and writes each array's span, coalesced, then does the same with lxx,
// luu and lux.  A thread writing its lane's 58 outputs (NX = 4, NU = 2)
// straight to device memory touched 32 sectors a warp store where these
// take 4.  The warps of a block share nothing and meet at no barrier.
template <typename Dyn, typename Cost, bool DISCRETE>
__global__ void __launch_bounds__(LIN_BLOCK) linearize_flat_kernel(
    const float* __restrict__ xs, const float* __restrict__ us,
    float* __restrict__ A_out, float* __restrict__ B_out, float* __restrict__ lx_out,
    float* __restrict__ lu_out, float* __restrict__ lxx_out, float* __restrict__ luu_out,
    float* __restrict__ lux_out, Dyn dyn, Cost cost, Step h, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  // The staged arrays' offsets: A, B, lx and lu, then lxx, luu and lux in
  // the same space.
  constexpr int O_B = 32 * ((NX * NX) | 1), O_LX = O_B + 32 * ((NX * NU) | 1),
                O_LU = O_LX + 32 * (NX | 1), O_LUU = 32 * ((NX * NX) | 1),
                O_LUX = O_LUU + 32 * ((NU * NU) | 1),
                ROUND1 = O_LU + 32 * (NU | 1), ROUND2 = O_LUX + 32 * ((NU * NX) | 1),
                STAGED = ROUND1 > ROUND2 ? ROUND1 : ROUND2;
  __shared__ float staged_all[LIN_WARPS][STAGED];
  __shared__ float x_all[LIN_WARPS][2 * 32 * NX], u_all[LIN_WARPS][32 * NU];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* staged = staged_all[warp];
  float* x_in = x_all[warp];
  float* u_in = u_all[warp];
  const size_t sT = static_cast<size_t>(T);
  const size_t n = sT * static_cast<size_t>(B);
  const size_t l0 = (static_cast<size_t>(blockIdx.x) * LIN_BLOCK) + warp * 32;
  if (l0 >= n) return;   // the whole warp leaves
  const int lanes = n - l0 < 32 ? static_cast<int>(n - l0) : 32;
  const size_t last = l0 + lanes - 1;
  const size_t r0 = l0 + l0 / sT;                                  // the warp's first row
  const int rows = static_cast<int>(last + last / sT - r0) + 1;    // <= 2 lanes
  for (int i = lane; i < rows * NX; i += 32) x_in[i] = xs[r0 * NX + i];
  for (int i = lane; i < lanes * NU; i += 32) u_in[i] = us[l0 * NU + i];
  __syncwarp();

  // The tail warp's other lanes only help with the spans.
  const bool mine = lane < lanes;
  float x[NX], u[NU], ts = 0.0f;
  if (mine) {
    const size_t l = l0 + lane;
    ts = static_cast<float>(l % sT);   // the lane's stage index, as the TPU kernel's float
    const int row = static_cast<int>(l + l / sT - r0);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = x_in[row * NX + i];
#pragma unroll
    for (int i = 0; i < NU; ++i) u[i] = u_in[lane * NU + i];
    float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
    stage_derivatives<DISCRETE>(dyn, cost, h, x, u, A, Bm, lx, lu, ts);
    stage_in<NX * NX>(staged, lane, &A[0][0]);
    stage_in<NX * NU>(staged + O_B, lane, &Bm[0][0]);
    stage_in<NX>(staged + O_LX, lane, lx);
    stage_in<NU>(staged + O_LU, lane, lu);
  }
  __syncwarp();
  span_out<NX * NX>(A_out, staged, l0, lanes, lane);
  span_out<NX * NU>(B_out, staged + O_B, l0, lanes, lane);
  span_out<NX>(lx_out, staged + O_LX, l0, lanes, lane);
  span_out<NU>(lu_out, staged + O_LU, l0, lanes, lane);
  __syncwarp();   // the warp has read round 1 before round 2 overwrites it

  if (mine) {
    float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
    stage_hessians<NX, NU>(cost, x, u, CtxView(), ts, lxx, luu, lux);
    stage_in<NX * NX>(staged, lane, &lxx[0][0]);
    stage_in<NU * NU>(staged + O_LUU, lane, &luu[0][0]);
    stage_in<NU * NX>(staged + O_LUX, lane, &lux[0][0]);
  }
  __syncwarp();
  span_out<NX * NX>(lxx_out, staged, l0, lanes, lane);
  span_out<NU * NU>(luu_out, staged + O_LUU, l0, lanes, lane);
  span_out<NU * NX>(lux_out, staged + O_LUX, l0, lanes, lane);
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
  const float* xs1 = xs + static_cast<size_t>(Dyn::NX) * static_cast<size_t>(B);
  if (discrete)
    launch_linearize_mode<Dyn, Cost, true>(xs, xs1, us, A, Bm, lx, lu, lxx, luu, lux, ctx, T,
                                           B, n_ctx, c_ctx, hessians, dyn, cost, h, stream);
  else
    launch_linearize_mode<Dyn, Cost, false>(xs, xs1, us, A, Bm, lx, lu, lxx, luu, lux, ctx, T,
                                            B, n_ctx, c_ctx, hessians, dyn, cost, h, stream);
  return static_cast<int>(cudaGetLastError());
}

// The hoist mode of a cost without a context; NX and NU are the
// dynamics', which the kernel does not run.
template <typename Dyn, typename Cost>
int launch_linearize_hessians(const float* xs, const float* us, float* lxx, float* luu,
                              float* lux, int T, int B, const float* cost_p,
                              cudaStream_t stream) {
  if constexpr (takes_context<Cost>::value) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const size_t n = static_cast<size_t>(T) * static_cast<size_t>(B);
    const int grid = static_cast<int>((n + LIN_BLOCK - 1) / LIN_BLOCK);
    linearize_hessians_kernel<Cost, Dyn::NX, Dyn::NU><<<grid, LIN_BLOCK, 0, stream>>>(
        xs, us, lxx, luu, lux, Cost::from(cost_p), T, B);
    return static_cast<int>(cudaGetLastError());
  }
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

// K3's hoist mode's entry points, for the stage costs without a context.
#define MAS_LINEARIZE_HESSIANS(NAME, DYN, COST)                                            \
  extern "C" int mas_linearize_hessians__##NAME(const float* xs, const float* us,          \
                                                float* lxx, float* luu, float* lux, int T, \
                                                int B, const float* cost_p, void* stream) { \
    return mas::launch_linearize_hessians<DYN, COST>(xs, us, lxx, luu, lux, T, B, cost_p,  \
                                                     static_cast<cudaStream_t>(stream));   \
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

