// K3: whole-horizon linearization, one (problem, stage) per thread (a lane
// group per problem-stage in the context mode): its kernels and their
// launch, shared by K3's entry points (linearize.cu) and K8's
// linearization phase (forward_select_emit*.cu).
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
// Layout: batch innermost.  x [T, NX, B], u [T, NU, B] in -- the states
// as x_0 [NX, B] and x_1..x_{T-1} [T - 1, NX, B], two pointers (K3 passes
// one stack, K8 its input x_0 and the trajectory it emitted, so nothing is
// copied to shift it); A [T, NX, NX, B],
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
#pragma once

#include <cuda_runtime.h>

#include "problems.cuh"

namespace mas {

constexpr int LIN_BLOCK = 128;
constexpr int LIN_WARPS = LIN_BLOCK / 32;

// x_t of problem b: x_0 from x0 [NX, B], x_t for t >= 1 from xs1
// [T - 1, NX, B].
template <int NX>
__device__ __forceinline__ void load_state(const float* x0, const float* xs1, size_t t,
                                           size_t sB, size_t b, float* x) {
  const float* p = t == 0 ? x0 + b : xs1 + (t - 1) * NX * sB + b;
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = p[i * sB];
}

// The seven stacks of K3's layout: A [T, NX, NX, B], B [T, NX, NU, B],
// lx [T, NX, B], lu [T, NU, B], lxx [T, NX, NX, B], luu [T, NU, NU, B],
// lux [T, NU, NX, B].
struct LinOut {
  float *A = nullptr, *Bm = nullptr, *lx = nullptr, *lu = nullptr, *lxx = nullptr,
        *luu = nullptr, *lux = nullptr;
};

// K3's work at one problem-stage (t, b) without a context: the derivatives
// at (x, u) (and with HESSIANS the cost Hessians) into o.
template <bool HESSIANS, bool DISCRETE, typename Dyn, typename Cost>
__device__ __forceinline__ void linearize_stage(const Dyn& dyn, const Cost& cost, const Step& h,
                                                const float* x, const float* u, size_t t,
                                                size_t sB, size_t b, const LinOut& o) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
  const float ts = static_cast<float>(t);   // the stage index as the float JAX builds
  stage_derivatives<DISCRETE>(dyn, cost, h, x, u, A, Bm, lx, lu, ts);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) o.A[((t * NX + i) * NX + j) * sB + b] = A[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j) o.Bm[((t * NX + i) * NU + j) * sB + b] = Bm[i][j];
    o.lx[(t * NX + i) * sB + b] = lx[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i) o.lu[(t * NU + i) * sB + b] = lu[i];

  if constexpr (HESSIANS) {
    float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
    stage_hessians<NX, NU>(cost, x, u, CtxView(), ts, lxx, luu, lux);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) o.lxx[((t * NX + i) * NX + j) * sB + b] = lxx[i][j];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) o.luu[((t * NU + i) * NU + j) * sB + b] = luu[i][j];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) o.lux[((t * NU + i) * NX + j) * sB + b] = lux[i][j];
  }
}

template <typename Dyn, typename Cost, bool HESSIANS, bool DISCRETE>
__global__ void __launch_bounds__(128) linearize_kernel(
    const float* __restrict__ x0, const float* __restrict__ xs1, const float* __restrict__ us,
    LinOut o, Dyn dyn, Cost cost, Step h, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  static_assert(!takes_context<Cost>::value, "the context mode is linearize_group_kernel");
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t sB = static_cast<size_t>(B);
  if (idx >= static_cast<size_t>(T) * sB) return;
  const size_t t = idx / sB, b = idx % sB;

  float x[NX], u[NU];
  load_state<NX>(x0, xs1, t, sB, b, x);
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = us[(t * NU + i) * sB + b];
  linearize_stage<HESSIANS, DISCRETE>(dyn, cost, h, x, u, t, sB, b, o);
}

// K3's context mode: a Coupled stage cost whose neighbour sum is spread
// over a group of G lanes.  Lane `lane` sums the pair costs of neighbours
// lane, lane + G, ... in index order from 0, a fixed xor tree sums the
// group's partial sums, and base + sum is the cost -- in whatever scalar
// type (float, Dual, Dual<Dual>) stage_derivatives and stage_hessians
// evaluate it, so every lane of the group ends with the same duals.
template <typename Cost, int G>
struct GroupCoupled {
  Cost c;
  int lane;
  unsigned mask;

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x, const S* u, const CtxView& cv) const {
    S s(0.0f);
#pragma unroll 1
    for (int k = lane; k < cv.K; k += G) {
      float xj[Cost::PairT::NCTX];
      c.other(cv, k, xj);
      s = s + c.pair(x, xj);
    }
    return c.base(x, u) + group_sum<G>(s, mask);
  }
};
template <typename Cost, int G>
struct takes_context<GroupCoupled<Cost, G>> {
  static constexpr bool value = true;
};

// K3's context mode: a group of G lanes per (problem, stage), at the flat
// index (t B + b) G + lane.  Each lane evaluates the stage's derivatives with
// its share of the neighbours (GroupCoupled) and writes the outputs o of
// the 58 (at NX = 4, NU = 2) with o % G == lane.
constexpr int LIN_GROUP_BLOCK = 64;

template <typename Dyn, typename Cost, bool HESSIANS, bool DISCRETE, int G>
__global__ void __launch_bounds__(LIN_GROUP_BLOCK) linearize_group_kernel(
    const float* __restrict__ x0, const float* __restrict__ xs1, const float* __restrict__ us,
    float* __restrict__ A_out, float* __restrict__ B_out, float* __restrict__ lx_out,
    float* __restrict__ lu_out, float* __restrict__ lxx_out, float* __restrict__ luu_out,
    float* __restrict__ lux_out, const float* __restrict__ ctx, Dyn dyn, Cost cost, Step h,
    int T, int B, int n_ctx, int c_ctx) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  constexpr int O_B = NX * NX, O_LX = O_B + NX * NU, O_LU = O_LX + NX, O_LXX = O_LU + NU,
                O_LUU = O_LXX + NX * NX, O_LUX = O_LUU + NU * NU;
  const size_t idx = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t sB = static_cast<size_t>(B);
  const size_t g = idx / G;
  if (g >= static_cast<size_t>(T) * sB) return;  // the whole group leaves
  const int lane = static_cast<int>(idx % G);
  const size_t t = g / sB, b = g % sB;
  const auto mine = [lane](int o) { return o % G == lane; };

  float x[NX], u[NU];
  load_state<NX>(x0, xs1, t, sB, b, x);
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = us[(t * NU + i) * sB + b];

  const CtxView cv = ctx_view(ctx, static_cast<int>(t), n_ctx, c_ctx, sB, b);
  const GroupCoupled<Cost, G> gc{cost, lane, group_mask<G>()};
  float A[NX][NX], Bm[NX][NU], lx[NX], lu[NU];
  stage_derivatives<DISCRETE>(dyn, gc, h, x, u, A, Bm, lx, lu, static_cast<float>(t), cv);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j)
      if (mine(i * NX + j)) A_out[((t * NX + i) * NX + j) * sB + b] = A[i][j];
#pragma unroll
    for (int j = 0; j < NU; ++j)
      if (mine(O_B + i * NU + j)) B_out[((t * NX + i) * NU + j) * sB + b] = Bm[i][j];
    if (mine(O_LX + i)) lx_out[(t * NX + i) * sB + b] = lx[i];
  }
#pragma unroll
  for (int i = 0; i < NU; ++i)
    if (mine(O_LU + i)) lu_out[(t * NU + i) * sB + b] = lu[i];

  if constexpr (HESSIANS) {
    float lxx[NX][NX], luu[NU][NU], lux[NU][NX];
    stage_hessians<NX, NU>(gc, x, u, cv, static_cast<float>(t), lxx, luu, lux);
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        if (mine(O_LXX + i * NX + j)) lxx_out[((t * NX + i) * NX + j) * sB + b] = lxx[i][j];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j)
        if (mine(O_LUU + i * NU + j)) luu_out[((t * NU + i) * NU + j) * sB + b] = luu[i][j];
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j)
        if (mine(O_LUX + i * NX + j)) lux_out[((t * NU + i) * NX + j) * sB + b] = lux[i][j];
  }
}

// Lanes per problem-stage of the context mode.  Every lane of a group
// repeats the base cost and the dynamics, and only the neighbour sum is
// split, so the group pays where the launch is small (latency-bound: the
// 64-car game's 640 problem-stages, the 256-car game's 2,560) and costs
// where it is large: past LIN_GROUP_LANES lanes the launch turns
// throughput-bound on the repeated work, and one lane a problem-stage is
// faster (the 1,024-car game's 10,240 at K = 8).  Within the bound: 32
// lanes for more than 8 neighbours where they fit, else 8.
constexpr size_t LIN_GROUP_LANES = 32768;

inline int group_lanes(size_t stages, int n_ctx) {
  if (stages * 8 > LIN_GROUP_LANES) return 1;
  return n_ctx > 8 && stages * 32 <= LIN_GROUP_LANES ? 32 : 8;
}

template <typename Dyn, typename Cost, bool DISCRETE, int G>
void launch_linearize_group(const float* x0, const float* xs1, const float* us, float* A,
                            float* Bm, float* lx, float* lu, float* lxx, float* luu, float* lux,
                            const float* ctx,
                            int T, int B, int n_ctx, int c_ctx, int hessians, const Dyn& dyn,
                            const Cost& cost, const Step& h, cudaStream_t stream) {
  const size_t n = static_cast<size_t>(T) * static_cast<size_t>(B) * G;
  const int grid = static_cast<int>((n + LIN_GROUP_BLOCK - 1) / LIN_GROUP_BLOCK);
  if (hessians)
    linearize_group_kernel<Dyn, Cost, true, DISCRETE, G><<<grid, LIN_GROUP_BLOCK, 0, stream>>>(
        x0, xs1, us, A, Bm, lx, lu, lxx, luu, lux, ctx, dyn, cost, h, T, B, n_ctx, c_ctx);
  else
    linearize_group_kernel<Dyn, Cost, false, DISCRETE, G><<<grid, LIN_GROUP_BLOCK, 0, stream>>>(
        x0, xs1, us, A, Bm, lx, lu, lxx, luu, lux, ctx, dyn, cost, h, T, B, n_ctx, c_ctx);
}

// K3 in one Jacobian mode at x_0 = x0 [NX, B], x_1..x_{T-1} = xs1
// [T - 1, NX, B] and us [T, NU, B], with or without Hessians: the context
// mode on the group kernel, else linearize_kernel.
template <typename Dyn, typename Cost, bool DISCRETE>
void launch_linearize_mode(const float* x0, const float* xs1, const float* us, float* A,
                           float* Bm, float* lx, float* lu, float* lxx, float* luu, float* lux,
                           const float* ctx,
                           int T, int B, int n_ctx, int c_ctx, int hessians, const Dyn& dyn,
                           const Cost& cost, const Step& h, cudaStream_t stream) {
  if constexpr (takes_context<Cost>::value) {
    // The context mode runs on the group kernel, at G = group_lanes(...).
    const int G = group_lanes(static_cast<size_t>(T) * static_cast<size_t>(B), n_ctx);
    if (G == 32)
      launch_linearize_group<Dyn, Cost, DISCRETE, 32>(x0, xs1, us, A, Bm, lx, lu, lxx, luu,
                                                      lux, ctx, T, B, n_ctx, c_ctx, hessians,
                                                      dyn, cost, h, stream);
    else if (G == 8)
      launch_linearize_group<Dyn, Cost, DISCRETE, 8>(x0, xs1, us, A, Bm, lx, lu, lxx, luu,
                                                     lux, ctx, T, B, n_ctx, c_ctx, hessians,
                                                     dyn, cost, h, stream);
    else
      launch_linearize_group<Dyn, Cost, DISCRETE, 1>(x0, xs1, us, A, Bm, lx, lu, lxx, luu,
                                                     lux, ctx, T, B, n_ctx, c_ctx, hessians,
                                                     dyn, cost, h, stream);
  } else {
    const size_t n = static_cast<size_t>(T) * static_cast<size_t>(B);
    const int grid = static_cast<int>((n + LIN_BLOCK - 1) / LIN_BLOCK);
    const LinOut o{A, Bm, lx, lu, lxx, luu, lux};
    if (hessians)
      linearize_kernel<Dyn, Cost, true, DISCRETE><<<grid, LIN_BLOCK, 0, stream>>>(
          x0, xs1, us, o, dyn, cost, h, T, B);
    else
      linearize_kernel<Dyn, Cost, false, DISCRETE><<<grid, LIN_BLOCK, 0, stream>>>(
          x0, xs1, us, o, dyn, cost, h, T, B);
  }
}

}  // namespace mas
