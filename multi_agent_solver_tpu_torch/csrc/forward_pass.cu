// K9: the first-generation all-alpha forward pass, one thread per
// (problem, alpha).
//
// Replaces multi_agent_solver_tpu/ops/forward_pallas.py :: _forward_lanes
// (kernel _make_kernel), behind forward_pass_pallas and rollout_pallas.
//
// What it computes for candidate a of problem b: from x_0 = xs[0, :, b],
// for t = 0..T-1, u = clamp(u_ref + alpha_a k + K (x - x_ref)) in the TPU
// kernel's order (the clamp only when bounds are given), the stage cost at
// (x, u) added to the candidate's sum (the TPU kernel passes the integer
// stage index; the device costs read none), then the RK4 step; the
// terminal cost of x_T last.  Every candidate's states x_1..x_T, controls
// and total cost are written out -- nothing is selected.
//
// Layout: the reference batch innermost, xs [T, NX, B] (x_0..x_{T-1}),
// us [T, NU, B], k [T, NU, B], K [T, NU, NX, B], lb / ub [NU, B] (or null),
// alphas [A] in; xs_out [T, NX, A, B] (x_1..x_T), us_out [T, NU, A, B],
// cost [A, B] out.  Thread l = a B + b.
//
// What bounds it on the H100: the bytes of its outputs, A (T (NX + NU) + 1)
// 4 bytes a problem against T (NX + 2 NU + NU NX) 4 bytes of reference read;
// A RK4 rollouts a problem of arithmetic.  Design: the TPU kernel
// replicated the reference of every problem A times in device memory
// before the launch; here the A threads of one problem read the same
// reference (through the L2 cache) and index their alpha, and a warp's
// threads are 32 neighbouring problems of one candidate, so every load and
// store of a stage coalesces.
#include <cuda_runtime.h>

#include "forward_select.cuh"

namespace mas {

template <typename Dyn, typename Cost, typename Term>
__global__ void __launch_bounds__(128) forward_pass_kernel(
    const float* __restrict__ xs, const float* __restrict__ us, const float* __restrict__ k,
    const float* __restrict__ K, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, const float* __restrict__ alphas,
    float* __restrict__ xs_out, float* __restrict__ us_out, float* __restrict__ cost_out,
    Dyn dyn, Cost cost, Term term, Step h, int T, int B, int A) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  static_assert(!takes_context<Cost>::value, "the forward pass takes no context");
  const size_t sB = static_cast<size_t>(B);
  const size_t sAB = static_cast<size_t>(A) * sB;
  const size_t l = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (l >= sAB) return;
  const size_t b = l % sB;
  const float alpha = alphas[l / sB];

  const bool bounded = lb_in != nullptr;
  float lb[NU], ub[NU];
  if (bounded) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lb[i] = lb_in[i * sB + b];
      ub[i] = ub_in[i * sB + b];
    }
  }
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[i * sB + b];
  float c = 0.0f;
  for (int t = 0; t < T; ++t) {
    const size_t st = static_cast<size_t>(t);
    float xr[NX], ur[NU], kt[NU], Kt[NU][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) xr[i] = xs[(st * NX + i) * sB + b];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      ur[i] = us[(st * NU + i) * sB + b];
      kt[i] = k[(st * NU + i) * sB + b];
#pragma unroll
      for (int j = 0; j < NX; ++j) Kt[i][j] = K[((st * NU + i) * NX + j) * sB + b];
    }
    float u[NU], xn[NX];
    feedback_control<NX, NU>(x, xr, ur, kt, Kt, alpha, bounded ? lb : nullptr, ub, u);
    c = c + cost(x, u);
    rk4_step(dyn, x, u, h, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      xs_out[(st * NX + i) * sAB + l] = xn[i];
      x[i] = xn[i];
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) us_out[(st * NU + i) * sAB + l] = u[i];
  }
  cost_out[l] = c + term(x);
}

template <typename Dyn, typename Cost, typename Term>
int launch_forward_pass(const float* xs, const float* us, const float* k, const float* K,
                        const float* lb, const float* ub, const float* alphas, float* xs_out,
                        float* us_out, float* cost_out, int T, int B, const float* dyn_p,
                        const float* cost_p, const float* term_p, const float* step_p, int A,
                        cudaStream_t stream) {
  if (A < 1 || B < 1 || T < 1 || (lb == nullptr) != (ub == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = static_cast<size_t>(A) * static_cast<size_t>(B);
  const int block = 128;
  const int grid = static_cast<int>((n + block - 1) / block);
  forward_pass_kernel<Dyn, Cost, Term><<<grid, block, 0, stream>>>(
      xs, us, k, K, lb, ub, alphas, xs_out, us_out, cost_out, Dyn::from(dyn_p),
      Cost::from(cost_p), Term::from(term_p), Step::from(step_p), T, B, A);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

// One C entry point per (dynamics, stage cost, terminal cost).  alphas is a
// device array of A floats; the device-function parameters and the step
// constants are host arrays, read at launch.
#define MAS_FORWARD_PASS(NAME, DYN, COST, TERM)                                             \
  extern "C" int mas_forward_pass__##NAME(                                                  \
      const float* xs, const float* us, const float* k, const float* K, const float* lb,    \
      const float* ub, const float* alphas, float* xs_out, float* us_out, float* cost_out,  \
      int T, int B, const float* dyn_p, const float* cost_p, const float* term_p,           \
      const float* step_p, int A, void* stream) {                                           \
    return mas::launch_forward_pass<DYN, COST, TERM>(xs, us, k, K, lb, ub, alphas, xs_out,  \
                                                     us_out, cost_out, T, B, dyn_p, cost_p, \
                                                     term_p, step_p, A,                     \
                                                     static_cast<cudaStream_t>(stream));    \
  }

using LaneFollowCost = mas::DiagQuadratic<4, 2>;
MAS_FORWARD_PASS(single_track__diag_quadratic__zero, mas::SingleTrack, LaneFollowCost,
                 mas::ZeroTerminal)
