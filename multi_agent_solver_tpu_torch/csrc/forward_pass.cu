// K9: the all-alpha forward pass, a block of 32 neighbouring problems x
// the candidates.
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
// the A candidates (host floats, passed to the kernel by value) in;
// xs_out [T, NX, A, B] (x_1..x_T), us_out [T, NU, A, B], cost [A, B] out.
//
// What bounds it on the H100: the bytes, T (NX + 2 NU + NU NX) 4 bytes of
// reference read once a problem and A (T (NX + NU) + 1) 4 bytes written
// (1.907 ms at A = 10, 0.854 at A = 3, 262,144 problems, T = 80), and the
// candidates' RK4 arithmetic: a candidate is a serial chain of T steps as
// a rollout's, whose latency sets its time.  Design: threadIdx.x is the
// problem, 32 neighbouring ones a block, and threadIdx.y a candidate, or
// two where A is even (CHAINS: two independent chains a thread, which read
// the stage's reference once), up to FP_CANDIDATES candidates a block (more
// go in chunks of FP_CANDIDATES, a launch each).  Registers: 40 with one
// chain (more resident warps: 3-4% faster at A = 3 than the 48 the
// compiler picks), 72 with two (no spills, five blocks of 160 threads an
// SM: 7% faster at A = 10 than 64, which spilled; 48 or 56 spilled more, 80
// was 5% slower).
// A warp's stores of a stage are 128-byte rows (32 problems of one
// candidate); the warps of a block read the same reference rows within a
// few hundred cycles of each other, so device memory serves each row once
// and L1 the other warps.  The first design,
// thread l = a B + b, put a problem's candidates B threads apart, in blocks
// that ran waves apart, and read the reference from device memory once a
// candidate.  Each chain runs that design's arithmetic in its order
// (feedback_control, the cost, rk4_step with the held control: tan(delta)
// once a step, the same floats), so the outputs are its floats.
#include <cuda_runtime.h>

#include "forward_select.cuh"

namespace mas {

constexpr int FP_PROBLEMS = 32;    // problems a block (threadIdx.x)
constexpr int FP_CANDIDATES = 32;  // candidates a block at most

// One launch's chunk of candidates, passed by value: no copy to the card
// precedes the launch, so a CUDA graph can capture it.
struct FpAlphas {
  float v[FP_CANDIDATES];
};

template <typename Dyn, typename Cost, typename Term, int CHAINS>
__global__ void __maxnreg__(CHAINS == 1 ? 40 : 72) forward_pass_kernel(
    const float* __restrict__ xs, const float* __restrict__ us, const float* __restrict__ k,
    const float* __restrict__ K, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, FpAlphas alphas, int a_base, float* __restrict__ xs_out,
    float* __restrict__ us_out, float* __restrict__ cost_out, Dyn dyn, Cost cost, Term term,
    Step h, int T, int B, int A) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  static_assert(!takes_context<Cost>::value, "the forward pass takes no context");
  const int b = blockIdx.x * FP_PROBLEMS + threadIdx.x;
  const int c0 = threadIdx.y * CHAINS;   // the thread's first candidate in the chunk
  const int a0 = a_base + c0;
  // The launch takes two chains only where A is even, so a thread's chains
  // are all candidates: a0 + CHAINS - 1 < A.
  if (b >= B || a0 >= A) return;
  const size_t sB = static_cast<size_t>(B);
  const size_t sAB = static_cast<size_t>(A) * sB;
  const size_t l0 = static_cast<size_t>(a0) * sB + b;   // (a0, b) in the outputs' [A, B]
  // Picked by an unrolled loop, so that every index into the parameter is a
  // constant.
  float alpha[CHAINS];
#pragma unroll
  for (int i = 0; i < FP_CANDIDATES; ++i) {
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      if (i == c0 + c) alpha[c] = alphas.v[i];
  }

  const bool bounded = lb_in != nullptr;
  float lb[NU], ub[NU];
  if (bounded) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lb[i] = lb_in[i * sB + b];
      ub[i] = ub_in[i * sB + b];
    }
  }
  float x[CHAINS][NX], cst[CHAINS];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    cst[c] = 0.0f;
#pragma unroll
    for (int i = 0; i < NX; ++i) x[c][i] = xs[i * sB + b];
  }
  // With two chains, stage t + 1's reference is loaded in the registers the
  // feedback control has freed, while stage t's RK4 steps compute (3%
  // faster at A = 10); under one chain's 40-register bound that spilled.
  constexpr bool PREFETCH = CHAINS == 2;
  StageRef<NX, NU> s;
  if constexpr (PREFETCH) load_stage<NX, NU>(xs, us, k, K, 0, sB, b, s);
  for (int t = 0; t < T; ++t) {
    const size_t st = static_cast<size_t>(t);
    if constexpr (!PREFETCH) load_stage<NX, NU>(xs, us, k, K, t, sB, b, s);
    float u[CHAINS][NU];
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      feedback_control<NX, NU>(x[c], s.xr, s.ur, s.kt, s.Kt, alpha[c], bounded ? lb : nullptr,
                               ub, u[c]);
    if constexpr (PREFETCH) {
      if (t + 1 < T) load_stage<NX, NU>(xs, us, k, K, t + 1, sB, b, s);
    }
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      float xn[NX];
      cst[c] = cst[c] + stage_value(cost, x[c], u[c], t);
      rk4_step(dyn, x[c], control_hold(dyn, static_cast<const float*>(u[c])), h, xn);
      const size_t l = l0 + c * sB;
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        xs_out[(st * NX + i) * sAB + l] = xn[i];
        x[c][i] = xn[i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) us_out[(st * NU + i) * sAB + l] = u[c][i];
    }
  }
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) cost_out[l0 + c * sB] = cst[c] + term(x[c]);
}

template <typename Dyn, typename Cost, typename Term>
int launch_forward_pass(const float* xs, const float* us, const float* k, const float* K,
                        const float* lb, const float* ub, const float* alphas, float* xs_out,
                        float* us_out, float* cost_out, int T, int B, const float* dyn_p,
                        const float* cost_p, const float* term_p, const float* step_p, int A,
                        cudaStream_t stream) {
  if (A < 1 || B < 1 || T < 1 || (lb == nullptr) != (ub == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Term term = Term::from(term_p);
  const Step h = Step::from(step_p);
  // Two chains a thread where A is even, so that no chain idles (every
  // chunk but the last holds FP_CANDIDATES, an even count).
  const int chains = A % 2 == 0 ? 2 : 1;
  const dim3 grid((B + FP_PROBLEMS - 1) / FP_PROBLEMS);
  for (int a_base = 0; a_base < A; a_base += FP_CANDIDATES) {
    const int n = A - a_base < FP_CANDIDATES ? A - a_base : FP_CANDIDATES;
    FpAlphas al;
    for (int i = 0; i < FP_CANDIDATES; ++i) al.v[i] = i < n ? alphas[a_base + i] : 0.0f;
    const dim3 block(FP_PROBLEMS, n / chains);
    if (chains == 2)
      forward_pass_kernel<Dyn, Cost, Term, 2><<<grid, block, 0, stream>>>(
          xs, us, k, K, lb, ub, al, a_base, xs_out, us_out, cost_out, dyn, cost, term, h, T, B,
          A);
    else
      forward_pass_kernel<Dyn, Cost, Term, 1><<<grid, block, 0, stream>>>(
          xs, us, k, K, lb, ub, al, a_base, xs_out, us_out, cost_out, dyn, cost, term, h, T, B,
          A);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

// One C entry point per (dynamics, stage cost, terminal cost).  alphas (A
// floats), the device-function parameters and the step constants are host
// arrays, read at launch.
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

MAS_FORWARD_PASS(single_track__diag_quadratic__zero, mas::SingleTrack, LaneFollowCost,
                 mas::ZeroTerminal)
