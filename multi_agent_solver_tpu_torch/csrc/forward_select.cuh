// K2: the forward line search with in-kernel step-size selection.
//
// Replaces multi_agent_solver_tpu/ops/forward_select_pallas.py ::
// forward_select_pallas_tiled (kernel _make_kernel), in its two modes on
// the iLQR main path:
//
// * select (stage-out) mode.  Phase 1 rolls out every candidate alpha from
//   x_0 with u = clamp(u_ref + alpha k + K (x - x_ref)) and RK4, summing
//   the stage cost.  Selection adds the terminal cost and, from the
//   smallest alpha up, keeps the last candidate with total < merit on an
//   active problem -- the largest improving alpha.  Phase 2 re-rolls the
//   winner and writes x_0..x_{T-1}, u and x_T IN PLACE over the reference
//   buffers.  This is safe: each thread owns one problem's column and
//   reads every stage before it overwrites it.  Rejected or frozen
//   problems write nothing, so their buffers keep the reference verbatim.
//   Out: the kept merit and the accept flag.
// * rollout mode: the initial rollout and its cost -- alpha 0, zero gains,
//   no bounds, merit +inf -- writing x_1..x_T.  A cost that does not beat
//   +inf (NaN) is +inf, and once a state is not finite every later control
//   is NaN (init_control), as in the TPU kernel.  Its single candidate IS
//   the trajectory, so it is written as it is rolled out and there is no
//   phase 2.  It runs on a kernel of its own, forward_rollout_kernel
//   (below), with or without a context.
//
// Layout: batch innermost.  Select mode: xs [T, NX, B], us [T, NU, B],
// xT [NX, B] (in/out), k [T, NU, B], K [T, NU, NX, B], merit [B],
// active [B] (bool), lb / ub [NU, B] (or null: no clamp) in; merit_new [B],
// accept [B] out.  Rollout mode: x0 [NX, B], us [T, NU, B] in; xs [T, NX, B]
// (x_1..x_T), cost [B] out.
//
// Context mode (K6; a Coupled stage cost, problems.cuh; the TPU kernel's
// ctx_l, forward_select_pallas.py:79-81, 132-144): both modes also read
// ctx [T, K, C, B], the other agents' states at each stage, and the stage
// cost depends on ctx_t.  The rollout mode reads each neighbour's state
// once per stage, ROLLOUT_PAIRS of them at a time.  The select mode, with
// or without AL, runs on forward_select_group_kernel: a group of G = 4 or
// 16 lanes per problem, one candidate a lane.  Its bound at the coupled
// game's shapes (B = 64 / 256 / 1,024 cars, K = 63 / 8 / 8 neighbours,
// T = 10, 10 candidates) is 0.11-0.49 us of bytes; what it takes is the
// length of one lane's serial chain.  The one-thread mapping, built for the
// main path's 262,144 problems, put the 64-car game in one block on one SM:
// each thread walked 10 candidates x 10 stages x 63 neighbours of pair
// costs (an exp and a division each) and 100 RK4 steps in a row, its
// 16 candidates' states partly spilled.  The group mapping gives a lane one
// candidate (10 stages x 63 pairs), its state in registers; the group stages
// each tile of the context in shared memory with one load a lane, so a
// pair waits on no load; and 32-thread blocks spread 64 problems over 32
// SMs.  A lane's
// arithmetic and order are the one-thread kernel's, so every output is bit
// for bit the same.  Phase 2 evaluates no cost and reads no context.
//
// AL mode (K6's other half; the TPU kernel's eq_mult_l / ineq_mult_l /
// rho_l, forward_select_pallas.py:106-123, 170-171, 390-398): the select
// mode of an instantiation with constraint device functions Eq (M_EQ rows)
// and In (M_IN rows, problems.cuh) also reads eq_mult [T, M_EQ, B],
// ineq_mult [T, M_IN, B] and rho [B].  Phase 1 adds to every candidate's
// stage cost the AL merit terms at its (x_t, u_t): from 0, lambda g +
// (0.5 rho g) g per equality row, then (mu a) s + (0.5 rho s) s per
// inequality row with the activation a = [h > -act_tol] and s = max(h, 0) a
// (NaN kept), in the TPU kernel's order.  The multipliers do not depend on
// alpha: each stage's are read once a problem (its lanes together) and
// shared by the candidates.  Phase 2 and the rollout mode take no AL.  The
// AL mode combines with the context mode (a constrained agent of a coupled
// game; its instantiations are in
// forward_select_al_ctx.cu): a candidate's step is then the context stage
// cost, base plus pair costs, plus the AL terms -- stage first, as the TPU
// kernel sums step_cost = stage(x, u, t) + al_terms(x, u) (:167-171).
//
// Emit mode (K8; the TPU kernel's emit_lin, forward_select_pallas.py:
// 229-283, instantiated in forward_select_emit*.cu): a select mode without
// the stage-out contract, with or without a context, with or without AL
// (forward_select_emit_al.cu: the rows of forward_select_al.cu).  Every
// problem is live (no active mask), and every problem is re-rolled at its
// selected alpha (0 where none improved, which reproduces a reference that
// is itself a clamped rollout), writing the new trajectory x_1..x_T and the
// controls into fresh buffers and, at each accepted (x_t, u_t), the
// linearization in K3's layout -- A and B through the RK4 step or of the
// continuous dynamics, lx and lu, and lxx, luu, lux by second-order duals
// -- from K3's device code, so the stacks are K3's floats (the context a
// constant).  The emitted stage cost is the un-augmented one; the TPU
// kernel passes it the integer phase-2 step, K3 a float t, and the device
// costs read neither.  Its bound is its bytes: the reference read once, the
// trajectory and the stacks, 4 (NX + NU + NX NX + NX NU + NX + NU + NX NX +
// NU NU + NU NX) bytes a stage written (2.005 ms at 262,144 problems, T =
// 80).  Without a context K8 is one kernel, forward_emit_one_thread_kernel:
// a thread a problem runs the select with the A <= 16 candidates' states
// and costs in registers (candidate_step, with the AL terms), then re-rolls
// its problem at the kept alpha and linearizes each stage as the re-roll
// reaches it (emit_problem), so the candidates' arithmetic of some warps
// overlaps the stacks' stores of others; with a context it is three
// launches, the group kernel's select keeping each problem's alpha,
// forward_emit_reroll_kernel, and K3's context mode on the emitted
// trajectory (its neighbour sum spread over lanes, so the stacks are that
// launch's floats).  Measured on the H100 and not kept, without a
// context: the lane select and one kernel for the re-roll and the
// linearization, or three launches as with a context, both 3.55 ms at
// 262,144 problems, T = 80 and A = 3, against this kernel's 3.50
// (discrete) and 3.28 (continuous): apart, the select's arithmetic no
// longer overlaps the stores.  The reference is read twice, by the select
// and by the re-roll.
//
// What bounds it on the H100: the arithmetic of A + 1 sequential RK4
// rollouts per problem (12 sin/cos/tan a step) and the reads of the
// reference and the gains in both phases (T (NX + 2 NU + NU NX) 4 bytes a
// phase; the AL mode adds T (M_EQ + M_IN) 4 bytes of multipliers to phase
// 1 and about 10 operations a row per candidate and stage).  Designs:
// * the select without a context, with or without AL (the main path's, the
//   sweep's, the non-fused path's, the AL solves'),
//   forward_select_lanes_kernel: a lane a candidate, the A lanes of a
//   problem packed side by side in a warp, selection by a ballot, and phase
//   2 in a second launch, forward_select_reroll_kernel, a thread an
//   accepted problem.  At 262,144 problems and T = 80 phase 1 is bound by
//   its issue slots (the candidates' arithmetic on 30 of 32 lanes at A =
//   10) and phase 2 by its bytes: it reads the reference and the gains
//   again and writes the trajectory.  The one-thread kernel it replaced
//   kept A <= 16 candidates in registers and spilled at A > 4;
// * the context select (above): forward_select_group_kernel;
// * the emit mode: forward_emit_one_thread_kernel, or with a context the
//   group select, forward_emit_reroll_kernel and K3 (above);
// * the rollout mode: forward_rollout_kernel, one thread a problem, the t
//   loop inside it.  Its bound at the main path's 262,144 problems and T =
//   80 is its bytes, 4 (NX + T (NU + NX) + 1) a problem (0.152 ms), and
//   every thread runs one serial chain of T RK4 steps, each stage about 320
//   SASS instructions (four sincosf, a tanf, four IEEE divisions: an issue
//   floor of 0.20 ms).  The design keeps each chain fed: restrict pointers
//   and u_{t+1} loaded while stage t computes (the stage waits on no
//   load); tan(delta) once a step (the held control); and with a context
//   the neighbours ROLLOUT_PAIRS at a time, the next group's loads issued
//   before this group's pair costs, which are independent of each other
//   and summed in index order.  Measured on the H100 and not kept: 32
//   registers a thread, so that 262,144 problems are one wave (2,048
//   threads an SM), spilled 32 bytes and was 5% slower than 48 registers
//   in 1.55 waves; 32-thread blocks for the games' 64-1,024 problems ran
//   as fast as 128-thread ones.
// Every select kernel runs a candidate's stage through one device
// function, candidate_step, and the in-place re-roll through
// reroll_in_place, so a candidate's arithmetic and its order are the same
// in all of them and the outputs the same floats.  The rollout kernel runs
// the stage of the one-thread kernel it replaced in that kernel's order
// (init_control's control, the stage cost -- base, then the pair costs
// from neighbour 0 up --, the RK4 step), so it gives that kernel's floats.
#pragma once

#include <cuda_runtime.h>

#include "linearize.cuh"
#include "problems.cuh"

namespace mas {

constexpr int MAX_ALPHAS = 16;
struct Alphas {
  float v[MAX_ALPHAS];
  int n;
};

// u = clamp(u_ref + alpha k + K (x - x_ref)), in the TPU kernel's order.
template <int NX, int NU>
__device__ __forceinline__ void feedback_control(
    const float* x, const float* xr, const float* ur, const float* kt,
    const float (&Kt)[NU][NX], float alpha, const float* lb, const float* ub, float* u) {
  float dx[NX];
#pragma unroll
  for (int j = 0; j < NX; ++j) dx[j] = x[j] - xr[j];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = Kt[i][0] * dx[0];
#pragma unroll
    for (int j = 1; j < NX; ++j) s = s + Kt[i][j] * dx[j];
    float ui = (ur[i] + alpha * kt[i]) + s;
    if (lb != nullptr) ui = clamp_nan(ui, lb[i], ub[i]);
    u[i] = ui;
  }
}

// Stage t's reference (x_t, u_t), feedforward k_t and gain K_t of a problem.
template <int NX, int NU>
struct StageRef {
  float xr[NX], ur[NU], kt[NU], Kt[NU][NX];
};

// Stage t's StageRef of problem b.
template <int NX, int NU>
__device__ __forceinline__ void load_stage(const float* xs, const float* us, const float* k,
                                           const float* K, int t, size_t sB, int b,
                                           StageRef<NX, NU>& s) {
#pragma unroll
  for (int i = 0; i < NU; ++i) s.ur[i] = us[(static_cast<size_t>(t) * NU + i) * sB + b];
#pragma unroll
  for (int i = 0; i < NX; ++i) s.xr[i] = xs[(static_cast<size_t>(t) * NX + i) * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    s.kt[i] = k[(static_cast<size_t>(t) * NU + i) * sB + b];
#pragma unroll
    for (int j = 0; j < NX; ++j)
      s.Kt[i][j] = K[((static_cast<size_t>(t) * NU + i) * NX + j) * sB + b];
  }
}

// The rollout mode's control: u_ref as it is, until the state stops being
// finite.  The TPU kernel computes it as u_ref + 0 k + 0 (x - x_0) (alpha
// 0, zero gains, the reference x_0 at every stage), so from a stage whose
// state holds a NaN or an infinity on, every control is NaN; this does
// the same.
template <int NX, int NU>
__device__ __forceinline__ void init_control(const float* x, const float* x0, const float* ur,
                                             float* u) {
  float s = 0.0f * (x[0] - x0[0]);
#pragma unroll
  for (int j = 1; j < NX; ++j) s = s + 0.0f * (x[j] - x0[j]);
#pragma unroll
  for (int i = 0; i < NU; ++i) u[i] = ur[i] + s;
}

// The AL merit terms of one candidate at (x, u), given the stage's
// multipliers and 0.5 rho.
template <int NX, int NU, typename Eq, typename In>
__device__ __forceinline__ float al_terms(const Eq& eq, const In& in, const float* x,
                                          const float* u, const float* lam_eq,
                                          const float* lam_in, float half_rho, float act_tol) {
  float total = 0.0f;
  if constexpr (Eq::M > 0) {
    float g[Eq::M];
    eq.template eval<NX, NU>(x, u, g);
#pragma unroll
    for (int m = 0; m < Eq::M; ++m) total = (total + lam_eq[m] * g[m]) + (half_rho * g[m]) * g[m];
  }
  if constexpr (In::M > 0) {
    float hv[In::M];
    in.template eval<NX, NU>(x, u, hv);
#pragma unroll
    for (int m = 0; m < In::M; ++m) {
      const float on = hv[m] > -act_tol ? 1.0f : 0.0f;
      const float s = max0_nan(hv[m]) * on;
      total = (total + (lam_in[m] * on) * s) + (half_rho * s) * s;
    }
  }
  return total;
}

// The AL inputs of one stage of a problem: the stage's multipliers (shared
// by the candidates), 0.5 rho and the activation tolerance.  Unread without
// constraint rows.
template <int MEQ, int MIN>
struct AlStage {
  float lam_eq[MEQ > 0 ? MEQ : 1], lam_in[MIN > 0 ? MIN : 1];
  float half_rho = 0.0f, act_tol = 0.0f;
};

template <int MEQ, int MIN>
__device__ __forceinline__ void load_multipliers(const float* eq_mult, const float* ineq_mult,
                                                 int t, size_t sB, int b, AlStage<MEQ, MIN>& al) {
#pragma unroll
  for (int m = 0; m < MEQ; ++m) al.lam_eq[m] = eq_mult[(static_cast<size_t>(t) * MEQ + m) * sB + b];
#pragma unroll
  for (int m = 0; m < MIN; ++m)
    al.lam_in[m] = ineq_mult[(static_cast<size_t>(t) * MIN + m) * sB + b];
}

// One candidate's stage step, the arithmetic every select kernel runs for a
// candidate: its feedback control at x and alpha, its step cost at (x, u)
// -- the stage cost (a context cost: base + ps, the pair costs that the
// caller sums over the neighbours in its own layout) plus, in the AL mode,
// the AL terms, stage first; a cost with TAKES_STAGE sees the integer stage
// index t -- and x advanced in place by one RK4 step,
// its control held (control_hold: tan(delta) once a step, the floats of f
// at the control).  Returns the step cost.
template <typename Dyn, typename Cost, typename Eq, typename In>
__device__ __forceinline__ float candidate_step(
    const Dyn& dyn, const Cost& cost, const Eq& eq, const In& in, const Step& h,
    const StageRef<Dyn::NX, Dyn::NU>& s, const AlStage<Eq::M, In::M>& al, float alpha,
    const float* lb, const float* ub, float ps, int t, float* x) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  float u[NU];
  feedback_control<NX, NU>(x, s.xr, s.ur, s.kt, s.Kt, alpha, lb, ub, u);
  float step;
  if constexpr (takes_context<Cost>::value)
    step = cost.base(x, u) + ps;
  else
    step = stage_value(cost, x, u, t);
  if constexpr (Eq::M + In::M > 0)
    step = step + al_terms<NX, NU>(eq, in, x, u, al.lam_eq, al.lam_in, al.half_rho, al.act_tol);
  float xn[NX];
  rk4_step(dyn, x, control_hold(dyn, static_cast<const float*>(u)), h, xn);
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xn[i];
  return step;
}

// Phase 2 of the select mode for problem b: the feedback rollout at the
// selected alpha from its x_0, writing x_0..x_{T-1}, u and x_T in place
// over the reference.  Each stage is read before it is overwritten, and
// only this thread touches problem b's column.
template <typename Dyn>
__device__ __forceinline__ void reroll_in_place(const Dyn& dyn, const Step& h, float* xs,
                                                float* us, float* xT, const float* k,
                                                const float* K, const float* lb, const float* ub,
                                                float sel, int T, size_t sB, int b) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[i * sB + b];
  for (int t = 0; t < T; ++t) {
    StageRef<NX, NU> s;
    load_stage<NX, NU>(xs, us, k, K, t, sB, b, s);
    float u[NU], xn[NX];
    feedback_control<NX, NU>(x, s.xr, s.ur, s.kt, s.Kt, sel, lb, ub, u);
    rk4_step(dyn, x, control_hold(dyn, static_cast<const float*>(u)), h, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) xs[(static_cast<size_t>(t) * NX + i) * sB + b] = x[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) us[(static_cast<size_t>(t) * NU + i) * sB + b] = u[i];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) xT[i * sB + b] = x[i];
}

// K2's rollout mode (design in the header): thread b rolls problem b out
// from x_0 under its controls, writing x_1..x_T [T, NX, B] and the cost
// [B]; with a context, the neighbours' pair costs in groups of
// ROLLOUT_PAIRS.
constexpr int ROLLOUT_BLOCK = 128;
constexpr int ROLLOUT_PAIRS = 8;

// The pair costs of x against the neighbours of one stage, summed from 0 in
// index order, one neighbour at a time, as the select kernels sum them.
// The pairs are evaluated ROLLOUT_PAIRS at a time, independent of each
// other, with the next group's loads issued before this group's
// arithmetic; a group's slots past the last neighbour are evaluated on
// zeros and not summed.
template <typename Cost>
__device__ __forceinline__ float pair_sum(const Cost& cost, const CtxView& cv, const float* x) {
  constexpr int NC = Cost::PairT::NCTX, G = ROLLOUT_PAIRS;
  float cur[G][NC], nxt[G][NC];
#pragma unroll
  for (int q = 0; q < G; ++q)
#pragma unroll
    for (int c = 0; c < NC; ++c) cur[q][c] = q < cv.K ? cv.at(q, c) : 0.0f;
  float ps = 0.0f;
#pragma unroll 1
  for (int j0 = 0; j0 < cv.K; j0 += G) {
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c) nxt[q][c] = j0 + G + q < cv.K ? cv.at(j0 + G + q, c) : 0.0f;
    float p[G];
#pragma unroll
    for (int q = 0; q < G; ++q) p[q] = cost.pair(x, cur[q]);
#pragma unroll
    for (int q = 0; q < G; ++q)
      if (j0 + q < cv.K) ps = ps + p[q];
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c) cur[q][c] = nxt[q][c];
  }
  return ps;
}

template <typename Dyn, typename Cost, typename Term>
__global__ void __launch_bounds__(ROLLOUT_BLOCK) forward_rollout_kernel(
    const float* __restrict__ x0, const float* __restrict__ us, float* __restrict__ xs_out,
    float* __restrict__ cost_out, const float* __restrict__ ctx, Dyn dyn, Cost cost, Term term,
    Step h, int T, int B, int n_ctx, int c_ctx) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  float xstart[NX], x[NX], ur[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xstart[i] = x0[i * sB + b];
#pragma unroll
  for (int i = 0; i < NU; ++i) ur[i] = us[i * sB + b];
  float c = 0.0f;
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    float u[NU];
    init_control<NX, NU>(x, xstart, ur, u);
    // u_{t+1}'s load, issued before stage t's arithmetic.
    if (t + 1 < T) {
#pragma unroll
      for (int i = 0; i < NU; ++i) ur[i] = us[(static_cast<size_t>(t + 1) * NU + i) * sB + b];
    }
    float step;
    if constexpr (takes_context<Cost>::value)
      step = cost.base(x, u) + pair_sum(cost, ctx_view(ctx, t, n_ctx, c_ctx, sB, b), x);
    else
      step = stage_value(cost, x, u, t);
    c = c + step;
    float xn[NX];
    rk4_step(dyn, x, control_hold(dyn, static_cast<const float*>(u)), h, xn);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      x[i] = xn[i];
      xs_out[(static_cast<size_t>(t) * NX + i) * sB + b] = xn[i];
    }
  }
  const float total = c + term(x);
  cost_out[b] = total < INFINITY ? total : INFINITY;
}

// K6's context select: the select mode of a Coupled stage cost, with or
// without AL, for a group of G lanes per problem, lane a running candidate
// a (G = 4 or 16, as the one-thread kernel's MAXA; lanes a >= A run alpha 0
// and never win).  A lane runs candidate_step, as the one-thread kernel
// does, so its cost is the same float; the lanes of a group read
// the same reference, gains and multipliers (broadcast loads), and stage
// the context in shared memory, up to SELECT_CTX_TILE neighbours at a time,
// each lane loading a share of them at once.  Selection: the lowest lane
// whose total beats the merit on a live problem -- the serial loop's
// largest improving alpha -- from a ballot of the group.  Phase 2: the
// winning lane re-rolls its candidate and writes the stage layout in place;
// every lane of the group has read its last reference value before the
// ballot.
constexpr int SELECT_GROUP_BLOCK = 32;
constexpr int SELECT_CTX_TILE = 64;

template <typename Dyn, typename Cost, typename Term, typename Eq, typename In, int G>
__global__ void __launch_bounds__(SELECT_GROUP_BLOCK) forward_select_group_kernel(
    float* xs, float* us, float* xT, const float* __restrict__ k, const float* __restrict__ K,
    const float* __restrict__ merit, const bool* __restrict__ active,
    const float* __restrict__ lb_in, const float* __restrict__ ub_in,
    float* __restrict__ cost_out, bool* __restrict__ accept_out, float* __restrict__ alpha_out,
    const float* __restrict__ ctx, const float* __restrict__ eq_mult,
    const float* __restrict__ ineq_mult, const float* __restrict__ rho, float act_tol, Dyn dyn,
    Cost cost, Term term, Eq eq, In in, Step h, Alphas alphas, int T, int B, int n_ctx,
    int c_ctx) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU, NCTX = Cost::PairT::NCTX;
  constexpr int PER_LANE = SELECT_CTX_TILE * NCTX / G;   // a lane's share of a tile
  constexpr bool AL = Eq::M + In::M > 0;
  static_assert(takes_context<Cost>::value, "the group kernel is the context select");
  static_assert(G <= MAX_ALPHAS && 32 % G == 0, "a group is a power of two within a warp");
  static_assert(SELECT_CTX_TILE * NCTX % G == 0, "a tile splits evenly over the lanes");
  __shared__ float tiles[SELECT_GROUP_BLOCK / G][SELECT_CTX_TILE * NCTX];
  const int b = blockIdx.x * (SELECT_GROUP_BLOCK / G) + threadIdx.x / G;
  if (b >= B) return;  // the whole group leaves: its lanes share b
  const int a = threadIdx.x % G;
  float* tile = tiles[threadIdx.x / G];
  const unsigned mask = group_mask<G>();
  const size_t sB = static_cast<size_t>(B);
  AlStage<Eq::M, In::M> al;
  if constexpr (AL) {
    al.half_rho = 0.5f * rho[b];
    al.act_tol = act_tol;
  }

  float lb[NU], ub[NU];
  const bool bounded = lb_in != nullptr;
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

  // Phase 1: this lane's candidate.
  const float alpha = alphas.v[a];
  float c = 0.0f;
  for (int t = 0; t < T; ++t) {
    // The pair costs from neighbour 0 up, as the one-thread kernel sums
    // them; the stage's reference is loaded after them, so that it is not
    // live across the pair loop.
    const CtxView cv = ctx_view(ctx, t, n_ctx, c_ctx, sB, b);
    float ps = 0.0f;
    for (int j0 = 0; j0 < cv.K; j0 += SELECT_CTX_TILE) {
      const int n = (cv.K - j0 < SELECT_CTX_TILE ? cv.K - j0 : SELECT_CTX_TILE) * NCTX;
      float v[PER_LANE];
#pragma unroll
      for (int r = 0; r < PER_LANE; ++r) {
        const int e = a + r * G;
        v[r] = e < n ? cv.at(j0 + e / NCTX, e % NCTX) : 0.0f;
      }
      __syncwarp(mask);  // the group is done with the last tile
#pragma unroll
      for (int r = 0; r < PER_LANE; ++r)
        if (a + r * G < n) tile[a + r * G] = v[r];
      __syncwarp(mask);
#pragma unroll 4
      for (int j = 0; j < n / NCTX; ++j) ps = ps + cost.pair(x, tile + j * NCTX);
    }
    StageRef<NX, NU> s;
    load_stage<NX, NU>(xs, us, k, K, t, sB, b, s);
    load_multipliers(eq_mult, ineq_mult, t, sB, b, al);
    c = c + candidate_step(dyn, cost, eq, in, h, s, al, alpha, bounded ? lb : nullptr, ub, ps,
                           t, x);
  }

  // Selection by ballot: bit a of `wins` is candidate a's `total < merit`
  // on a live problem (NaN never wins); the lowest set bit is the largest
  // improving alpha.
  const float m = merit[b];
  const bool mine = a < alphas.n;
  const float total = c + term(x);
  const int base = (threadIdx.x & 31) & ~(G - 1);
  const unsigned wins =
      (__ballot_sync(mask, mine && (active == nullptr || active[b]) && total < m) >> base) &
      (mask >> base);
  const int win = wins != 0u ? __ffs(wins) - 1 : 0;
  const float best = __shfl_sync(mask, total, win, G);
  if (a == 0) {
    cost_out[b] = wins != 0u ? best : m;
    accept_out[b] = wins != 0u;
  }
  if (alpha_out != nullptr) {
    // K8's select: the kept alpha (0 where none improved) for its re-roll
    // launch, and nothing written in place.
    if (a == 0) alpha_out[b] = wins != 0u ? alphas.v[win] : 0.0f;
    return;
  }
  if (wins == 0u || a != win) return;

  // Phase 2: the winner re-rolls its candidate, writing the stage layout in
  // place.
  reroll_in_place(dyn, h, xs, us, xT, k, K, bounded ? lb : nullptr, ub, alpha, T, sB, b);
}

// The select without a context, K2's and (Eq / In with rows) K6's AL mode
// (the lane-follow and circular-track instantiations, with or without
// bounds, and the lane-follow cost's constraint rows), built for the main
// path's batches, where a launch is throughput-bound.  One lane a
// candidate, the A lanes of a problem packed side by side: 32 / A problems
// a warp (A = 10: three, lanes 30-31 idle; A = 3: ten), lane g A + a running
// candidate a of the warp's problem g.  A lane keeps one candidate's state
// and cost in registers and runs candidate_step for it, with the AL terms
// in the AL mode, so its total is the one-thread kernel's float; the lanes
// of a problem load its reference, gains, bounds and multipliers together
// (one address a group; the multipliers do not depend on alpha), and each
// sets 0.5 rho from its problem's rho.  Selection: bit g A + a of a warp
// ballot is candidate a's `total < merit` on a live problem; the lowest of
// problem g's A bits wins, the serial loop's largest improving alpha.  The
// group's first lane writes the merit, the accept flag and the kept alpha
// (alpha_out [B]); forward_select_reroll_kernel, launched next, re-rolls
// the accepted problems one thread each, where one lane of a group would
// leave the other A - 1 idle for a whole rollout.
constexpr int SELECT_LANES_BLOCK = 128;

template <typename Dyn, typename Cost, typename Term, typename Eq, typename In>
__global__ void __launch_bounds__(SELECT_LANES_BLOCK) forward_select_lanes_kernel(
    const float* __restrict__ xs, const float* __restrict__ us, const float* __restrict__ k,
    const float* __restrict__ K, const float* __restrict__ merit,
    const bool* __restrict__ active, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, float* __restrict__ cost_out,
    bool* __restrict__ accept_out, float* __restrict__ alpha_out,
    const float* __restrict__ eq_mult, const float* __restrict__ ineq_mult,
    const float* __restrict__ rho, float act_tol, Dyn dyn, Cost cost, Term term, Eq eq, In in,
    Step h, Alphas alphas, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  static_assert(!takes_context<Cost>::value, "the context select is forward_select_group_kernel");
  const int A = alphas.n;
  const int per_warp = 32 / A;
  const int lane = threadIdx.x & 31;
  const int g = lane / A, a = lane - g * A;
  const int b = ((blockIdx.x * SELECT_LANES_BLOCK + threadIdx.x) >> 5) * per_warp + g;
  // Idle lanes and the tail's lanes take part in the ballot only.
  const bool mine = g < per_warp && b < B;
  const size_t sB = static_cast<size_t>(B);

  // Phase 1: this lane's candidate.
  float x[NX], c = 0.0f;
  if (mine) {
    float lb[NU], ub[NU];
    const bool bounded = lb_in != nullptr;
    if (bounded) {
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        lb[i] = lb_in[i * sB + b];
        ub[i] = ub_in[i * sB + b];
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xs[i * sB + b];
    const float alpha = alphas.v[a];
    AlStage<Eq::M, In::M> al;
    if constexpr (Eq::M + In::M > 0) {
      al.half_rho = 0.5f * rho[b];
      al.act_tol = act_tol;
    }
    for (int t = 0; t < T; ++t) {
      StageRef<NX, NU> s;
      load_stage<NX, NU>(xs, us, k, K, t, sB, b, s);
      load_multipliers(eq_mult, ineq_mult, t, sB, b, al);
      c = c + candidate_step(dyn, cost, eq, in, h, s, al, alpha, bounded ? lb : nullptr, ub,
                             0.0f, t, x);
    }
  }

  const float total = mine ? c + term(x) : 0.0f;
  const float m = mine ? merit[b] : 0.0f;
  const unsigned ballot = __ballot_sync(0xffffffffu, mine && active[b] && total < m);
  const unsigned wins = mine ? (ballot >> (g * A)) & ((1u << A) - 1u) : 0u;
  const int win = wins != 0u ? __ffs(wins) - 1 : 0;
  const float best = __shfl_sync(0xffffffffu, total, mine ? g * A + win : lane);
  if (mine && a == 0) {
    cost_out[b] = wins != 0u ? best : m;
    accept_out[b] = wins != 0u;
    alpha_out[b] = alphas.v[win];
  }
}

// Phase 2 of forward_select_lanes_kernel's select, one thread a problem:
// an accepted problem re-rolls at its kept alpha, in place.
template <typename Dyn>
__global__ void __launch_bounds__(128) forward_select_reroll_kernel(
    float* xs, float* us, float* xT, const float* __restrict__ k, const float* __restrict__ K,
    const float* __restrict__ lb_in, const float* __restrict__ ub_in,
    const bool* __restrict__ accept, const float* __restrict__ alpha_sel, Dyn dyn, Step h,
    int T, int B) {
  constexpr int NU = Dyn::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B || !accept[b]) return;
  const size_t sB = static_cast<size_t>(B);
  float lb[NU], ub[NU];
  const bool bounded = lb_in != nullptr;
  if (bounded) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lb[i] = lb_in[i * sB + b];
      ub[i] = ub_in[i * sB + b];
    }
  }
  reroll_in_place(dyn, h, xs, us, xT, k, K, bounded ? lb : nullptr, ub, alpha_sel[b], T, sB, b);
}

// K8's outputs: the new trajectory x_1..x_T [T, NX, B], the controls
// [T, NU, B] and the linearization stacks in K3's layout.
struct EmitOut {
  float *xs = nullptr, *us = nullptr;
  LinOut lin;
};

// K8's re-roll of problem b at its kept alpha sel (0 where none improved)
// from x_0, as reroll_in_place's chain, writing x_1..x_T and the controls
// to the fresh EmitOut buffers; with LINEARIZE (no context), each stage's
// (x_t, u_t) linearized as soon as the re-roll reaches it, by K3's device
// code (linearize_stage), so the stacks are K3's floats.  A warp writes one
// stage of 32 neighbouring problems, coalesced; the reference is only read.
template <bool LINEARIZE, bool DISCRETE, typename Dyn, typename Cost>
__device__ __forceinline__ void emit_problem(const float* __restrict__ xs,
                                             const float* __restrict__ us,
                                             const float* __restrict__ k,
                                             const float* __restrict__ K, const float* lb,
                                             const float* ub, float sel, const EmitOut& emit,
                                             const Dyn& dyn, const Cost& cost, const Step& h,
                                             int T, size_t sB, int b) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = xs[i * sB + b];
#pragma unroll 1
  for (int t = 0; t < T; ++t) {
    StageRef<NX, NU> s;
    load_stage<NX, NU>(xs, us, k, K, t, sB, b, s);
    float u[NU], xn[NX];
    feedback_control<NX, NU>(x, s.xr, s.ur, s.kt, s.Kt, sel, lb, ub, u);
    rk4_step(dyn, x, control_hold(dyn, static_cast<const float*>(u)), h, xn);
    const size_t st = static_cast<size_t>(t);
#pragma unroll
    for (int i = 0; i < NX; ++i) emit.xs[(st * NX + i) * sB + b] = xn[i];
#pragma unroll
    for (int i = 0; i < NU; ++i) emit.us[(st * NU + i) * sB + b] = u[i];
    if constexpr (LINEARIZE)
      linearize_stage<true, DISCRETE>(dyn, cost, h, x, u, st, sB, static_cast<size_t>(b),
                                      emit.lin);
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
}

// K8's re-roll with a context, one thread a problem, at the group select's
// kept alphas (emit_problem without the linearization, which K3's context
// mode does next).
template <typename Dyn, typename Cost>
__global__ void __launch_bounds__(128) forward_emit_reroll_kernel(
    const float* __restrict__ xs, const float* __restrict__ us, const float* __restrict__ k,
    const float* __restrict__ K, const float* __restrict__ lb_in,
    const float* __restrict__ ub_in, const float* __restrict__ alpha_sel, EmitOut emit,
    Dyn dyn, Cost cost, Step h, int T, int B) {
  constexpr int NU = Dyn::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  float lb[NU], ub[NU];
  const bool bounded = lb_in != nullptr;
  if (bounded) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lb[i] = lb_in[i * sB + b];
      ub[i] = ub_in[i * sB + b];
    }
  }
  emit_problem<false, true>(xs, us, k, K, bounded ? lb : nullptr, ub, alpha_sel[b], emit, dyn,
                            cost, h, T, sB, b);
}

// K8 in one kernel without a context, one thread a problem: phase 1 with
// the A <= MAXA candidates' states and costs in registers (candidate_step,
// the AL terms where the instantiation has rows), the selection, then
// emit_problem at the kept alpha (0 where none improved).  Five blocks an
// SM (at most 102 registers; the discrete mode takes 115 unbounded): 3%
// faster in the discrete mode; six (85) spilled and were slower.
template <typename Dyn, typename Cost, typename Term, typename Eq, typename In, int MAXA,
          bool DISCRETE>
__global__ void __launch_bounds__(128, 5) forward_emit_one_thread_kernel(
    const float* __restrict__ xs, const float* __restrict__ us, const float* __restrict__ k,
    const float* __restrict__ K, const float* __restrict__ merit,
    const float* __restrict__ lb_in, const float* __restrict__ ub_in,
    float* __restrict__ cost_out, bool* __restrict__ accept_out,
    const float* __restrict__ eq_mult, const float* __restrict__ ineq_mult,
    const float* __restrict__ rho, float act_tol, EmitOut emit, Dyn dyn, Cost cost, Term term,
    Eq eq, In in, Step h, Alphas alphas, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  static_assert(!takes_context<Cost>::value, "with a context K8 launches K3's context mode");
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int A = alphas.n;
  float lb[NU], ub[NU];
  const bool bounded = lb_in != nullptr;
  if (bounded) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lb[i] = lb_in[i * sB + b];
      ub[i] = ub_in[i * sB + b];
    }
  }
  AlStage<Eq::M, In::M> al;
  if constexpr (Eq::M + In::M > 0) {
    al.half_rho = 0.5f * rho[b];
    al.act_tol = act_tol;
  }
  float xa[MAXA][NX], ca[MAXA];
#pragma unroll
  for (int a = 0; a < MAXA; ++a) {
    ca[a] = 0.0f;
#pragma unroll
    for (int i = 0; i < NX; ++i) xa[a][i] = xs[i * sB + b];
  }
  for (int t = 0; t < T; ++t) {
    StageRef<NX, NU> s;
    load_stage<NX, NU>(xs, us, k, K, t, sB, b, s);
    load_multipliers(eq_mult, ineq_mult, t, sB, b, al);
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      if (a >= A) break;
      ca[a] = ca[a] + candidate_step(dyn, cost, eq, in, h, s, al, alphas.v[a],
                                     bounded ? lb : nullptr, ub, 0.0f, t, xa[a]);
    }
  }
  // Smallest alpha first, so the largest improving one wins.
  const float m = merit[b];
  float best = m, sel = 0.0f;
  bool found = false;
#pragma unroll
  for (int a = MAXA - 1; a >= 0; --a) {
    if (a >= A) continue;
    const float total = ca[a] + term(xa[a]);
    if (total < m) {
      sel = alphas.v[a];
      best = total;
      found = true;
    }
  }
  cost_out[b] = best;
  accept_out[b] = found;
  emit_problem<true, DISCRETE>(xs, us, k, K, bounded ? lb : nullptr, ub, sel, emit, dyn, cost,
                               h, T, sB, b);
}

// The pointers and scalars of one launch.
struct Args {
  const float* x0;
  float *xs, *us, *xT;
  const float *k, *K, *merit;
  const bool* active;
  const float *lb, *ub;
  float* cost_out;
  bool* accept_out;
  float* alpha_out;   // the lane select's kept alphas [B] (scratch)
  const float *ctx, *eq_mult, *ineq_mult, *rho;
  float act_tol;
  int T, B, n_ctx, c_ctx;
};

template <typename Dyn, typename Cost, typename Term>
void launch_rollout(const Args& a, const Dyn& dyn, const Cost& cost, const Term& term,
                    const Step& h, cudaStream_t stream) {
  const int grid = (a.B + ROLLOUT_BLOCK - 1) / ROLLOUT_BLOCK;
  forward_rollout_kernel<Dyn, Cost, Term><<<grid, ROLLOUT_BLOCK, 0, stream>>>(
      a.x0, a.us, a.xs, a.cost_out, a.ctx, dyn, cost, term, h, a.T, a.B, a.n_ctx, a.c_ctx);
}

template <typename Dyn, typename Cost, typename Term, typename Eq, typename In, int G>
void launch_group(const Args& a, const Dyn& dyn, const Cost& cost, const Term& term,
                  const Eq& eq, const In& in, const Step& h, const Alphas& al,
                  cudaStream_t stream) {
  constexpr int per_block = SELECT_GROUP_BLOCK / G;
  const int grid = (a.B + per_block - 1) / per_block;
  forward_select_group_kernel<Dyn, Cost, Term, Eq, In, G><<<grid, SELECT_GROUP_BLOCK, 0, stream>>>(
      a.xs, a.us, a.xT, a.k, a.K, a.merit, a.active, a.lb, a.ub, a.cost_out, a.accept_out,
      a.alpha_out, a.ctx, a.eq_mult, a.ineq_mult, a.rho, a.act_tol, dyn, cost, term, eq, in, h, al,
      a.T, a.B, a.n_ctx, a.c_ctx);
}

// The lane select, then the re-roll of its accepted problems.
template <typename Dyn, typename Cost, typename Term, typename Eq, typename In>
void launch_lanes(const Args& a, const Dyn& dyn, const Cost& cost, const Term& term,
                  const Eq& eq, const In& in, const Step& h, const Alphas& al,
                  cudaStream_t stream) {
  const int per_warp = 32 / al.n;
  const long long lanes = (static_cast<long long>(a.B) + per_warp - 1) / per_warp * 32;
  const int grid = static_cast<int>((lanes + SELECT_LANES_BLOCK - 1) / SELECT_LANES_BLOCK);
  forward_select_lanes_kernel<Dyn, Cost, Term, Eq, In><<<grid, SELECT_LANES_BLOCK, 0, stream>>>(
      a.xs, a.us, a.k, a.K, a.merit, a.active, a.lb, a.ub, a.cost_out, a.accept_out, a.alpha_out,
      a.eq_mult, a.ineq_mult, a.rho, a.act_tol, dyn, cost, term, eq, in, h, al, a.T, a.B);
  const int block = 128;
  forward_select_reroll_kernel<Dyn><<<(a.B + block - 1) / block, block, 0, stream>>>(
      a.xs, a.us, a.xT, a.k, a.K, a.lb, a.ub, a.accept_out, a.alpha_out, dyn, h, a.T, a.B);
}

// Do the context and the AL inputs fit the instantiation?  A context
// exactly with a Coupled stage cost; multipliers and rho exactly with
// constraint rows, m_eq = Eq::M and m_in = In::M.
template <typename Dyn, typename Cost, typename Eq, typename In>
bool args_fit(const Args& args, int m_eq, int m_in, const Eq& eq, const In& in) {
  constexpr bool AL = Eq::M + In::M > 0;
  if (takes_context<Cost>::value != (args.ctx != nullptr) || args.n_ctx < 0 ||
      (args.ctx != nullptr && args.c_ctx < Dyn::NX))
    return false;
  return m_eq == Eq::M && m_in == In::M && (Eq::M > 0) == (args.eq_mult != nullptr) &&
         (In::M > 0) == (args.ineq_mult != nullptr) && AL == (args.rho != nullptr) &&
         eq.ok(Dyn::NX, Dyn::NU) && in.ok(Dyn::NX, Dyn::NU);
}

// init != 0: rollout mode (x0, us -> xs = x_1..x_T, cost) on the rollout
// kernel, with or without a context; alphas unused; refused with AL.
// init == 0: select mode: without a context, with or without AL, on the
// lane kernel (a lane a candidate; alpha_out [B] its scratch), with a
// context on the group kernel (lanes a group, sized 4 or 16 by n_alphas).
// ctx [T, n_ctx, c_ctx, B] is read only by a Coupled stage cost; eq_mult
// [T, m_eq, B], ineq_mult [T, m_in, B] and rho [B] only by an AL
// instantiation (select mode; m_eq = Eq::M and m_in = In::M).
template <typename Dyn, typename Cost, typename Term, typename Eq, typename In>
int launch_forward_select(int init, const Args& args, int m_eq, int m_in, const float* dyn_p,
                          const float* cost_p, const float* term_p, const float* eq_p,
                          const float* in_p, const float* step_p, const float* alphas,
                          int n_alphas, cudaStream_t stream) {
  constexpr bool AL = Eq::M + In::M > 0;
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Term term = Term::from(term_p);
  const Eq eq = Eq::from(eq_p);
  const In in = In::from(in_p);
  const Step h = Step::from(step_p);
  Alphas al;
  al.n = init ? 1 : n_alphas;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (al.n < 1 || al.n > MAX_ALPHAS) return bad;
  if (!args_fit<Dyn, Cost>(args, m_eq, m_in, eq, in)) return bad;
  for (int a = 0; a < MAX_ALPHAS; ++a) al.v[a] = (!init && a < al.n) ? alphas[a] : 0.0f;
  if constexpr (takes_context<Cost>::value) {
    // The context select, with or without AL, runs on the group kernel.
    if (init) {
      if constexpr (AL)
        return bad;
      else
        launch_rollout<Dyn, Cost, Term>(args, dyn, cost, term, h, stream);
    } else if (al.n <= 4) {
      launch_group<Dyn, Cost, Term, Eq, In, 4>(args, dyn, cost, term, eq, in, h, al, stream);
    } else {
      launch_group<Dyn, Cost, Term, Eq, In, MAX_ALPHAS>(args, dyn, cost, term, eq, in, h, al,
                                                        stream);
    }
  } else {
    // The select, with or without AL, runs on the lane kernel and its
    // re-roll (alpha_out: the caller's [B] scratch).
    if (init) {
      if constexpr (AL)
        return bad;
      else
        launch_rollout<Dyn, Cost, Term>(args, dyn, cost, term, h, stream);
    } else {
      if (args.alpha_out == nullptr) return bad;
      launch_lanes<Dyn, Cost, Term, Eq, In>(args, dyn, cost, term, eq, in, h, al, stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename Dyn, typename Cost, typename Term, typename Eq, typename In, int MAXA>
void launch_emit_one_thread(const Args& a, const EmitOut& emit, int discrete, const Dyn& dyn,
                            const Cost& cost, const Term& term, const Eq& eq, const In& in,
                            const Step& h, const Alphas& al, cudaStream_t stream) {
  const int block = 128, grid = (a.B + block - 1) / block;
  if (discrete)
    forward_emit_one_thread_kernel<Dyn, Cost, Term, Eq, In, MAXA, true>
        <<<grid, block, 0, stream>>>(a.xs, a.us, a.k, a.K, a.merit, a.lb, a.ub, a.cost_out,
                                     a.accept_out, a.eq_mult, a.ineq_mult, a.rho, a.act_tol,
                                     emit, dyn, cost, term, eq, in, h, al, a.T, a.B);
  else
    forward_emit_one_thread_kernel<Dyn, Cost, Term, Eq, In, MAXA, false>
        <<<grid, block, 0, stream>>>(a.xs, a.us, a.k, a.K, a.merit, a.lb, a.ub, a.cost_out,
                                     a.accept_out, a.eq_mult, a.ineq_mult, a.rho, a.act_tol,
                                     emit, dyn, cost, term, eq, in, h, al, a.T, a.B);
}

// The emit mode (K8), every problem live.  Without a context one kernel,
// forward_emit_one_thread_kernel (candidate registers sized 4 or 16 by
// n_alphas), with AL where the instantiation has rows.  With a context
// three launches on one stream: the group kernel's select (active null),
// which keeps each problem's alpha in alpha_out [B] (the caller's scratch);
// forward_emit_reroll_kernel into emit.xs / emit.us; K3's context mode
// with Hessians (discrete != 0: through the RK4 step) at x_0 = xs[0],
// x_1..x_{T-1} = emit.xs[0..T-2] and emit.us into the stacks.
template <typename Dyn, typename Cost, typename Term, typename Eq, typename In>
int launch_forward_select_emit(const Args& args, const EmitOut& emit, int discrete, int m_eq,
                               int m_in, const float* dyn_p, const float* cost_p,
                               const float* term_p, const float* eq_p, const float* in_p,
                               const float* step_p, const float* alphas, int n_alphas,
                               cudaStream_t stream) {
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Term term = Term::from(term_p);
  const Eq eq = Eq::from(eq_p);
  const In in = In::from(in_p);
  const Step h = Step::from(step_p);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_alphas < 1 || n_alphas > MAX_ALPHAS || args.T < 1 || args.B < 1) return bad;
  if (!args_fit<Dyn, Cost>(args, m_eq, m_in, eq, in)) return bad;
  const LinOut& o = emit.lin;
  if (args.active != nullptr || emit.xs == nullptr || emit.us == nullptr || o.A == nullptr ||
      o.Bm == nullptr || o.lx == nullptr || o.lu == nullptr || o.lxx == nullptr ||
      o.luu == nullptr || o.lux == nullptr)
    return bad;
  Alphas al;
  al.n = n_alphas;
  for (int a = 0; a < MAX_ALPHAS; ++a) al.v[a] = a < al.n ? alphas[a] : 0.0f;
  if constexpr (!takes_context<Cost>::value) {
    if (al.n <= 4)
      launch_emit_one_thread<Dyn, Cost, Term, Eq, In, 4>(args, emit, discrete, dyn, cost, term,
                                                         eq, in, h, al, stream);
    else
      launch_emit_one_thread<Dyn, Cost, Term, Eq, In, MAX_ALPHAS>(args, emit, discrete, dyn,
                                                                  cost, term, eq, in, h, al,
                                                                  stream);
  } else {
    if (args.alpha_out == nullptr) return bad;
    if (al.n <= 4)
      launch_group<Dyn, Cost, Term, Eq, In, 4>(args, dyn, cost, term, eq, in, h, al, stream);
    else
      launch_group<Dyn, Cost, Term, Eq, In, MAX_ALPHAS>(args, dyn, cost, term, eq, in, h, al,
                                                        stream);
    const int block = 128;
    forward_emit_reroll_kernel<Dyn, Cost><<<(args.B + block - 1) / block, block, 0, stream>>>(
        args.xs, args.us, args.k, args.K, args.lb, args.ub, args.alpha_out, emit, dyn, cost, h,
        args.T, args.B);
    if (discrete)
      launch_linearize_mode<Dyn, Cost, true>(args.xs, emit.xs, emit.us, o.A, o.Bm, o.lx, o.lu,
                                             o.lxx, o.luu, o.lux, args.ctx, args.T, args.B,
                                             args.n_ctx, args.c_ctx, 1, dyn, cost, h, stream);
    else
      launch_linearize_mode<Dyn, Cost, false>(args.xs, emit.xs, emit.us, o.A, o.Bm, o.lx, o.lu,
                                              o.lxx, o.luu, o.lux, args.ctx, args.T, args.B,
                                              args.n_ctx, args.c_ctx, 1, dyn, cost, h, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

// One C entry point per (dynamics, stage cost, terminal cost[, equality,
// inequality constraints]) the kernels can evaluate.
#define MAS_FORWARD_SELECT(NAME, DYN, COST, TERM, EQ, IN)                                   \
  extern "C" int mas_forward_select__##NAME(                                                \
      int init, const float* x0, float* xs, float* us, float* xT, const float* k,           \
      const float* K, const float* merit, const bool* active, const float* lb,              \
      const float* ub, float* cost_out, bool* accept_out, float* alpha_out,                 \
      const float* ctx, const float* eq_mult, const float* ineq_mult, const float* rho,     \
      float act_tol, int T, int B, int n_ctx, int c_ctx, int m_eq, int m_in,                \
      const float* dyn_p, const float* cost_p, const float* term_p, const float* eq_p,      \
      const float* in_p, const float* step_p, const float* alphas, int n_alphas,            \
      void* stream) {                                                                       \
    const mas::Args args{x0,      xs,        us,  xT,      k,          K,         merit,  \
                         active,  lb,        ub,  cost_out, accept_out, alpha_out, ctx,    \
                         eq_mult, ineq_mult, rho, act_tol, T,          B,         n_ctx,  \
                         c_ctx};                                                          \
    return mas::launch_forward_select<DYN, COST, TERM, EQ, IN>(                             \
        init, args, m_eq, m_in, dyn_p, cost_p, term_p, eq_p, in_p, step_p, alphas,          \
        n_alphas, static_cast<cudaStream_t>(stream));                                       \
  }

using LaneFollowCost = mas::DiagQuadratic<4, 2>;
using mas::NoConstraint;

// The emit mode's C entry point per (dynamics, stage cost, terminal cost,
// equality, inequality constraints): xs [T, NX, B] (x_0..x_{T-1}), us, k,
// K, merit, the bounds, the context and the AL inputs in, alpha_out [B]
// scratch; merit and accept out, and x_1..x_T, the controls and the seven
// linearization stacks into the given buffers.
#define MAS_FORWARD_SELECT_EMIT(NAME, DYN, COST, TERM, EQ, IN)                              \
  extern "C" int mas_forward_select_emit__##NAME(                                           \
      const float* xs, const float* us, const float* k, const float* K, const float* merit, \
      const float* lb, const float* ub, float* cost_out, bool* accept_out, float* alpha_out, \
      const float* ctx, const float* eq_mult, const float* ineq_mult, const float* rho,     \
      float act_tol, int T, int B, int n_ctx, int c_ctx, int m_eq, int m_in, int discrete,  \
      const float* dyn_p, const float* cost_p, const float* term_p, const float* eq_p,      \
      const float* in_p, const float* step_p, const float* alphas, int n_alphas,            \
      float* xs_new, float* us_new, float* A, float* Bm, float* lx, float* lu, float* lxx,  \
      float* luu, float* lux, void* stream) {                                               \
    const mas::Args args{nullptr, const_cast<float*>(xs), const_cast<float*>(us), nullptr,  \
                         k,       K,         merit,   nullptr, lb,       ub,               \
                         cost_out, accept_out, alpha_out, ctx, eq_mult,  ineq_mult,        \
                         rho,     act_tol,   T,       B,       n_ctx,    c_ctx};           \
    mas::EmitOut emit;                                                                       \
    emit.xs = xs_new;                                                                        \
    emit.us = us_new;                                                                        \
    emit.lin = mas::LinOut{A, Bm, lx, lu, lxx, luu, lux};                                    \
    return mas::launch_forward_select_emit<DYN, COST, TERM, EQ, IN>(                        \
        args, emit, discrete, m_eq, m_in, dyn_p, cost_p, term_p, eq_p, in_p, step_p, alphas, \
        n_alphas, static_cast<cudaStream_t>(stream));                                        \
  }
