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
// * rollout mode (INIT): the initial rollout and its cost -- alpha 0, zero
//   gains, no bounds, merit +inf -- writing x_1..x_T.  Its single candidate
//   IS the trajectory, so it is written during phase 1 and there is no
//   phase 2.
//
// Layout: batch innermost.  Select mode: xs [T, NX, B], us [T, NU, B],
// xT [NX, B] (in/out), k [T, NU, B], K [T, NU, NX, B], merit [B],
// active [B] (bool), lb / ub [NU, B] (or null: no clamp) in; merit_new [B],
// accept [B] out.  Rollout mode: x0 [NX, B], us [T, NU, B] in; xs [T, NX, B]
// (x_1..x_T), cost [B] out.
//
// What bounds it on the H100: the arithmetic of A + 1 sequential RK4
// rollouts per problem (12 sin/cos/tan a step) and the reads of the
// reference and the gains in both phases (T (NX + 2 NU + NU NX) 4 bytes a
// phase).  Design: one thread per problem with the A <= 16 candidate
// states and costs in registers (the TPU kernel's VMEM scratch), the t
// loop inside the thread, coalesced batch-innermost loads; phase 2 runs
// only where a candidate was accepted.
#include <cuda_runtime.h>

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

template <typename Dyn, typename Cost, typename Term, int MAXA, bool INIT>
__global__ void __launch_bounds__(128) forward_select_kernel(
    const float* __restrict__ x0, float* xs, float* us, float* xT,
    const float* __restrict__ k, const float* __restrict__ K,
    const float* __restrict__ merit, const bool* __restrict__ active,
    const float* __restrict__ lb_in, const float* __restrict__ ub_in,
    float* __restrict__ cost_out, bool* __restrict__ accept_out,
    Dyn dyn, Cost cost, Term term, Step h, Alphas alphas, int T, int B) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  const int A = INIT ? 1 : alphas.n;

  float lb[NU], ub[NU];
  const bool bounded = !INIT && lb_in != nullptr;
  if (bounded) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      lb[i] = lb_in[i * sB + b];
      ub[i] = ub_in[i * sB + b];
    }
  }

  float xstart[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) xstart[i] = INIT ? x0[i * sB + b] : xs[i * sB + b];

  // Phase 1: all candidates at once.
  float xa[MAXA][NX], ca[MAXA];
#pragma unroll
  for (int a = 0; a < MAXA; ++a) {
    ca[a] = 0.0f;
#pragma unroll
    for (int i = 0; i < NX; ++i) xa[a][i] = xstart[i];
  }
  for (int t = 0; t < T; ++t) {
    float xr[NX], ur[NU], kt[NU], Kt[NU][NX];
#pragma unroll
    for (int i = 0; i < NU; ++i) ur[i] = us[(static_cast<size_t>(t) * NU + i) * sB + b];
    if constexpr (!INIT) {
#pragma unroll
      for (int i = 0; i < NX; ++i) xr[i] = xs[(static_cast<size_t>(t) * NX + i) * sB + b];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        kt[i] = k[(static_cast<size_t>(t) * NU + i) * sB + b];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Kt[i][j] = K[((static_cast<size_t>(t) * NU + i) * NX + j) * sB + b];
      }
    }
#pragma unroll
    for (int a = 0; a < MAXA; ++a) {
      if (a >= A) break;
      float u[NU];
      if constexpr (INIT) {
#pragma unroll
        for (int i = 0; i < NU; ++i) u[i] = ur[i];
      } else {
        feedback_control<NX, NU>(xa[a], xr, ur, kt, Kt, alphas.v[a],
                                 bounded ? lb : nullptr, ub, u);
      }
      ca[a] = ca[a] + cost(xa[a], u);
      float xn[NX];
      rk4_step(dyn, xa[a], u, h, xn);
#pragma unroll
      for (int i = 0; i < NX; ++i) xa[a][i] = xn[i];
      if constexpr (INIT) {
#pragma unroll
        for (int i = 0; i < NX; ++i) xs[(static_cast<size_t>(t) * NX + i) * sB + b] = xn[i];
      }
    }
  }

  if constexpr (INIT) {
    const float total = ca[0] + term(xa[0]);
    cost_out[b] = total < INFINITY ? total : INFINITY;
    return;
  } else {
    // Selection: smallest alpha first, so the largest improving one wins.
    const float m = merit[b];
    const bool live = active[b];
    float best = m, sel = 0.0f;
    bool found = false;
#pragma unroll
    for (int a = MAXA - 1; a >= 0; --a) {
      if (a >= A) continue;
      const float total = ca[a] + term(xa[a]);
      if (total < m && live) {
        sel = alphas.v[a];
        best = total;
        found = true;
      }
    }
    cost_out[b] = best;
    accept_out[b] = found;
    if (!found) return;

    // Phase 2: re-roll the winner, writing the stage layout in place.
    float x[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xstart[i];
    for (int t = 0; t < T; ++t) {
      float xr[NX], ur[NU], kt[NU], Kt[NU][NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) xr[i] = xs[(static_cast<size_t>(t) * NX + i) * sB + b];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        ur[i] = us[(static_cast<size_t>(t) * NU + i) * sB + b];
        kt[i] = k[(static_cast<size_t>(t) * NU + i) * sB + b];
#pragma unroll
        for (int j = 0; j < NX; ++j)
          Kt[i][j] = K[((static_cast<size_t>(t) * NU + i) * NX + j) * sB + b];
      }
      float u[NU], xn[NX];
      feedback_control<NX, NU>(x, xr, ur, kt, Kt, sel, bounded ? lb : nullptr, ub, u);
      rk4_step(dyn, x, u, h, xn);
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
}

template <typename Dyn, typename Cost, typename Term, int MAXA, bool INIT>
void launch_one(const float* x0, float* xs, float* us, float* xT, const float* k,
                const float* K, const float* merit, const bool* active, const float* lb,
                const float* ub, float* cost_out, bool* accept_out, const Dyn& dyn,
                const Cost& cost, const Term& term, const Step& h, const Alphas& al,
                int T, int B, cudaStream_t stream) {
  const int block = 128;
  const int grid = (B + block - 1) / block;
  forward_select_kernel<Dyn, Cost, Term, MAXA, INIT><<<grid, block, 0, stream>>>(
      x0, xs, us, xT, k, K, merit, active, lb, ub, cost_out, accept_out, dyn, cost,
      term, h, al, T, B);
}

// init != 0: rollout mode (x0, us -> xs = x_1..x_T, cost); alphas unused.
// init == 0: select mode, candidate registers sized 4 or 16 by n_alphas.
template <typename Dyn, typename Cost, typename Term>
int launch_forward_select(int init, const float* x0, float* xs, float* us, float* xT,
                          const float* k, const float* K, const float* merit,
                          const bool* active, const float* lb, const float* ub,
                          float* cost_out, bool* accept_out, int T, int B,
                          const float* dyn_p, const float* cost_p, const float* term_p,
                          const float* step_p, const float* alphas, int n_alphas,
                          cudaStream_t stream) {
  const Dyn dyn = Dyn::from(dyn_p);
  const Cost cost = Cost::from(cost_p);
  const Term term = Term::from(term_p);
  const Step h = Step::from(step_p);
  Alphas al;
  al.n = init ? 1 : n_alphas;
  if (al.n < 1 || al.n > MAX_ALPHAS) return static_cast<int>(cudaErrorInvalidValue);
  for (int a = 0; a < MAX_ALPHAS; ++a) al.v[a] = (!init && a < al.n) ? alphas[a] : 0.0f;
  if (init)
    launch_one<Dyn, Cost, Term, 1, true>(x0, xs, us, xT, k, K, merit, active, lb, ub,
                                         cost_out, accept_out, dyn, cost, term, h, al,
                                         T, B, stream);
  else if (al.n <= 4)
    launch_one<Dyn, Cost, Term, 4, false>(x0, xs, us, xT, k, K, merit, active, lb, ub,
                                          cost_out, accept_out, dyn, cost, term, h, al,
                                          T, B, stream);
  else
    launch_one<Dyn, Cost, Term, MAX_ALPHAS, false>(x0, xs, us, xT, k, K, merit, active,
                                                   lb, ub, cost_out, accept_out, dyn,
                                                   cost, term, h, al, T, B, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

extern "C" int mas_forward_select__single_track__diag_quadratic__zero(
    int init, const float* x0, float* xs, float* us, float* xT, const float* k,
    const float* K, const float* merit, const bool* active, const float* lb,
    const float* ub, float* cost_out, bool* accept_out, int T, int B,
    const float* dyn_p, const float* cost_p, const float* term_p, const float* step_p,
    const float* alphas, int n_alphas, void* stream) {
  using namespace mas;
  return launch_forward_select<SingleTrack, DiagQuadratic<4, 2>, ZeroTerminal>(
      init, x0, xs, us, xT, k, K, merit, active, lb, ub, cost_out, accept_out, T, B,
      dyn_p, cost_p, term_p, step_p, alphas, n_alphas, static_cast<cudaStream_t>(stream));
}
