// The C entry points of K1 (riccati_fusedlin) and K4 (riccati_backward) in
// its fused-loop mode; the kernels, their notes and K5 are in riccati.cuh.
// K4's explicit-terminal mode is instantiated in riccati_explicit.cu and
// riccati_explicit_wide.cu, compiled beside this file.
#include "riccati.cuh"

extern "C" int mas_riccati_fusedlin__single_track__diag_quadratic__zero(
    const float* xs, const float* us, const float* lxx, const float* luu,
    const float* lux, const float* lb, const float* ub, const float* xT, float* k, float* K,
    int T, int B, int discrete, const float* dyn_p, const float* cost_p, const float* term_p,
    const float* step_p, const float* levels, int n_levels, void* stream) {
  using namespace mas;
  return launch_riccati_fusedlin<SingleTrack, DiagQuadratic<4, 2>, ZeroTerminal>(
      xs, us, lxx, luu, lux, lb, ub, xT, k, K, T, B, discrete, dyn_p, cost_p, term_p, step_p,
      levels, n_levels, static_cast<cudaStream_t>(stream));
}

extern "C" int mas_riccati_backward__single_track__zero(
    const float* A, const float* Bm, const float* lx, const float* lu, const float* lxx,
    const float* luu, const float* lux, const float* lb, const float* ub, const float* xT,
    float* k, float* K, int T, int B, int hess_tconst, const float* term_p,
    const float* levels, int n_levels, void* stream) {
  using namespace mas;
  return launch_riccati_backward<SingleTrack, ZeroTerminal>(
      A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT, k, K, T, B, hess_tconst, term_p, levels,
      n_levels, static_cast<cudaStream_t>(stream));
}

// The cart-pole swing-up's terminal cost, derived in the kernel (its
// stage cost is not quadratic, so K1 never runs it).
extern "C" int mas_riccati_backward__cartpole__cartpole_swing_up_terminal(
    const float* A, const float* Bm, const float* lx, const float* lu, const float* lxx,
    const float* luu, const float* lux, const float* lb, const float* ub, const float* xT,
    float* k, float* K, int T, int B, int hess_tconst, const float* term_p,
    const float* levels, int n_levels, void* stream) {
  using namespace mas;
  return launch_riccati_backward<Cartpole, CartpoleSwingUpTerminal>(
      A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT, k, K, T, B, hess_tconst, term_p, levels,
      n_levels, static_cast<cudaStream_t>(stream));
}
