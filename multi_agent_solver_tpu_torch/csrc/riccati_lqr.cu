// K1 (riccati_fusedlin) for the LQR (models/lqr.py): Linear<4, 4> dynamics,
// the Quadratic<4, 4> stage cost and the QuadraticTerminal<4> terminal cost,
// the size of examples/multi_agent_lqr.py.  The cost is quadratic and
// stationary, so the fused loop takes the main path's branch; the LQR has
// no input bounds, so only the clamp mode (both Jacobian modes) is
// instantiated.  Compiled beside riccati.cu so the build stays parallel.
#include "riccati.cuh"

extern "C" int mas_riccati_fusedlin__linear_4x4__quadratic__quadratic_terminal(
    const float* xs, const float* us, const float* lxx, const float* luu,
    const float* lux, const float* lb, const float* ub, const float* xT, float* k, float* K,
    int T, int B, int discrete, const float* dyn_p, const float* cost_p, const float* term_p,
    const float* step_p, const float* levels, int n_levels, void* stream) {
  using namespace mas;
  return launch_riccati_fusedlin<Linear<4, 4>, Quadratic<4, 4>, QuadraticTerminal<4>, false>(
      xs, us, lxx, luu, lux, lb, ub, xT, k, K, T, B, discrete, dyn_p, cost_p, term_p, step_p,
      levels, n_levels, static_cast<cudaStream_t>(stream));
}
