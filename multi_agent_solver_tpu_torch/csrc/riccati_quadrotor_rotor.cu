// K1 (riccati_fusedlin) for the rotor-lag quadrotor's hover regulation
// (models/quadrotor_rotor.py; QuadrotorRotor, DiagQuadratic<16, 4>,
// DiagQuadraticTerminal<16>), in the clamp mode alone (no input bounds),
// both Jacobian modes.  One thread a problem: the value function (256
// floats) and the 17 live tangents spill (build.log).  A source of its own,
// so that nvcc builds it in parallel.
#include "riccati.cuh"

extern "C" int mas_riccati_fusedlin__quadrotor_rotor__diag_quadratic__diag_quadratic_terminal(
    const float* xs, const float* us, const float* lxx, const float* luu, const float* lux,
    const float* lb, const float* ub, const float* xT, float* k, float* K, int T, int B,
    int discrete, const float* dyn_p, const float* cost_p, const float* term_p,
    const float* step_p, const float* levels, int n_levels, void* stream) {
  using namespace mas;
  return launch_riccati_fusedlin<QuadrotorRotor, DiagQuadratic<16, 4>,
                                 DiagQuadraticTerminal<16>, false>(
      xs, us, lxx, luu, lux, lb, ub, xT, k, K, T, B, discrete, dyn_p, cost_p, term_p, step_p,
      levels, n_levels, static_cast<cudaStream_t>(stream));
}
