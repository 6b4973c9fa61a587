// K1 (riccati_fusedlin) and K4's fused-loop mode (riccati_backward) for the
// model zoo's smaller models (models/rocket.py, models/dynamic_bicycle.py,
// models/pendulum.py):
// * K1 for the rocket (Rocket, DiagQuadratic<3, 1>, RocketTerminal: the
//   stationary quadratic cost of examples/rocket_max_altitude.py) and the
//   dynamic bicycle's lane change (DynamicBicycle, DiagQuadratic<6, 2>,
//   ZeroTerminal), in the clamp mode alone (both Jacobian modes);
// * K4 with the pendulum swing-up's terminal cost derived in the kernel
//   (its stage cost reads the stage index and is not quadratic, so the
//   fused loop takes the general branch: K3 with Hessians, then K4).
// Compiled beside riccati.cu so the build stays parallel; the quadrotors'
// K1 are in sources of their own (riccati_quadrotor*.cu).
#include "riccati.cuh"

#define MAS_FUSEDLIN_CLAMP(NAME, DYN, COST, TERM)                                          \
  extern "C" int mas_riccati_fusedlin__##NAME(                                             \
      const float* xs, const float* us, const float* lxx, const float* luu,                \
      const float* lux, const float* lb, const float* ub, const float* xT, float* k,       \
      float* K, int T, int B, int discrete, const float* dyn_p, const float* cost_p,        \
      const float* term_p, const float* step_p, const float* levels, int n_levels,         \
      void* stream) {                                                                      \
    return mas::launch_riccati_fusedlin<DYN, COST, TERM, false>(                            \
        xs, us, lxx, luu, lux, lb, ub, xT, k, K, T, B, discrete, dyn_p, cost_p, term_p,     \
        step_p, levels, n_levels, static_cast<cudaStream_t>(stream));                      \
  }

using RocketCost = mas::DiagQuadratic<3, 1>;
using BicycleCost = mas::DiagQuadratic<6, 2>;
MAS_FUSEDLIN_CLAMP(rocket__diag_quadratic__rocket_terminal, mas::Rocket, RocketCost,
                   mas::RocketTerminal)
MAS_FUSEDLIN_CLAMP(dynamic_bicycle__diag_quadratic__zero, mas::DynamicBicycle, BicycleCost,
                   mas::ZeroTerminal)

extern "C" int mas_riccati_backward__pendulum__pendulum_swing_up_terminal(
    const float* A, const float* Bm, const float* lx, const float* lu, const float* lxx,
    const float* luu, const float* lux, const float* lb, const float* ub, const float* xT,
    float* k, float* K, int T, int B, int hess_tconst, const float* term_p,
    const float* levels, int n_levels, void* stream) {
  using namespace mas;
  return launch_riccati_backward<Pendulum, PendulumSwingUpTerminal>(
      A, Bm, lx, lu, lxx, luu, lux, lb, ub, xT, k, K, T, B, hess_tconst, term_p, levels,
      n_levels, static_cast<cudaStream_t>(stream));
}
