// K4's explicit-terminal mode (riccati_backward_pallas on the non-fused
// path) at the model zoo's dimensions: the rocket's (3, 1) in clamp and
// boxqp (K5) mode (its thrust box), for the non-fused and fd routes.  The
// quadrotors' (12, 4) and (16, 4), clamp mode alone (no input bounds), are
// in riccati_explicit_quadrotor.cu.  Compiled beside riccati_explicit.cu
// so the build stays parallel.
#include "riccati.cuh"

extern "C" int mas_riccati_explicit__3x1(const float* A, const float* Bm, const float* lx,
                                         const float* lu, const float* lxx, const float* luu,
                                         const float* lux, const float* lb, const float* ub,
                                         const float* vx0, const float* vxx0, float* k,
                                         float* K, int T, int B, const float* levels,
                                         int n_levels, void* stream) {
  return mas::launch_riccati_explicit<3, 1>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, vx0, vxx0, k,
                                            K, T, B, levels, n_levels,
                                            static_cast<cudaStream_t>(stream));
}
