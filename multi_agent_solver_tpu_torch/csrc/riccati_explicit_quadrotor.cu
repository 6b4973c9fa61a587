// K4's explicit-terminal mode at the quadrotors' (12, 4) and (16, 4), the
// clamp mode alone (neither model has input bounds, and K5's box QP at NU
// = 4 is the costliest part of a build).  The group kernel takes 16 lanes
// a problem (backward_group_lanes), the one-thread kernel keeps the value
// function (144 / 256 floats) where ptxas puts it (build.log).  A source of
// its own, so that nvcc builds it in parallel.
#include "riccati.cuh"

#define MAS_RICCATI_EXPLICIT_CLAMP(NX, NU)                                                  \
  extern "C" int mas_riccati_explicit__##NX##x##NU(                                         \
      const float* A, const float* Bm, const float* lx, const float* lu, const float* lxx,  \
      const float* luu, const float* lux, const float* lb, const float* ub,                 \
      const float* vx0, const float* vxx0, float* k, float* K, int T, int B,                \
      const float* levels, int n_levels, void* stream) {                                    \
    return mas::launch_riccati_explicit<NX, NU, false>(A, Bm, lx, lu, lxx, luu, lux, lb,    \
                                                       ub, vx0, vxx0, k, K, T, B, levels,   \
                                                       n_levels,                            \
                                                       static_cast<cudaStream_t>(stream));  \
  }

MAS_RICCATI_EXPLICIT_CLAMP(12, 4)
MAS_RICCATI_EXPLICIT_CLAMP(16, 4)
