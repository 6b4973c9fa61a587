// K4's explicit-terminal mode (riccati.cuh: riccati_backward_kernel with
// GivenValue), the kernel of riccati_backward_pallas on the non-fused
// path, instantiated per (NX, NU) -- here the dimension sweep's (8, 4),
// whose box QP enumerates 81 configurations and takes most of the build --
// in clamp and boxqp (K5) mode.  The mode evaluates no user function, so
// one entry point serves every problem of those dimensions; a pair without
// one raises in ops/riccati.py.  The group kernel's (8, 4) launches are
// instantiated in riccati_explicit_wide_group.cu.
// Compiled beside riccati.cu so the build stays parallel.
#include "riccati.cuh"

MAS_BACKWARD_GROUP(extern template, mas::GivenValue, 8, 4, true, false);
MAS_BACKWARD_GROUP(extern template, mas::GivenValue, 8, 4, false, false);

#define MAS_RICCATI_EXPLICIT(NX, NU)                                                        \
  extern "C" int mas_riccati_explicit__##NX##x##NU(                                         \
      const float* A, const float* Bm, const float* lx, const float* lu, const float* lxx,  \
      const float* luu, const float* lux, const float* lb, const float* ub,                 \
      const float* vx0, const float* vxx0, float* k, float* K, int T, int B,                \
      const float* levels, int n_levels, void* stream) {                                    \
    return mas::launch_riccati_explicit<NX, NU>(A, Bm, lx, lu, lxx, luu, lux, lb, ub, vx0,  \
                                                vxx0, k, K, T, B, levels, n_levels,         \
                                                static_cast<cudaStream_t>(stream));         \
  }

MAS_RICCATI_EXPLICIT(8, 4)
