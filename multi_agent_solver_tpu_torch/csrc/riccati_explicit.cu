// K4's explicit-terminal mode (riccati.cuh: riccati_backward_kernel with
// GivenValue), the kernel of riccati_backward_pallas on the non-fused
// path, instantiated per (NX, NU) -- here the main path's (4, 2), the
// dimension sweep's (2, 1) and (6, 3), the cart-pole's (4, 1) and the
// padded mixed fleet's (6, 2) (strategies/hetero.py: single-track cars and
// (2, 1) LQR agents, two type indicators) -- in clamp and boxqp (K5) mode,
// and the LQR's (4, 4) in clamp mode alone (the LQR has no input bounds,
// and K5's box QP at NU = 4 would double this source's build).  The
// mode evaluates no user function, so one entry point serves every problem
// of those dimensions; a pair without one raises in ops/riccati.py.
// Compiled beside riccati.cu so the build stays parallel.
#include "riccati.cuh"

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

MAS_RICCATI_EXPLICIT(4, 2)
MAS_RICCATI_EXPLICIT(2, 1)
MAS_RICCATI_EXPLICIT(6, 3)
MAS_RICCATI_EXPLICIT(4, 1)
MAS_RICCATI_EXPLICIT(6, 2)

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

MAS_RICCATI_EXPLICIT_CLAMP(4, 4)
