// K10: the terminal cost's gradient and Hessian, one problem per thread.
//
// Replaces multi_agent_solver_tpu/ops/linearize_pallas.py ::
// terminal_derivs_tiled.  No solve path calls it, in the JAX package or
// here: K1 and K4 derive the terminal value inside their own kernels.
//
// What it computes at x_T of problem b: phi_x and phi_xx, the Hessian's
// upper triangle mirrored (terminal_derivs_tiled symmetrizes it so), by
// one pass of the terminal cost in second-order duals -- the device
// function terminal_value that K1 and K4 run (riccati.cuh), so the three
// agree bit for bit.
//
// Layout: xT [NX, B] in; phix [NX, B], phixx [NX, NX, B] out.
//
// What bounds it on the H100: the bytes, NX 4 read and NX (1 + NX) 4
// written a problem, against a few dozen operations of duals.  Design: one
// thread a problem, batch innermost, so a warp's loads and stores coalesce.
#include <cuda_runtime.h>

#include "riccati.cuh"

namespace mas {

template <int NX, typename Term>
__global__ void __launch_bounds__(128) terminal_derivs_kernel(const float* __restrict__ xT,
                                                              float* __restrict__ phix,
                                                              float* __restrict__ phixx,
                                                              Term term, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = static_cast<size_t>(B);
  float vx[NX], vxx[NX][NX];
  terminal_value<NX>(term, xT, b, sB, vx, vxx);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    phix[i * sB + b] = vx[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) phixx[(i * NX + j) * sB + b] = vxx[i][j];
  }
}

template <typename Dyn, typename Term>
int launch_terminal_derivs(const float* xT, float* phix, float* phixx, int B,
                           const float* term_p, cudaStream_t stream) {
  if (B < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int block = 128;
  const int grid = (B + block - 1) / block;
  terminal_derivs_kernel<Dyn::NX, Term><<<grid, block, 0, stream>>>(xT, phix, phixx,
                                                                    Term::from(term_p), B);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mas

// One C entry point per (dynamics, terminal cost); the dynamics fix NX.
#define MAS_TERMINAL_DERIVS(NAME, DYN, TERM)                                                \
  extern "C" int mas_terminal_derivs__##NAME(const float* xT, float* phix, float* phixx,    \
                                             int B, const float* dyn_p,                     \
                                             const float* term_p, void* stream) {           \
    (void)dyn_p;                                                                            \
    return mas::launch_terminal_derivs<DYN, TERM>(xT, phix, phixx, B, term_p,               \
                                                  static_cast<cudaStream_t>(stream));       \
  }

MAS_TERMINAL_DERIVS(single_track__zero, mas::SingleTrack, mas::ZeroTerminal)
MAS_TERMINAL_DERIVS(single_track__diag_quadratic_terminal, mas::SingleTrack,
                    mas::DiagQuadraticTerminal<4>)
