// Device functions of the problems the kernels can evaluate, and the
// pieces of arithmetic that every kernel shares.
//
// The JAX kernels trace the user's Python dynamics / stage cost / terminal
// cost inside the kernel.  A CUDA kernel cannot take a torch callable, so
// each supported callable has a device-function counterpart here,
// templated on its scalar type (float, Dual, Dual<Dual>; see dual.cuh).
// The torch callables name theirs with a DeviceFn tag
// (multi_agent_solver_tpu_torch/types.py) and the wrappers pick the
// kernel instantiation by those names.  Each struct is built from the
// tag's float parameters by from(params).
#pragma once

#include "dual.cuh"

namespace mas {

// Kinematic single-track model (models/single_track.py):
//   f = (v cos psi, v sin psi, v tan(delta) / L, a),  x = (X, Y, psi, v), u = (delta, a).
struct SingleTrack {
  static constexpr int NX = 4;
  static constexpr int NU = 2;
  float wheelbase;

  static SingleTrack from(const float* p) { return SingleTrack{p[0]}; }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    f[0] = x[3] * dcos(x[2]);
    f[1] = x[3] * dsin(x[2]);
    f[2] = x[3] * dtan(u[0]) / wheelbase;
    f[3] = u[1];
  }
};

// Diagonal quadratic tracking cost (ocp.diagonal_quadratic_cost), terms
// summed in the order the torch callable sums them:
//   sum_i wx_i (x_i - rx_i)^2 + sum_i wu_i (u_i - ru_i)^2.
// The single-track lane-follow cost is wx = (0, 10, 0, 1),
// rx = (0, 0, 0, 1), wu = (0.1, 0.1), ru = 0.
template <int NX, int NU>
struct DiagQuadratic {
  float wx[NX], rx[NX], wu[NU], ru[NU];

  static DiagQuadratic from(const float* p) {
    DiagQuadratic c;
    for (int i = 0; i < NX; ++i) c.wx[i] = p[i];
    for (int i = 0; i < NX; ++i) c.rx[i] = p[NX + i];
    for (int i = 0; i < NU; ++i) c.wu[i] = p[2 * NX + i];
    for (int i = 0; i < NU; ++i) c.ru[i] = p[2 * NX + NU + i];
    return c;
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x, const S* u) const {
    S e = x[0] - rx[0];
    S c = wx[0] * (e * e);
#pragma unroll
    for (int i = 1; i < NX; ++i) {
      e = x[i] - rx[i];
      c = c + wx[i] * (e * e);
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      e = u[i] - ru[i];
      c = c + wu[i] * (e * e);
    }
    return c;
  }
};

// Zero terminal cost (ocp.zero_terminal_cost).
struct ZeroTerminal {
  static ZeroTerminal from(const float*) { return ZeroTerminal{}; }

  template <typename S>
  __device__ __forceinline__ S operator()(const S*) const { return S(0.0f); }
};

// RK4 step constants (0.5 dt, dt, dt / 6), rounded to float on the host.
struct Step {
  float half, full, sixth;
  static Step from(const float* p) { return Step{p[0], p[1], p[2]}; }
};

// One classic RK4 step of the continuous dynamics, control held:
//   x + dt/6 (k1 + 2 k2 + 2 k3 + k4), evaluated in the reference's order.
template <typename Dyn, typename S>
__device__ __forceinline__ void rk4_step(const Dyn& f, const S* x, const S* u,
                                         const Step& h, S* out) {
  constexpr int NX = Dyn::NX;
  S k1[NX], k2[NX], k3[NX], k4[NX], y[NX];
  f(x, u, k1);
#pragma unroll
  for (int i = 0; i < NX; ++i) y[i] = x[i] + h.half * k1[i];
  f(y, u, k2);
#pragma unroll
  for (int i = 0; i < NX; ++i) y[i] = x[i] + h.half * k2[i];
  f(y, u, k3);
#pragma unroll
  for (int i = 0; i < NX; ++i) y[i] = x[i] + h.full * k3[i];
  f(y, u, k4);
#pragma unroll
  for (int i = 0; i < NX; ++i)
    out[i] = x[i] + h.sixth * (k1[i] + 2.0f * k2[i] + 2.0f * k3[i] + k4[i]);
}

// A = d step / dx, B = d step / du and the cost gradient (lx, lu) at one
// stage, from ONE forward pass in Dual<float, NX + NU>: tangents 0..NX-1
// seed x, NX..NX+NU-1 seed u.
template <typename Dyn, typename Cost>
__device__ __forceinline__ void stage_derivatives(
    const Dyn& dyn, const Cost& cost, const Step& h, const float* x, const float* u,
    float (*A)[Dyn::NX], float (*Bm)[Dyn::NU], float* lx, float* lu) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU, NZ = NX + NU;
  using D = Dual<float, NZ>;
  D xd[NX], ud[NU], nxt[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) xd[i] = seed<NZ>(x[i], i);
#pragma unroll
  for (int i = 0; i < NU; ++i) ud[i] = seed<NZ>(u[i], NX + i);
  rk4_step(dyn, xd, ud, h, nxt);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) A[i][j] = nxt[i].d[j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Bm[i][j] = nxt[i].d[NX + j];
  }
  const D c = cost(xd, ud);
#pragma unroll
  for (int j = 0; j < NX; ++j) lx[j] = c.d[j];
#pragma unroll
  for (int j = 0; j < NU; ++j) lu[j] = c.d[NX + j];
}

// NaN-propagating clamp min(max(u, lb), ub), as jnp.minimum/maximum and
// torch.minimum/maximum behave.
__device__ __forceinline__ float clamp_nan(float u, float lb, float ub) {
  if (u != u) return u;
  return fminf(fmaxf(u, lb), ub);
}

}  // namespace mas
