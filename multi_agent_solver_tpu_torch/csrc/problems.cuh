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
// tag's float parameters by from(params); NPARAMS says how many it reads.
#pragma once

#include <type_traits>
#include <utility>

#include "dual.cuh"

namespace mas {

// Kinematic single-track model (models/single_track.py):
//   f = (v cos psi, v sin psi, v tan(delta) / L, a),  x = (X, Y, psi, v), u = (delta, a).
// f reads psi and v alone (READS).  hold(u) is what f needs of a control
// that an RK4 step holds, tan(delta) and a, so that a step takes tan once;
// f at a control is f at its hold.
struct SingleTrack {
  static constexpr int NX = 4;
  static constexpr int NU = 2;
  static constexpr unsigned READS = (1u << 2) | (1u << 3);
  float wheelbase;

  static SingleTrack from(const float* p) { return SingleTrack{p[0]}; }

  template <typename S>
  struct Held {
    S tan_delta, a;
  };

  template <typename S>
  __device__ __forceinline__ Held<S> hold(const S* u) const {
    return Held<S>{dtan(u[0]), u[1]};
  }

  // One sincosf for sin and cos of psi: the bits of sinf and cosf apart.
  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const Held<S>& h, S* f) const {
    S s, c;
    dsincos(x[2], s, c);
    f[0] = x[3] * c;
    f[1] = x[3] * s;
    f[2] = x[3] * h.tan_delta / wheelbase;
    f[3] = h.a;
  }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    (*this)(x, hold(u), f);
  }
};

// Frictionless cart-pole (models/cartpole.py):  x = (p, theta, p_dot,
// theta_dot), u = (force,), theta = 0 hanging down,
//   denom      = m_c + m_p sin^2 theta,
//   p_ddot     = (f + m_p sin theta (l theta_dot^2 + g cos theta)) / denom,
//   theta_ddot = (-f cos theta - m_p l theta_dot^2 cos theta sin theta
//                 - (m_c + m_p) g sin theta) / (l denom),
// each product and sum in the torch callable's order.  Parameters: m_c,
// m_p, l, g, and the products m_p l and (m_c + m_p) g that Python folds
// in double before torch rounds them.  f never reads the cart position
// (READS); sin and cos of theta come from one dsincos.
struct Cartpole {
  static constexpr int NX = 4;
  static constexpr int NU = 1;
  static constexpr unsigned READS = (1u << 1) | (1u << 2) | (1u << 3);
  float m_cart, m_pole, l_pole, g, m_l, m_g;

  static Cartpole from(const float* p) { return Cartpole{p[0], p[1], p[2], p[3], p[4], p[5]}; }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    S s, c;
    dsincos(x[1], s, c);
    const S w = x[3];
    const S denom = m_cart + (m_pole * s) * s;
    f[0] = x[2];
    f[1] = x[3];
    f[2] = (u[0] + (m_pole * s) * ((l_pole * w) * w + g * c)) / denom;
    f[3] = ((-u[0]) * c - (((m_l * w) * w) * c) * s - m_g * s) / (l_pole * denom);
  }
};

// Linear dynamics (models/lqr.py make_linear_dynamics):  f = A x + B u,
// f_i = (sum_j A_ij x_j) + (sum_j B_ij u_j), each sum from column 0, as the
// torch callable sums it.  Parameters: A, then B, row-major.  A linear
// model comes in any size: the tag names its dims (linear_4x4), and each
// size is an instantiation of its own.
template <int NX_, int NU_>
struct Linear {
  static constexpr int NX = NX_;
  static constexpr int NU = NU_;
  static constexpr int NPARAMS = NX * NX + NX * NU;
  float a[NX][NX], b[NX][NU];

  static Linear from(const float* p) {
    Linear f;
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) f.a[i][j] = p[i * NX + j];
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NU; ++j) f.b[i][j] = p[NX * NX + i * NU + j];
    return f;
  }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      S ax = a[i][0] * x[0];
#pragma unroll
      for (int j = 1; j < NX; ++j) ax = ax + a[i][j] * x[j];
      S bu = b[i][0] * u[0];
#pragma unroll
      for (int j = 1; j < NU; ++j) bu = bu + b[i][j] * u[j];
      f[i] = ax + bu;
    }
  }
};

// v' M v as the torch callables of models/lqr.py compute it, (v M) v:
// w_j = sum_i v_i M_ij, then sum_j w_j v_j, each sum from index 0.
template <int N, typename S>
__device__ __forceinline__ S quadratic_form(const float (&m)[N][N], const S* v) {
  S total = v[0] * m[0][0];
#pragma unroll
  for (int i = 1; i < N; ++i) total = total + v[i] * m[i][0];
  total = total * v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    S w = v[0] * m[0][j];
#pragma unroll
    for (int i = 1; i < N; ++i) w = w + v[i] * m[i][j];
    total = total + w * v[j];
  }
  return total;
}

// What K1's linearization asks of a dynamics device function beyond f:
// READS, the bit set of the state components f reads (default: all), and
// hold(u), what f needs of a control that the RK4 step holds, evaluated
// once a step, with f's form f(x, hold(u), out) (default: the control
// itself and f(x, u, out)).
template <typename Dyn, typename = void>
struct state_reads {
  static constexpr unsigned value = (1u << Dyn::NX) - 1u;
};
template <typename Dyn>
struct state_reads<Dyn, std::void_t<decltype(Dyn::READS)>> {
  static constexpr unsigned value = Dyn::READS;
};

template <typename Dyn, typename S, typename = void>
struct has_hold : std::false_type {};
template <typename Dyn, typename S>
struct has_hold<Dyn, S,
                std::void_t<decltype(std::declval<const Dyn&>().hold(std::declval<const S*>()))>>
    : std::true_type {};

template <typename Dyn, typename S>
__device__ __forceinline__ auto control_hold(const Dyn& f, const S* u) {
  if constexpr (has_hold<Dyn, S>::value)
    return f.hold(u);
  else
    return u;
}

// f(std::integral_constant<int, I>{}) for I = 0 .. N-1, in order: a loop
// whose index (decltype(i)::value in f's body) is a constant expression,
// so that arrays in registers are only ever indexed by constants.
template <typename F, int... I>
__device__ __forceinline__ void static_for_each(F&& f, std::integer_sequence<int, I...>) {
  (f(std::integral_constant<int, I>{}), ...);
}

template <int N, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_each(f, std::make_integer_sequence<int, N>{});
}

// Position of state component i among the components of `reads`, -1 if
// it is not one of them; and how many there are.
__host__ __device__ constexpr int read_index(unsigned reads, int i) {
  if (!((reads >> i) & 1u)) return -1;
  int n = 0;
  for (int j = 0; j < i; ++j) n += static_cast<int>((reads >> j) & 1u);
  return n;
}

__host__ __device__ constexpr int read_count(unsigned reads) {
  int n = 0;
  for (; reads != 0u; reads >>= 1) n += static_cast<int>(reads & 1u);
  return n;
}

// Diagonal quadratic tracking cost (ocp.diagonal_quadratic_cost), terms
// summed in the order the torch callable sums them:
//   sum_i wx_i (x_i - rx_i)^2 + sum_i wu_i (u_i - ru_i)^2.
// The single-track lane-follow cost is wx = (0, 10, 0, 1),
// rx = (0, 0, 0, 1), wu = (0.1, 0.1), ru = 0.
template <int NX, int NU>
struct DiagQuadratic {
  static constexpr int NPARAMS = 2 * (NX + NU);
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

// Quadratic stage cost (models/lqr.py quadratic_stage_cost):  x'Qx + u'Ru,
// each form by quadratic_form.  Parameters: Q, then R, row-major.
template <int NX, int NU>
struct Quadratic {
  static constexpr int NPARAMS = NX * NX + NU * NU;
  float q[NX][NX], r[NU][NU];

  static Quadratic from(const float* p) {
    Quadratic c;
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) c.q[i][j] = p[i * NX + j];
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NU; ++j) c.r[i][j] = p[NX * NX + i * NU + j];
    return c;
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x, const S* u) const {
    return quadratic_form<NX>(q, x) + quadratic_form<NU>(r, u);
  }
};

// Circular-track cost (examples/multi_agent_single_track.py _stage_cost),
// terms summed in the order the torch callable sums them:
//   w_track (sqrt(X^2 + Y^2) - radius)^2 + w_speed (v - v_ref)^2
//     + w_delta delta^2 + w_acc a^2.
// Parameters: radius, v_ref, w_track, w_speed, w_delta, w_acc.
struct CircularTrack {
  static constexpr int NPARAMS = 6;
  float radius, v_ref, w_track, w_speed, w_delta, w_acc;

  static CircularTrack from(const float* p) {
    return CircularTrack{p[0], p[1], p[2], p[3], p[4], p[5]};
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x, const S* u) const {
    const S d = dsqrt(x[0] * x[0] + x[1] * x[1]) - radius;
    const S e = x[3] - v_ref;
    return ((w_track * (d * d) + w_speed * (e * e)) + w_delta * (u[0] * u[0])) +
           w_acc * (u[1] * u[1]);
  }
};

// The cart-pole swing-up's stage cost (models/cartpole.py
// cartpole_swing_up_stage_cost), terms summed in the torch callable's
// order, e = 1 + cos theta:
//   w_up e e + w_p p p + w_v p_dot p_dot + w_w theta_dot theta_dot + w_u f f.
// Parameters: w_up, w_p, w_v, w_w, w_u.
struct CartpoleSwingUp {
  static constexpr int NPARAMS = 5;
  float w_up, w_p, w_v, w_w, w_u;

  static CartpoleSwingUp from(const float* p) {
    return CartpoleSwingUp{p[0], p[1], p[2], p[3], p[4]};
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x, const S* u) const {
    S s, c;
    dsincos(x[1], s, c);
    const S e = 1.0f + c;
    return (((w_up * e) * e + (w_p * x[0]) * x[0]) + (w_v * x[2]) * x[2]) +
           (w_w * x[3]) * x[3] + (w_u * u[0]) * u[0];
  }
};

// Its terminal cost (cartpole_swing_up_terminal_cost), in the same form
// without the control term:  w_up e e + w_p p p + w_v p_dot p_dot +
// w_w theta_dot theta_dot.  Parameters: w_up, w_p, w_v, w_w.
struct CartpoleSwingUpTerminal {
  static constexpr int NPARAMS = 4;
  float w_up, w_p, w_v, w_w;

  static CartpoleSwingUpTerminal from(const float* p) {
    return CartpoleSwingUpTerminal{p[0], p[1], p[2], p[3]};
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x) const {
    S s, c;
    dsincos(x[1], s, c);
    const S e = 1.0f + c;
    return (((w_up * e) * e + (w_p * x[0]) * x[0]) + (w_v * x[2]) * x[2]) + (w_w * x[3]) * x[3];
  }
};

// A stage's view of the per-stage context ctx [T, K, C, B] for one problem
// b: element (k, c) of stage t at p[k * sK + c * sC] with p = ctx + t K C B
// + b, sK = C B and sC = B, so a warp's loads of one element coalesce.
struct CtxView {
  const float* p = nullptr;
  int K = 0;
  size_t sK = 0, sC = 0;

  __device__ __forceinline__ float at(int k, int c) const { return p[k * sK + c * sC]; }
};

__device__ __forceinline__ CtxView ctx_view(const float* ctx, int t, int K, int C, size_t sB,
                                            size_t b) {
  CtxView v;
  if (ctx != nullptr) {
    v.p = ctx + static_cast<size_t>(t) * K * C * sB + b;
    v.K = K;
    v.sK = static_cast<size_t>(C) * sB;
    v.sC = sB;
  }
  return v;
}

// Soft collision cost of two cars (examples/multi_agent_single_track.py
// make_collision_cost):  weight exp(-d2 / r2),  d2 = (xi0 - xj0)^2 +
// (xi1 - xj1)^2,  r2 = radius^2 rounded from the Python double and divided
// by, as the JAX expression does.  Parameters: weight, r2.  It reads the
// first NCTX = 2 components of the other car's state.
struct GaussianCollision {
  static constexpr int NPARAMS = 2;
  static constexpr int NCTX = 2;
  float weight, r2;

  static GaussianCollision from(const float* p) { return GaussianCollision{p[0], p[1]}; }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x, const float* xj) const {
    const S dx = x[0] - xj[0];
    const S dy = x[1] - xj[1];
    const S d2 = dx * dx + dy * dy;
    return weight * dexp(-d2 / r2);
  }
};

// Coupled stage cost (strategies/nash.py make_coupled_stage):
//   base(x, u) + sum_{k < K} pair(x, ctx_t[k]),
// the pair costs summed from 0 in index order; K is a run-time argument
// (the loop over neighbours is not unrolled).  Parameters: the base's,
// then the pair's.
template <typename Base, typename Pair>
struct Coupled {
  static constexpr int NPARAMS = Base::NPARAMS + Pair::NPARAMS;
  using PairT = Pair;
  Base base;
  Pair pair;

  static Coupled from(const float* p) {
    return Coupled{Base::from(p), Pair::from(p + Base::NPARAMS)};
  }

  // The other agent k's components that the pair cost reads.
  __device__ __forceinline__ void other(const CtxView& c, int k, float* xj) const {
#pragma unroll
    for (int i = 0; i < Pair::NCTX; ++i) xj[i] = c.at(k, i);
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x, const S* u, const CtxView& c) const {
    S s(0.0f);
#pragma unroll 1
    for (int k = 0; k < c.K; ++k) {
      float xj[Pair::NCTX];
      other(c, k, xj);
      s = s + pair(x, xj);
    }
    return base(x, u) + s;
  }
};

// Lane groups: G consecutive lanes of a warp (G a power of two up to 32)
// work on one problem.  The group's lanes in a warp-wide mask (the block
// size a multiple of 32), for the *_sync intrinsics.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  static_assert(G >= 1 && G <= 32 && (G & (G - 1)) == 0, "G a power of two up to 32");
  if constexpr (G == 32)
    return 0xffffffffu;
  else
    return ((1u << G) - 1u) << ((threadIdx.x & 31u) & ~static_cast<unsigned>(G - 1));
}

// s summed over the G lanes of a group by a fixed xor tree (offsets G/2 ...
// 1); every lane ends with the same value, since a + b and b + a round
// alike.
template <int G, typename S>
__device__ __forceinline__ S group_sum(S s, unsigned mask) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) s = s + shfl_xor(mask, s, off, G);
  return s;
}

template <typename Cost>
struct takes_context {
  static constexpr bool value = false;
};
template <typename Base, typename Pair>
struct takes_context<Coupled<Base, Pair>> {
  static constexpr bool value = true;
};

// The stage cost with or without its context, uniformly.
template <typename Cost, typename S>
__device__ __forceinline__ S stage_cost(const Cost& cost, const S* x, const S* u,
                                        const CtxView& c) {
  if constexpr (takes_context<Cost>::value)
    return cost(x, u, c);
  else
    return cost(x, u);
}

// Path constraints g(x, u) -> [M] (AL rows; the fused loop folds their
// Jacobians in torch, so the kernels evaluate only values).  Each struct
// has M rows, from(params), ok() (parameters the kernel can take) and
// eval<NX, NU>(x, u, g) on scalars of any type S.

// No rows (types.no_constraint): the side of an AL instantiation without
// constraints.
struct NoConstraint {
  static constexpr int M = 0;
  static NoConstraint from(const float*) { return NoConstraint{}; }
  bool ok(int, int) const { return true; }

  template <int NX, int NU, typename S>
  __device__ __forceinline__ void eval(const S*, const S*, S*) const {}
};

// Rows of components against constants (ocp.bound_rows): row r reads
// (code, index, value) from params[3 r ..]: code 0 x[i] - v, 1 v - x[i],
// 2 u[i] - v, 3 v - u[i] -- the expression of the torch callable, so
// v - x[i] is never computed as -(x[i] - v).  The component is picked by
// an unrolled select, so x and u stay in registers.
template <int M_>
struct BoundRows {
  static constexpr int M = M_;
  int code[M], index[M];
  float value[M];

  static BoundRows from(const float* p) {
    BoundRows c;
    for (int r = 0; r < M; ++r) {
      c.code[r] = static_cast<int>(p[3 * r]);
      c.index[r] = static_cast<int>(p[3 * r + 1]);
      c.value[r] = p[3 * r + 2];
    }
    return c;
  }

  bool ok(int nx, int nu) const {
    for (int r = 0; r < M; ++r)
      if (code[r] < 0 || code[r] > 3 || index[r] < 0 || index[r] >= (code[r] < 2 ? nx : nu))
        return false;
    return true;
  }

  template <int NX, int NU, typename S>
  __device__ __forceinline__ void eval(const S* x, const S* u, S* g) const {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      const bool on_x = code[r] < 2;
      S c = on_x ? x[0] : u[0];
#pragma unroll
      for (int j = 1; j < NX; ++j)
        if (on_x && index[r] == j) c = x[j];
#pragma unroll
      for (int j = 1; j < NU; ++j)
        if (!on_x && index[r] == j) c = u[j];
      if (code[r] & 1)
        g[r] = value[r] - c;
      else
        g[r] = c - value[r];
    }
  }
};

// NaN-propagating max(h, 0), as jnp.maximum and torch.maximum behave
// (fmaxf drops a NaN).
__device__ __forceinline__ float max0_nan(float h) { return h != h ? h : fmaxf(h, 0.0f); }

// Zero terminal cost (ocp.zero_terminal_cost).
struct ZeroTerminal {
  static ZeroTerminal from(const float*) { return ZeroTerminal{}; }

  template <typename S>
  __device__ __forceinline__ S operator()(const S*) const { return S(0.0f); }
};

// Diagonal quadratic terminal cost (ocp.diagonal_quadratic_terminal_cost),
// terms summed in the order the torch callable sums them:
//   sum_i w_i (x_i - r_i)^2.  Parameters: w, then r.
template <int NX>
struct DiagQuadraticTerminal {
  static constexpr int NPARAMS = 2 * NX;
  float w[NX], r[NX];

  static DiagQuadraticTerminal from(const float* p) {
    DiagQuadraticTerminal c;
    for (int i = 0; i < NX; ++i) c.w[i] = p[i];
    for (int i = 0; i < NX; ++i) c.r[i] = p[NX + i];
    return c;
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x) const {
    S e = x[0] - r[0];
    S c = w[0] * (e * e);
#pragma unroll
    for (int i = 1; i < NX; ++i) {
      e = x[i] - r[i];
      c = c + w[i] * (e * e);
    }
    return c;
  }
};

// Quadratic terminal cost (models/lqr.py quadratic_terminal_cost):  x'Qf x
// by quadratic_form.  Parameters: Qf, row-major.
template <int NX>
struct QuadraticTerminal {
  static constexpr int NPARAMS = NX * NX;
  float q[NX][NX];

  static QuadraticTerminal from(const float* p) {
    QuadraticTerminal c;
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) c.q[i][j] = p[i * NX + j];
    return c;
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x) const {
    return quadratic_form<NX>(q, x);
  }
};

// RK4 step constants (0.5 dt, dt, dt / 6), rounded to float on the host.
struct Step {
  float half, full, sixth;
  static Step from(const float* p) { return Step{p[0], p[1], p[2]}; }
};

// One classic RK4 step of the continuous dynamics, control held:
//   x + dt/6 (k1 + 2 k2 + 2 k3 + k4), evaluated in the reference's order.
// u is the control (an array or pointer) or a held control (control_hold).
template <typename Dyn, typename S, typename U>
__device__ __forceinline__ void rk4_step(const Dyn& f, const S* x, const U& u,
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

// The stage cost's gradient (lx, lu) at x, u from one pass in
// Dual<float, NX + NU>: tangents 0..NX-1 seed x, NX..NX+NU-1 seed u.
template <int NX, int NU, typename Cost>
__device__ __forceinline__ void cost_gradient(const Cost& cost, const float* x, const float* u,
                                              const CtxView& ctx, float* lx, float* lu) {
  constexpr int NZ = NX + NU;
  using D = Dual<float, NZ>;
  D xd[NX], ud[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) xd[i] = seed<NZ>(x[i], i);
#pragma unroll
  for (int i = 0; i < NU; ++i) ud[i] = seed<NZ>(u[i], NX + i);
  const D c = stage_cost(cost, xd, ud, ctx);
#pragma unroll
  for (int j = 0; j < NX; ++j) lx[j] = c.d[j];
#pragma unroll
  for (int j = 0; j < NU; ++j) lu[j] = c.d[NX + j];
}

// A and B at one stage from one forward pass in Dual<float, NX + NU>
// (tangents 0..NX-1 seed x, NX..NX+NU-1 seed u), and the cost gradient
// (lx, lu) from cost_gradient's pass in the same tangents.  DISCRETE:
// A = d step / dx, B = d step / du through the RK4 step (the
// jacobian_mode "discrete"); otherwise the Jacobians of the continuous
// dynamics f(x, u) (the reference's "continuous" mode, as the TPU kernels'
// step_map with discrete=False).  The control's hold (control_hold) is
// taken once, which gives f's duals at the control.  The context is a
// constant.
template <bool DISCRETE = true, typename Dyn, typename Cost>
__device__ __forceinline__ void stage_derivatives(
    const Dyn& dyn, const Cost& cost, const Step& h, const float* x, const float* u,
    float (*A)[Dyn::NX], float (*Bm)[Dyn::NU], float* lx, float* lu,
    const CtxView& ctx = CtxView()) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU, NZ = NX + NU;
  using D = Dual<float, NZ>;
  D xd[NX], ud[NU], nxt[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) xd[i] = seed<NZ>(x[i], i);
#pragma unroll
  for (int i = 0; i < NU; ++i) ud[i] = seed<NZ>(u[i], NX + i);
  const auto held = control_hold(dyn, static_cast<const D*>(ud));
  if constexpr (DISCRETE)
    rk4_step(dyn, xd, held, h, nxt);
  else
    dyn(xd, held, nxt);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) A[i][j] = nxt[i].d[j];
#pragma unroll
    for (int j = 0; j < NU; ++j) Bm[i][j] = nxt[i].d[NX + j];
  }
  cost_gradient<NX, NU>(cost, x, u, ctx, lx, lu);
}

// K1's linearization: stage_derivatives' A, B, lx, lu (no context), with
// the dynamics' tangents seeded only for the state components f reads
// (state_reads) and the controls, and the held control evaluated once
// (control_hold).  Each of those tangents sees stage_derivatives'
// arithmetic, so its columns come out bit for bit.  The tangent of a
// component f does not read is zero in every k_i, so for finite inputs its
// column of A is exactly e_j (DISCRETE: x_j.d + h/6 (+-0) rounds to the
// seed) or zero (continuous; the full pass may give -0), written without
// a pass.  The cost reads every component: lx and lu come from
// cost_gradient, as in stage_derivatives.
template <bool DISCRETE = true, typename Dyn, typename Cost>
__device__ __forceinline__ void stage_derivatives_live(
    const Dyn& dyn, const Cost& cost, const Step& h, const float* x, const float* u,
    float (*A)[Dyn::NX], float (*Bm)[Dyn::NU], float* lx, float* lu) {
  constexpr int NX = Dyn::NX, NU = Dyn::NU;
  constexpr unsigned R = state_reads<Dyn>::value;
  constexpr int NL = read_count(R), NT = NL + NU;
  using D = Dual<float, NT>;
  D xd[NX], ud[NU], nxt[NX];
  static_for<NX>([&](auto i_) {
    constexpr int i = decltype(i_)::value, l = read_index(R, i);
    if constexpr (l >= 0)
      xd[i] = seed<NT>(x[i], l);
    else
      xd[i] = D(x[i]);
  });
#pragma unroll
  for (int i = 0; i < NU; ++i) ud[i] = seed<NT>(u[i], NL + i);
  const auto held = control_hold(dyn, ud);
  if constexpr (DISCRETE)
    rk4_step(dyn, xd, held, h, nxt);
  else
    dyn(xd, held, nxt);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    static_for<NX>([&](auto j_) {
      constexpr int j = decltype(j_)::value, l = read_index(R, j);
      if constexpr (l >= 0)
        A[i][j] = nxt[i].d[l];
      else
        A[i][j] = DISCRETE && i == j ? 1.0f : 0.0f;
    });
#pragma unroll
    for (int j = 0; j < NU; ++j) Bm[i][j] = nxt[i].d[NL + j];
  }
  cost_gradient<NX, NU>(cost, x, u, CtxView(), lx, lu);
}

// The stage cost's Hessians at one stage from one Dual<Dual<float, NZ>, NZ>
// pass: r.d[q].d[p] = d^2 l / dz_p dz_q, z = (x, u), entry (p, q) with p
// the inner (gradient) direction and q the outer one, as the TPU kernel's
// jvp of lgrad_p along e_q; upper triangles mirrored, as it symmetrizes.
template <int NX, int NU, typename Cost>
__device__ __forceinline__ void stage_hessians(const Cost& cost, const float* x, const float* u,
                                               const CtxView& ctx, float (&lxx)[NX][NX],
                                               float (&luu)[NU][NU], float (&lux)[NU][NX]) {
  constexpr int NZ = NX + NU;
  using D2 = Dual<Dual<float, NZ>, NZ>;
  D2 xd[NX], ud[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) xd[i] = seed2<NZ>(x[i], i);
#pragma unroll
  for (int i = 0; i < NU; ++i) ud[i] = seed2<NZ>(u[i], NX + i);
  const D2 r = stage_cost(cost, xd, ud, ctx);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = i; j < NX; ++j) lxx[i][j] = lxx[j][i] = r.d[j].d[i];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = i; j < NU; ++j) luu[i][j] = luu[j][i] = r.d[NX + j].d[NX + i];
#pragma unroll
  for (int i = 0; i < NU; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) lux[i][j] = r.d[j].d[NX + i];
}

// NaN-propagating clamp min(max(u, lb), ub), as jnp.minimum/maximum and
// torch.minimum/maximum behave.
__device__ __forceinline__ float clamp_nan(float u, float lb, float ub) {
  if (u != u) return u;
  return fminf(fmaxf(u, lb), ub);
}

}  // namespace mas
