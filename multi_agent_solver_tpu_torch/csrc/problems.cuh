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

// Damped pendulum (models/pendulum.py), x = (theta, omega), u = (torque,),
// theta = 0 upright:  f = (omega, (g/l sin theta + u / (m l^2)) - (b / (m
// l^2)) omega), each constant folded in double as Python folds it.
// Parameters: g/l, m l^2, b/(m l^2).
struct Pendulum {
  static constexpr int NX = 2;
  static constexpr int NU = 1;
  float g_l, ml2, b_ml2;

  static Pendulum from(const float* p) { return Pendulum{p[0], p[1], p[2]}; }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    S s, c;
    dsincos(x[0], s, c);
    f[0] = x[1];
    f[1] = (g_l * s + u[0] / ml2) - b_ml2 * x[1];
  }
};

// The pendulum swing-up's stage cost (examples/pendulum_swing_up.py), with
// weights that move over the horizon: s = t / (T - 1) (the stage index as
// a float over the float span T - 1), late = s s, early = 1 - late,
//   w_e (0.2 + 0.8 early) ee ee + w_s (0.2 + 0.8 late) (1 - cos theta)
//     + w_w (0.2 + 0.8 late) omega omega + w_u torque torque,
// ee = ((kin omega omega + mgl cos theta) - mgl) / mgl, each product and sum
// in the torch callable's order.  Parameters: T - 1, w_e, w_s, w_w, w_u,
// mgl, kin (0.5 m l^2).
struct PendulumSwingUp {
  static constexpr int NPARAMS = 7;
  static constexpr bool TAKES_STAGE = true;
  float span, w_energy, w_shape, w_omega, w_u, mgl, kin;

  static PendulumSwingUp from(const float* p) {
    return PendulumSwingUp{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
  }

  template <typename S, typename I>
  __device__ __forceinline__ S operator()(const S* x, const S* u, I t) const {
    const float s = static_cast<float>(t) / span;
    const float late = s * s;
    const float early = 1.0f - late;
    const float we = w_energy * (0.2f + 0.8f * early);
    const float ws = w_shape * (0.2f + 0.8f * late);
    const float ww = w_omega * (0.2f + 0.8f * late);
    S sn, c;
    dsincos(x[0], sn, c);
    const S w2 = x[1] * x[1];
    const S ee = ((kin * w2 + mgl * c) - mgl) / mgl;
    const S up = 1.0f - c;
    return ((we * (ee * ee) + ws * up) + ww * w2) + w_u * (u[0] * u[0]);
  }
};

// Its terminal cost:  w_pos (1 - cos theta) + w_vel omega omega.
// Parameters: w_pos, w_vel.
struct PendulumSwingUpTerminal {
  static constexpr int NPARAMS = 2;
  float w_pos, w_vel;

  static PendulumSwingUpTerminal from(const float* p) {
    return PendulumSwingUpTerminal{p[0], p[1]};
  }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x) const {
    S s, c;
    dsincos(x[0], s, c);
    return w_pos * (1.0f - c) + w_vel * (x[1] * x[1]);
  }
};

// Vertical rocket (models/rocket.py), x = (h, v, m), u = (thrust,):
//   f = (v, thrust / max(m, 1e-6) - g, -thrust / v_e),
// max with jnp.maximum's tangent (dmax: 0.5 at the tie).  f never reads h
// (READS).  Parameters: g, v_e.
struct Rocket {
  static constexpr int NX = 3;
  static constexpr int NU = 1;
  static constexpr unsigned READS = (1u << 1) | (1u << 2);
  float gravity, v_exhaust;

  static Rocket from(const float* p) { return Rocket{p[0], p[1]}; }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    const S mass = dmax(x[2], 1e-6f);
    f[0] = x[1];
    f[1] = u[0] / mass - gravity;
    f[2] = (-u[0]) / v_exhaust;
  }
};

// The rocket's terminal cost (examples/rocket_max_altitude.py):
// w_h h + w_v v v, with w_h = -15 and w_v = 0.5 2 as Python folds them.
// Parameters: w_h, w_v.
struct RocketTerminal {
  static constexpr int NPARAMS = 2;
  float w_h, w_v;

  static RocketTerminal from(const float* p) { return RocketTerminal{p[0], p[1]}; }

  template <typename S>
  __device__ __forceinline__ S operator()(const S* x) const {
    return w_h * x[0] + w_v * (x[1] * x[1]);
  }
};

// Dynamic bicycle with linear tires (models/dynamic_bicycle.py), x = (X, Y,
// psi, vx, vy, r), u = (delta, ax), vx_s = max(vx, v_eps) (dmax):
//   a_f = delta - (vy + lf r) / vx_s,  a_r = -(vy - lr r) / vx_s,
//   F_f = C_f a_f,  F_r = C_r a_r,
//   f = (vx cos psi - vy sin psi, vx sin psi + vy cos psi, r, ax + vy r,
//        (F_f cos delta + F_r) / m - vx r, (lf F_f cos delta - lr F_r) / Iz),
// each product and sum in the torch callable's order.  f never reads X or
// Y (READS).  Parameters: m, Iz, lf, lr, C_f, C_r, v_eps.
struct DynamicBicycle {
  static constexpr int NX = 6;
  static constexpr int NU = 2;
  static constexpr unsigned READS = 0x3cu;
  float mass, iz, lf, lr, caf, car, v_eps;

  static DynamicBicycle from(const float* p) {
    return DynamicBicycle{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
  }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    const S vx = x[3], vy = x[4], r = x[5];
    const S vs = dmax(vx, v_eps);
    const S a_f = u[0] - (vy + lf * r) / vs;
    const S a_r = (-(vy - lr * r)) / vs;
    const S fyf = caf * a_f;
    const S fyr = car * a_r;
    S sp, cp, sd, cd;
    dsincos(x[2], sp, cp);
    dsincos(u[0], sd, cd);
    f[0] = vx * cp - vy * sp;
    f[1] = vx * sp + vy * cp;
    f[2] = r;
    f[3] = u[1] + vy * r;
    f[4] = (fyf * cd + fyr) / mass - vx * r;
    f[5] = ((lf * fyf) * cd - lr * fyr) / iz;
  }
};

// The quadrotor's rigid body (models/quadrotor.py): from x's velocities
// (3-5), ZYX Euler angles (6-8) and body rates (9-11), the thrust fz and
// the body torques, f_0..f_11 -- v, R e_z fz / m - g e_z, the Euler rates
// through cos theta guarded away from 0 by c_eps (sign kept: jnp.where on
// cos theta >= 0 of dmax / dmin), and the diagonal-inertia Euler
// equations, each product and sum in the torch callable's order.
struct QuadBody {
  float mass, gravity, jx, jy, jz, c_eps, jzy, jxz, jyx;   // jzy = jz - jy, ...

  static QuadBody from(const float* p) {
    return QuadBody{p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
  }

  template <typename S>
  __device__ __forceinline__ void eval(const S* x, const S& fz, const S& tx, const S& ty,
                                       const S& tz, S* f) const {
    const S p = x[9], q = x[10], r = x[11];
    S sphi, cphi, sth, cth, spsi, cpsi;
    dsincos(x[6], sphi, cphi);
    dsincos(x[7], sth, cth);
    dsincos(x[8], spsi, cpsi);
    const S a = fz / mass;
    f[0] = x[3];
    f[1] = x[4];
    f[2] = x[5];
    f[3] = ((cpsi * sth) * cphi + spsi * sphi) * a;
    f[4] = ((spsi * sth) * cphi - cpsi * sphi) * a;
    f[5] = (cth * cphi) * a - gravity;
    const S cs = primal(cth) >= 0.0f ? dmax(cth, c_eps) : dmin(cth, -c_eps);
    const S tth = sth / cs;
    const S qr = q * sphi + r * cphi;
    f[6] = p + qr * tth;
    f[7] = q * cphi - r * sphi;
    f[8] = qr / cs;
    f[9] = (tx - (jzy * q) * r) / jx;
    f[10] = (ty - (jxz * p) * r) / jy;
    f[11] = (tz - (jyx * p) * q) / jz;
  }
};

// Quadrotor (models/quadrotor.py), nx = 12, u = (thrust, tau_x, tau_y,
// tau_z).  f never reads the position (READS).  Parameters: QuadBody's.
struct Quadrotor {
  static constexpr int NX = 12;
  static constexpr int NU = 4;
  static constexpr unsigned READS = 0xff8u;
  QuadBody body;

  static Quadrotor from(const float* p) { return Quadrotor{QuadBody::from(p)}; }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    body.eval(x, u[0], u[1], u[2], u[3], f);
  }
};

// Quadrotor with first-order rotor lag (models/quadrotor_rotor.py), nx =
// 16: rotor thrusts w = x[12..15] mixed as fz = ((w0 + w1) + w2) + w3, tau_x
// = arm (w1 - w3), tau_y = arm (w2 - w0), tau_z = k_yaw (((w0 - w1) + w2) -
// w3), and w_dot = (c - w) inv_tau for the commands c = u.  f never reads
// the position (READS).  Parameters: QuadBody's, arm, k_yaw, inv_tau.
struct QuadrotorRotor {
  static constexpr int NX = 16;
  static constexpr int NU = 4;
  static constexpr unsigned READS = 0xfff8u;
  QuadBody body;
  float arm, k_yaw, inv_tau;

  static QuadrotorRotor from(const float* p) {
    return QuadrotorRotor{QuadBody::from(p), p[9], p[10], p[11]};
  }

  template <typename S>
  __device__ __forceinline__ void operator()(const S* x, const S* u, S* f) const {
    const S w0 = x[12], w1 = x[13], w2 = x[14], w3 = x[15];
    const S fz = ((w0 + w1) + w2) + w3;
    const S tx = arm * (w1 - w3);
    const S ty = arm * (w2 - w0);
    const S tz = k_yaw * (((w0 - w1) + w2) - w3);
    body.eval(x, fz, tx, ty, tz, f);
#pragma unroll
    for (int i = 0; i < 4; ++i) f[12 + i] = (u[i] - x[12 + i]) * inv_tau;
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

// A stage cost that reads the stage index declares TAKES_STAGE = true and
// an operator()(x, u, t), t an int or a float: each kernel hands it the
// index in the type its TPU kernel does -- an integer in the selects, the
// rollout and the forward pass, the float that JAX builds in K1, K3 and K7
// -- and the absolute stage (K1 walks the stages backwards).  A cost
// without it is called as cost(x, u) and compiles to the code it did
// before the index was handed down.
template <typename Cost, typename = void>
struct takes_stage : std::false_type {};
template <typename Cost>
struct takes_stage<Cost, std::enable_if_t<Cost::TAKES_STAGE>> : std::true_type {};

// The stage cost at stage t without a context.
template <typename Cost, typename S, typename I>
__device__ __forceinline__ S stage_value(const Cost& cost, const S* x, const S* u, I t) {
  if constexpr (takes_stage<Cost>::value)
    return cost(x, u, t);
  else
    return cost(x, u);
}

// The stage cost with or without its context, uniformly, at stage t (a
// context cost reads no stage index).
template <typename Cost, typename S, typename I>
__device__ __forceinline__ S stage_cost(const Cost& cost, const S* x, const S* u,
                                        const CtxView& c, I t) {
  if constexpr (takes_context<Cost>::value) {
    static_assert(!takes_stage<Cost>::value, "a context cost reads no stage index");
    return cost(x, u, c);
  } else {
    return stage_value(cost, x, u, t);
  }
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
                                              const CtxView& ctx, float t, float* lx,
                                              float* lu) {
  constexpr int NZ = NX + NU;
  using D = Dual<float, NZ>;
  D xd[NX], ud[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) xd[i] = seed<NZ>(x[i], i);
#pragma unroll
  for (int i = 0; i < NU; ++i) ud[i] = seed<NZ>(u[i], NX + i);
  const D c = stage_cost(cost, xd, ud, ctx, t);
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
    float (*A)[Dyn::NX], float (*Bm)[Dyn::NU], float* lx, float* lu, float t,
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
  cost_gradient<NX, NU>(cost, x, u, ctx, t, lx, lu);
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
    float (*A)[Dyn::NX], float (*Bm)[Dyn::NU], float* lx, float* lu, float t) {
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
  cost_gradient<NX, NU>(cost, x, u, CtxView(), t, lx, lu);
}

// Second-order duals of every direction at once hold (1 + N)^2 floats a
// scalar; past HESSIAN_FULL_MAX directions (the quadrotors' 16 and 20) the
// Hessians are taken one column at a time instead, in Dual<Dual<float, N>,
// 1>: column q seeds the outer tangent of z_q alone.  Each entry sees the
// arithmetic of the full pass, so the columns are its floats.
constexpr int HESSIAN_FULL_MAX = 8;

// A variable of a column pass: inner tangent k, outer tangent 1 iff k == q.
template <int N>
__device__ __forceinline__ Dual<Dual<float, N>, 1> seed_col(float v, int k, int q) {
  Dual<Dual<float, N>, 1> r(v);
  r.v.d[k] = 1.0f;
  if (k == q) r.d[0].v = 1.0f;
  return r;
}

// The stage cost's Hessians at one stage from one Dual<Dual<float, NZ>, NZ>
// pass: r.d[q].d[p] = d^2 l / dz_p dz_q, z = (x, u), entry (p, q) with p
// the inner (gradient) direction and q the outer one, as the TPU kernel's
// jvp of lgrad_p along e_q; upper triangles mirrored, as it symmetrizes.
// Past HESSIAN_FULL_MAX directions, column by column (seed_col).
template <int NX, int NU, typename Cost>
__device__ __forceinline__ void stage_hessians(const Cost& cost, const float* x, const float* u,
                                               const CtxView& ctx, float t,
                                               float (&lxx)[NX][NX], float (&luu)[NU][NU],
                                               float (&lux)[NU][NX]) {
  constexpr int NZ = NX + NU;
  if constexpr (NZ <= HESSIAN_FULL_MAX) {
    using D2 = Dual<Dual<float, NZ>, NZ>;
    D2 xd[NX], ud[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) xd[i] = seed2<NZ>(x[i], i);
#pragma unroll
    for (int i = 0; i < NU; ++i) ud[i] = seed2<NZ>(u[i], NX + i);
    const D2 r = stage_cost(cost, xd, ud, ctx, t);
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
  } else {
    using DC = Dual<Dual<float, NZ>, 1>;
    static_for<NZ>([&](auto q_) {
      constexpr int q = decltype(q_)::value;
      DC xd[NX], ud[NU];
#pragma unroll
      for (int i = 0; i < NX; ++i) xd[i] = seed_col<NZ>(x[i], i, q);
#pragma unroll
      for (int i = 0; i < NU; ++i) ud[i] = seed_col<NZ>(u[i], NX + i, q);
      const DC r = stage_cost(cost, xd, ud, ctx, t);
      const Dual<float, NZ>& col = r.d[0];
      if constexpr (q < NX) {
#pragma unroll
        for (int i = 0; i <= q; ++i) lxx[i][q] = lxx[q][i] = col.d[i];
#pragma unroll
        for (int i = 0; i < NU; ++i) lux[i][q] = col.d[NX + i];
      } else {
#pragma unroll
        for (int i = 0; i <= q - NX; ++i) luu[i][q - NX] = luu[q - NX][i] = col.d[NX + i];
      }
    });
  }
}

// NaN-propagating clamp min(max(u, lb), ub), as jnp.minimum/maximum and
// torch.minimum/maximum behave.
__device__ __forceinline__ float clamp_nan(float u, float lb, float ub) {
  if (u != u) return u;
  return fminf(fmaxf(u, lb), ub);
}

}  // namespace mas
