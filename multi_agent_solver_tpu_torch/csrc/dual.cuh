// Forward-mode dual numbers for the kernels' in-thread derivatives.
//
// Dual<S, N> carries a value and N tangents.  The problem functions of
// problems.cuh are templates on their scalar type, so one definition gives
//   float               -> values,
//   Dual<float, N>      -> N directional derivatives at once (one forward
//                          pass instead of N jvps; each tangent component
//                          sees the same arithmetic a single jvp would),
//   Dual<Dual<float, N>, M> -> second derivatives (jvp over jvp).
// The tangent rules are JAX's: d(x y) = dx y + x dy, d sin = dx cos,
// d cos = -(dx sin), d tan = dx (1 + tan^2), d(x / c) = dx / c,
// d(c / x) = (-dx c) (1 / x^2), d sqrt = dx (0.5 / sqrt x), d exp = dx exp;
// d(a / b) = (da - db (a / b)) / b, torch's forward rule for a quotient of
// two variables.
// Transcendentals are the accurate sincosf/tanf/expf and the IEEE sqrtf
// (no fast-math).
#pragma once

template <typename S, int N>
struct Dual {
  S v;
  S d[N];

  __host__ __device__ Dual() {}
  __host__ __device__ Dual(float c) : v(c) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = S(0.0f);
  }
};

// Scalar base cases.
__device__ __forceinline__ float dtan(float x) { return tanf(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator+(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator+(const Dual<S, N>& a, float c) {
  Dual<S, N> r;
  r.v = a.v + c;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator+(float c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c + a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(const Dual<S, N>& a, float c) {
  Dual<S, N> r;
  r.v = a.v - c;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k];
  return r;
}

// c - a: the tangent is -a's (JAX's rule for a constant minus a variable).
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator-(float c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c - a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -a.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator*(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator*(const Dual<S, N>& a, float c) {
  Dual<S, N> r;
  r.v = a.v * c;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator*(float c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c * a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = c * a.d[k];
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator/(const Dual<S, N>& a, float c) {
  Dual<S, N> r;
  r.v = a.v / c;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] / c;
  return r;
}

// c / a for a constant c.
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator/(float c, const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = c / a.v;
  const S inv_sq = 1.0f / (a.v * a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (-a.d[k] * c) * inv_sq;
  return r;
}

// a / b of two variables: the value one IEEE division a.v / b.v (not a
// times 1 / b, which rounds apart from torch), the tangents torch's
// forward rule (da - db r) / b with r = a / b.
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> operator/(const Dual<S, N>& a, const Dual<S, N>& b) {
  Dual<S, N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = (a.d[k] - b.d[k] * r.v) / b.v;
  return r;
}

// sin and cos of one value together: one sincosf (one range reduction;
// the bits of sinf and cosf apart) builds both duals.
__device__ __forceinline__ void dsincos(float x, float& s, float& c) { sincosf(x, &s, &c); }

template <typename S, int N>
__device__ __forceinline__ void dsincos(const Dual<S, N>& a, Dual<S, N>& s, Dual<S, N>& c) {
  dsincos(a.v, s.v, c.v);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    s.d[k] = a.d[k] * c.v;
    c.d[k] = -(a.d[k] * s.v);
  }
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> dtan(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = dtan(a.v);
  const S sec2 = 1.0f + r.v * r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * sec2;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> dsqrt(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = dsqrt(a.v);
  const S half_inv = 0.5f / r.v;
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * half_inv;
  return r;
}

// exp' = exp: the tangent scales by the result, as JAX's rule g * ans.
template <typename S, int N>
__device__ __forceinline__ Dual<S, N> dexp(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = dexp(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * r.v;
  return r;
}

// The primal value of a scalar of any order.
__device__ __forceinline__ float primal(float x) { return x; }

template <typename S, int N>
__device__ __forceinline__ float primal(const Dual<S, N>& a) {
  return primal(a.v);
}

// max(a, c) and min(a, c) against a constant c, NaN-propagating as
// jnp.maximum / jnp.minimum, with their tangent rule: the tangent times 1
// where a wins, 0.5 at a tie, 0 where c wins (a weight taken from the
// primal values, so a constant of every higher order, as JAX's
// _balanced_eq; torch.maximum / torch.minimum give the same 0.5).
__device__ __forceinline__ float dmax(float a, float c) { return a != a ? a : fmaxf(a, c); }
__device__ __forceinline__ float dmin(float a, float c) { return a != a ? a : fminf(a, c); }

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> dmax(const Dual<S, N>& a, float c) {
  const float p = primal(a);
  const float w = p > c ? 1.0f : (p == c ? 0.5f : 0.0f);
  Dual<S, N> r;
  r.v = dmax(a.v, c);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * w;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> dmin(const Dual<S, N>& a, float c) {
  const float p = primal(a);
  const float w = p < c ? 1.0f : (p == c ? 0.5f : 0.0f);
  Dual<S, N> r;
  r.v = dmin(a.v, c);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * w;
  return r;
}

// Seed helpers: a variable whose tangent k is 1 (first order).
template <int N>
__device__ __forceinline__ Dual<float, N> seed(float v, int k) {
  Dual<float, N> r(v);
  r.d[k] = 1.0f;
  return r;
}

// Second order: inner tangent k_in and outer tangent k_out are 1, so that
// r.d[q].d[p] of a function of such variables is d^2 f / dz_p dz_q.
template <int N>
__device__ __forceinline__ Dual<Dual<float, N>, N> seed2(float v, int k) {
  Dual<Dual<float, N>, N> r(v);
  r.v.d[k] = 1.0f;
  r.d[k].v = 1.0f;
  return r;
}

// The xor-shuffle of every component, value and tangents, within segments
// of `width` lanes of a warp (a sum over the lanes of a group).
__device__ __forceinline__ float shfl_xor(unsigned mask, float v, int off, int width) {
  return __shfl_xor_sync(mask, v, off, width);
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> shfl_xor(unsigned mask, const Dual<S, N>& a, int off,
                                               int width) {
  Dual<S, N> r;
  r.v = shfl_xor(mask, a.v, off, width);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = shfl_xor(mask, a.d[k], off, width);
  return r;
}
