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
// d cos = -(dx sin), d tan = dx (1 + tan^2), d(x / c) = dx / c.
// Transcendentals are the accurate sinf/cosf/tanf (no fast-math).
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
__device__ __forceinline__ float dsin(float x) { return sinf(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ float dtan(float x) { return tanf(x); }

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

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> dsin(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = dsin(a.v);
  const S c = dcos(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = a.d[k] * c;
  return r;
}

template <typename S, int N>
__device__ __forceinline__ Dual<S, N> dcos(const Dual<S, N>& a) {
  Dual<S, N> r;
  r.v = dcos(a.v);
  const S s = dsin(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) r.d[k] = -(a.d[k] * s);
  return r;
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
