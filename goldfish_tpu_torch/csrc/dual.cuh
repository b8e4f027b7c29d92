// Forward-mode dual numbers for the per-quadrature-point physics kernels.
//
// Dual<T, N> carries a value and N directional derivatives. Nesting gives
// higher derivatives: Dual<Dual<double, M>, 1> seeded with one outer
// direction e_k and M inner directions yields one column of the Hessian;
// Dual<Dual<double, 1>, K> with an inner direction lambda yields the mixed
// derivative d/dx_i (grad_z f . lambda) for K outer variables x_i.
//
// Each energy density is written once as a template over its scalar type,
// so value, gradient, Hessian and adjoint all come from the same source with
// the exact derivative semantics of the JAX package's automatic
// differentiation. K1 shell_qp and K2 penalty_qp instead sweep their
// densities back by hand (shell_qp.cu: density_grad, shell_sweep;
// penalty_sweep.cuh), carrying at most a Dual<double, 1> tangent; they are
// held against the plain autograd versions.
#pragma once

#include <cuda_runtime.h>

namespace gf {

template <class T, int N>
struct Dual {
  T v;
  T g[N];
  __device__ Dual() {}
  __device__ Dual(double x) : v(x) {
#pragma unroll
    for (int i = 0; i < N; ++i) g[i] = T(0.0);
  }
};

__device__ inline double dsqrt(double x) { return sqrt(x); }
__device__ inline double value_of(double x) { return x; }

template <class T, int N>
__device__ inline double value_of(const Dual<T, N>& a) { return value_of(a.v); }

template <class T, int N>
__device__ inline Dual<T, N> operator+(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] + b.g[i];
  return r;
}

template <class T, int N>
__device__ inline Dual<T, N> operator-(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] - b.g[i];
  return r;
}

template <class T, int N>
__device__ inline Dual<T, N> operator-(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = -a.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = -a.g[i];
  return r;
}

template <class T, int N>
__device__ inline Dual<T, N> operator*(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.v * b.g[i] + a.g[i] * b.v;
  return r;
}

template <class T, int N>
__device__ inline Dual<T, N> operator/(const Dual<T, N>& a, const Dual<T, N>& b) {
  Dual<T, N> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = (a.g[i] - r.v * b.g[i]) / b.v;
  return r;
}

// mixed operations with plain doubles
template <class T, int N>
__device__ inline Dual<T, N> operator+(const Dual<T, N>& a, double b) {
  Dual<T, N> r = a;
  r.v = a.v + b;
  return r;
}
template <class T, int N>
__device__ inline Dual<T, N> operator+(double a, const Dual<T, N>& b) { return b + a; }

template <class T, int N>
__device__ inline Dual<T, N> operator-(const Dual<T, N>& a, double b) {
  Dual<T, N> r = a;
  r.v = a.v - b;
  return r;
}
template <class T, int N>
__device__ inline Dual<T, N> operator-(double a, const Dual<T, N>& b) {
  Dual<T, N> r = -b;
  r.v = a - b.v;
  return r;
}

template <class T, int N>
__device__ inline Dual<T, N> operator*(const Dual<T, N>& a, double b) {
  Dual<T, N> r;
  r.v = a.v * b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] * b;
  return r;
}
template <class T, int N>
__device__ inline Dual<T, N> operator*(double a, const Dual<T, N>& b) { return b * a; }

template <class T, int N>
__device__ inline Dual<T, N> operator/(const Dual<T, N>& a, double b) {
  Dual<T, N> r;
  r.v = a.v / b;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] / b;
  return r;
}

template <class T, int N>
__device__ inline Dual<T, N> dsqrt(const Dual<T, N>& a) {
  Dual<T, N> r;
  r.v = dsqrt(a.v);
  T two_s = r.v * 2.0;
#pragma unroll
  for (int i = 0; i < N; ++i) r.g[i] = a.g[i] / two_s;
  return r;
}

// small 3-vector helpers on any scalar type
template <class S>
__device__ inline S dot3(const S* a, const S* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <class S>
__device__ inline void cross3(const S* a, const S* b, S* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

template <class S>
__device__ inline void unit3(S* a) {
  S n = dsqrt(dot3(a, a));
  a[0] = a[0] / n;
  a[1] = a[1] / n;
  a[2] = a[2] / n;
}

// backwards through the helpers above, for hand-written reverse sweeps
// y = v / |v| backwards: vb = (yb - (yb . y) y) / |v|
template <class S, class T, class U>
__device__ inline void unit3_rev(const T* y, U lv, const S* yb, S* vb) {
  S pr = yb[0] * y[0] + yb[1] * y[1] + yb[2] * y[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) vb[i] = (yb[i] - pr * y[i]) / lv;
}

// c = a x b backwards: ab += b x cb, bb += cb x a
template <class S, class T>
__device__ inline void cross3_rev(const T* a, const T* b, const S* cb, S* ab,
                                  S* bb) {
  S t[3];
  cross3(b, cb, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) ab[i] = ab[i] + t[i];
  cross3(cb, a, t);
#pragma unroll
  for (int i = 0; i < 3; ++i) bb[i] = bb[i] + t[i];
}

// c = a x b, a plain
template <class S>
__device__ inline void cross3_mixed(const double* a, const S* b, S* c) {
  c[0] = b[2] * a[1] - b[1] * a[2];
  c[1] = b[0] * a[2] - b[2] * a[0];
  c[2] = b[1] * a[0] - b[0] * a[1];
}

// Entry points return a cudaError_t as int: the launch status, checked by
// the Python wrapper, which raises on anything but 0.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

}  // namespace gf
