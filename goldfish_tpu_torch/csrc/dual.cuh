// Forward-mode dual numbers for the hand-written reverse sweeps.
//
// Dual<T, N> carries a value and N directional derivatives. The kernels
// sweep their densities back by hand (shell_qp.cu: density_grad,
// shell_sweep; penalty_sweep.cuh; vm_stress_qp.cu: vm_sweep) in plain
// doubles, and carry at most a Dual<double, 1> tangent through a sweep:
// seeded with e_k it gives a Hessian column, seeded with lambda's jets the
// second derivatives an adjoint or K6's forward-over-reverse sweep needs.
// They are held against the plain autograd versions.
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
