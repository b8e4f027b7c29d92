// K2 penalty_qp: penalty coupling of non-matching patches at every interface
// quadrature point, with its derivatives by dual numbers.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/coupling.py: qp_penalty_density, penalty_energy
//     (value; gradient = system.residual's coupling part),
//     interface_hessians (the per-qp 18x18 jet Hessian),
//   goldfish_tpu/solver/implicit.py: _jit_entry/_jit_res_pot/_jit_trial and
//     _jit_residual_vjp (coupling part).
//
// One thread per interface qp (one per (qp, Hessian column) in mode 1). The
// density depends on the displacement only through the 18-jet
//   z = (uA, uA_u, uA_v, uB, uB_u, uB_v),
// on the geometry through (XA_u, XA_v, XB_u, XB_v) and on the thickness
// through (hA, hB):
//   w dl [ad E h/2 |uA-uB|^2 + ar E h^3/24 (dphi^2 + dbeta^2)],
// with dphi, dbeta the normal and co-normal rotation jumps.
//
// Modes as in shell_qp.cu: 0 value+grad (per-interface energy summed in a
// fixed order inside the block; r and dW/dh by f64 atomics), 1 hess
// (I, N, 18, 18), 2 adjoint (-d/d(cp,h) of lambda^T r_pen).
//
// What bounds it on the H100: nothing at the wing20 size (992 qps, well
// under one wave of the card); the launch and the register spills of the
// nested dual type dominate. Kept one thread per qp for simplicity.
//
// The density itself (penalty_density.cuh) is shared with K6 mi_penalty_xi.
#include "dual.cuh"
#include "penalty_density.cuh"

namespace gf {
namespace {

constexpr int NZ = PEN_NZ;  // (uA, uAu, uAv, uB, uBu, uBv) x 3
constexpr int NX = PEN_NX;  // (XAu, XAv, XBu, XBv) x 3

struct Args {
  const double* RA[3];  // RA00, RA10, RA01: (I, N, L)
  const double* RB[3];
  const int* connA;     // (I, N, L)
  const int* connB;
  const int* pairA;     // (I,)
  const int* pairB;
  const double* w;      // (I, N)
  const double* dxiA;   // (I, N, 2)
  const double* dxiB;
  const double* ad;     // (I,)
  const double* ar;
  const double* d;      // (P, C, 3)
  const double* cp;
  const double* h;      // (P, C)
  const double* E;      // (P,)
  const double* lam;    // (P, C, 3), mode 2 only
  int I, N, L, C;
};

// value, d/du, d/dv jets of a (P, C, 3) field on one side of qp t
__device__ void side_jets(const Args& a, const double* const* R,
                          const int* conn, int p, size_t t, const double* f,
                          double* out) {
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = 0.0;
  for (int l = 0; l < a.L; ++l) {
    const double* c = f + (size_t(p) * a.C + conn[t * a.L + l]) * 3;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double r = R[j][t * a.L + l];
      out[3 * j] += r * c[0];
      out[3 * j + 1] += r * c[1];
      out[3 * j + 2] += r * c[2];
    }
  }
}

__device__ double side_h(const Args& a, const double* const* R,
                         const int* conn, int p, size_t t) {
  double s = 0.0;
  for (int l = 0; l < a.L; ++l)
    s += R[0][t * a.L + l] * a.h[size_t(p) * a.C + conn[t * a.L + l]];
  return s;
}

struct Point {
  int pA, pB;
  double X[NX], z[NZ], hA, hB, E;
};

__device__ void load_point(const Args& a, size_t t, Point& pt) {
  int i = int(t / a.N);
  pt.pA = a.pairA[i];
  pt.pB = a.pairB[i];
  double jA[9], jB[9];
  side_jets(a, a.RA, a.connA, pt.pA, t, a.cp, jA);
  side_jets(a, a.RB, a.connB, pt.pB, t, a.cp, jB);
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    pt.X[k] = jA[3 + k];
    pt.X[6 + k] = jB[3 + k];
  }
  side_jets(a, a.RA, a.connA, pt.pA, t, a.d, pt.z);
  side_jets(a, a.RB, a.connB, pt.pB, t, a.d, pt.z + 9);
  pt.hA = side_h(a, a.RA, a.connA, pt.pA, t);
  pt.hB = side_h(a, a.RB, a.connB, pt.pB, t);
  pt.E = fmax(a.E[pt.pA], a.E[pt.pB]);
}

template <class S>
__device__ S eval(const Args& a, size_t t, const Point& pt, const S* X,
                  const S* z, S hA, S hB) {
  int i = int(t / a.N);
  return penalty_density(X, z, hA, hB, a.dxiA + 2 * t, a.dxiB + 2 * t, pt.E,
                         a.ad[i], a.ar[i], a.w[t]);
}

// out_f[node] += sign * B^T gz for one side (gz: 9 jet components);
// out_h[node] += sign * R00 gh
__device__ void scatter_side(const Args& a, const double* const* R,
                             const int* conn, int p, size_t t, const double* gz,
                             double gh, double sign, double* out_f,
                             double* out_h) {
  for (int l = 0; l < a.L; ++l) {
    size_t node = size_t(p) * a.C + conn[t * a.L + l];
    double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double r = R[j][t * a.L + l];
      acc[0] += r * gz[3 * j];
      acc[1] += r * gz[3 * j + 1];
      acc[2] += r * gz[3 * j + 2];
    }
    atomicAdd(out_f + node * 3, sign * acc[0]);
    atomicAdd(out_f + node * 3 + 1, sign * acc[1]);
    atomicAdd(out_f + node * 3 + 2, sign * acc[2]);
    atomicAdd(out_h + node, sign * R[0][t * a.L + l] * gh);
  }
}

// mode 0: blockDim = N * (interfaces per block)
__global__ void penalty_value_grad(Args a, double* W, double* r, double* dh) {
  extern __shared__ double sm[];
  int ipb = blockDim.x / a.N;
  int i = blockIdx.x * ipb + threadIdx.x / a.N;
  int n = threadIdx.x % a.N;
  bool active = threadIdx.x < ipb * a.N && i < a.I;
  double val = 0.0;
  if (active) {
    typedef Dual<double, NZ + 2> S;
    size_t t = size_t(i) * a.N + n;
    Point pt;
    load_point(a, t, pt);
    S Xs[NX], zs[NZ];
#pragma unroll
    for (int k = 0; k < NX; ++k) Xs[k] = S(pt.X[k]);
#pragma unroll
    for (int k = 0; k < NZ; ++k) {
      zs[k] = S(pt.z[k]);
      zs[k].g[k] = 1.0;
    }
    S hA(pt.hA), hB(pt.hB);
    hA.g[NZ] = 1.0;
    hB.g[NZ + 1] = 1.0;
    S f = eval(a, t, pt, Xs, zs, hA, hB);
    val = f.v;
    scatter_side(a, a.RA, a.connA, pt.pA, t, f.g, f.g[NZ], 1.0, r, dh);
    scatter_side(a, a.RB, a.connB, pt.pB, t, f.g + 9, f.g[NZ + 1], 1.0, r, dh);
  }
  sm[threadIdx.x] = val;
  __syncthreads();
  if (active && n == 0) {
    double s = 0.0;
    for (int k = 0; k < a.N; ++k) s += sm[threadIdx.x + k];
    W[i] = s;
  }
}

// mode 1: one thread per (qp, column k)
__global__ void penalty_hess(Args a, double* H) {
  size_t g = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  size_t nqp = size_t(a.I) * a.N;
  if (g >= nqp * NZ) return;
  size_t t = g / NZ;
  int k = int(g % NZ);
  typedef Dual<double, NZ> In;
  typedef Dual<In, 1> S;
  Point pt;
  load_point(a, t, pt);
  S Xs[NX], zs[NZ];
#pragma unroll
  for (int m = 0; m < NX; ++m) Xs[m] = S(pt.X[m]);
#pragma unroll
  for (int m = 0; m < NZ; ++m) {
    zs[m] = S(pt.z[m]);
    zs[m].v.g[m] = 1.0;
  }
  zs[k].g[0].v = 1.0;
  S f = eval(a, t, pt, Xs, zs, S(pt.hA), S(pt.hB));
  double* row = H + (t * NZ + k) * NZ;
#pragma unroll
  for (int j = 0; j < NZ; ++j) row[j] = f.g[0].g[j];
}

// mode 2: one thread per qp
__global__ void penalty_adjoint(Args a, double* dcp, double* dh) {
  size_t t = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= size_t(a.I) * a.N) return;
  typedef Dual<double, 1> In;
  typedef Dual<In, NX + 2> S;
  Point pt;
  load_point(a, t, pt);
  double lz[NZ];
  side_jets(a, a.RA, a.connA, pt.pA, t, a.lam, lz);
  side_jets(a, a.RB, a.connB, pt.pB, t, a.lam, lz + 9);
  S Xs[NX], zs[NZ];
#pragma unroll
  for (int m = 0; m < NX; ++m) {
    Xs[m] = S(pt.X[m]);
    Xs[m].g[m].v = 1.0;
  }
#pragma unroll
  for (int m = 0; m < NZ; ++m) {
    zs[m] = S(pt.z[m]);
    zs[m].v.g[0] = lz[m];
  }
  S hA(pt.hA), hB(pt.hB);
  hA.g[NX].v = 1.0;
  hB.g[NX + 1].v = 1.0;
  S f = eval(a, t, pt, Xs, zs, hA, hB);
  // geometry gradients enter through the d/du, d/dv rows only: pad the
  // value slot of each side's 9-jet with zero
  double gA[9] = {0.0, 0.0, 0.0}, gB[9] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    gA[3 + m] = f.g[m].g[0];
    gB[3 + m] = f.g[6 + m].g[0];
  }
  scatter_side(a, a.RA, a.connA, pt.pA, t, gA, f.g[NX].g[0], -1.0, dcp, dh);
  scatter_side(a, a.RB, a.connB, pt.pB, t, gB, f.g[NX + 1].g[0], -1.0, dcp, dh);
}

}  // namespace
}  // namespace gf

extern "C" int gf_penalty_qp(int mode, const double* RA00, const double* RA10,
                             const double* RA01, const double* RB00,
                             const double* RB10, const double* RB01,
                             const int* connA, const int* connB,
                             const int* pairA, const int* pairB,
                             const double* w, const double* dxiA,
                             const double* dxiB, const double* ad,
                             const double* ar, const double* d,
                             const double* cp, const double* h,
                             const double* E, const double* lam, double* out_w,
                             double* out_f, double* out_h, int I, int N, int L,
                             int C, void* stream) {
  using namespace gf;
  Args a{{RA00, RA10, RA01}, {RB00, RB10, RB01}, connA, connB, pairA, pairB,
         w, dxiA, dxiB, ad, ar, d, cp, h, E, lam, I, N, L, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t nqp = size_t(I) * N;
  if (nqp == 0) return 0;
  if (N > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    int ipb = N >= 128 ? 1 : 128 / N;
    int threads = ipb * N;
    int blocks = (I + ipb - 1) / ipb;
    penalty_value_grad<<<blocks, threads, threads * sizeof(double), s>>>(
        a, out_w, out_f, out_h);
  } else if (mode == 1) {
    size_t n = nqp * NZ;
    penalty_hess<<<unsigned((n + 127) / 128), 128, 0, s>>>(a, out_f);
  } else if (mode == 2) {
    penalty_adjoint<<<unsigned((nqp + 127) / 128), 128, 0, s>>>(a, out_f,
                                                                out_h);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
