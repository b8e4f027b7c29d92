// K6 mi_penalty_xi: the xi-derivative of the adjoint-weighted penalty
// residual of moving intersections.
//
// Replaces the xi part of the JAX device program
//   goldfish_tpu/solver/system_mi.py: _jit_res_vjp_mi (the vjp of
//     residual_mi w.r.t. xi; its (cp, h) part is K2 mode 2 on K5's rows).
//
// For every interface point the thread evaluates
//   F = lambda_z . grad_z (w * density)(z, X, hA, hB; dxiA, dxiB)
// where every jet (z, lambda_z, X, h) comes from basis rows rebuilt at the
// point's dual xi through bspline.cuh, and writes dF/d(xiA, xiB, dxiA,
// dxiB) (8 numbers, out (I, N, 8)). The scalar type is a dual over a dual
// as in K2 mode 2: the inner direction is lambda, the 8 outer directions
// are the point's two coordinates on each side and its two curve tangents.
// The rows need first and second xi-derivatives (R_u depends on xi), so the
// basis is evaluated at Dual<Dual<double,2>,2>: outer = d/d(u, v) for the
// rows R_u, R_v, inner = d/dxi. Torch chains the tangent part through the
// neighbour map of coupling_mi._curve_tangents and multiplies by -1.
//
// What bounds it on the H100: register pressure and latency. 17 threads do
// ~10^5 flops each in an 18-double scalar type (spilled); the launch
// dominates at the T-beam's size.
#include "bspline.cuh"
#include "penalty_density.cuh"

namespace gf {
namespace {

constexpr int NDIR = 8;  // (xiA_u, xiA_v, xiB_u, xiB_v, dxiA_u, dxiA_v, dxiB_u, dxiB_v)
typedef Dual<double, 2> D2;
typedef Dual<D2, 2> T2;         // rows: outer d/d(u,v), inner d/dxi
typedef Dual<double, 1> In;     // lambda direction
typedef Dual<In, NDIR> O;       // the density's scalar

struct Args {
  SurfSetArgs ss;
  const int* pairA;
  const int* pairB;
  const double* xi;    // (I, N, 2, 2)
  const double* dxiA;  // (I, N, 2)
  const double* dxiB;
  const double* w;     // (I, N)
  const double* ad;    // (I,)
  const double* ar;
  const double* d;     // (P, C, 3)
  const double* cp;
  const double* h;     // (P, C)
  const double* E;     // (P,)
  const double* lam;   // (P, C, 3)
  int I, N;
};

// O-typed scalar from a xi-dual value (value + d/dxi of one side) and an
// optional lambda part of the same shape
__device__ O lift(const D2& a, const D2* lam, int side) {
  O r(a.v);
  if (lam) r.v.g[0] = lam->v;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    r.g[2 * side + k].v = a.g[k];
    if (lam) r.g[2 * side + k].g[0] = lam->g[k];
  }
  return r;
}

// jets of one side: X (u, v derivatives of the geometry), z and lambda_z
// (value, u, v derivatives of d and lambda), h; each as O
__device__ void side_jets(const Args& a, int side, int ip, size_t ik, O* X,
                          O* z, O& h) {
  const double u0 = a.xi[(ik * 2 + side) * 2];
  const double v0 = a.xi[(ik * 2 + side) * 2 + 1];
  T2 u(u0), v(v0), R[LMAX];
  u.v.g[0] = 1.0;
  u.g[0].v = 1.0;
  v.v.g[1] = 1.0;
  v.g[1].v = 1.0;
  int conn[LMAX];
  rational_rows(a.ss, ip, u, v, conn, R);
  const int L = (a.ss.p + 1) * (a.ss.q + 1);
  D2 Xj[6], zj[9], lj[9], hj(0.0);
  for (int m = 0; m < 6; ++m) Xj[m] = D2(0.0);
  for (int m = 0; m < 9; ++m) zj[m] = lj[m] = D2(0.0);
  for (int l = 0; l < L; ++l) {
    const size_t node = size_t(ip) * a.ss.C + conn[l];
    const D2 rows[3] = {R[l].v, R[l].g[0], R[l].g[1]};  // R0, R_u, R_v
    for (int c = 0; c < 3; ++c) {
      const double cpc = a.cp[node * 3 + c];
      const double dc = a.d[node * 3 + c];
      const double lc = a.lam[node * 3 + c];
      Xj[c] = Xj[c] + rows[1] * cpc;
      Xj[3 + c] = Xj[3 + c] + rows[2] * cpc;
      for (int j = 0; j < 3; ++j) {
        zj[3 * j + c] = zj[3 * j + c] + rows[j] * dc;
        lj[3 * j + c] = lj[3 * j + c] + rows[j] * lc;
      }
    }
    hj = hj + rows[0] * a.h[node];
  }
  for (int m = 0; m < 6; ++m) X[m] = lift(Xj[m], nullptr, side);
  for (int m = 0; m < 9; ++m) z[m] = lift(zj[m], &lj[m], side);
  h = lift(hj, nullptr, side);
}

__global__ void mi_penalty_xi_kernel(Args a, double* out) {
  const size_t ik = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (ik >= size_t(a.I) * a.N) return;
  const int i = int(ik / a.N);
  const int pA = a.pairA[i], pB = a.pairB[i];
  O X[PEN_NX], z[PEN_NZ], hA, hB, dxA[2], dxB[2];
  side_jets(a, 0, pA, ik, X, z, hA);
  side_jets(a, 1, pB, ik, X + 6, z + 9, hB);
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    dxA[c] = O(a.dxiA[ik * 2 + c]);
    dxA[c].g[4 + c].v = 1.0;
    dxB[c] = O(a.dxiB[ik * 2 + c]);
    dxB[c].g[6 + c].v = 1.0;
  }
  const double E = fmax(a.E[pA], a.E[pB]);
  O f = penalty_density(X, z, hA, hB, dxA, dxB, E, a.ad[i], a.ar[i], a.w[ik]);
#pragma unroll
  for (int k = 0; k < NDIR; ++k) out[ik * NDIR + k] = f.g[k].g[0];
}

}  // namespace
}  // namespace gf

extern "C" int gf_mi_penalty_xi(
    const double* knots_u, const double* knots_v, const double* su_vals,
    const int* su_ids, const double* sv_vals, const int* sv_ids,
    const double* w_cp, const int* n_v, const int* pairA, const int* pairB,
    const double* xi, const double* dxiA, const double* dxiB, const double* w,
    const double* ad, const double* ar, const double* d, const double* cp,
    const double* h, const double* E, const double* lam, double* out, int Ku,
    int Kv, int Su, int Sv, int C, int p, int q, int I, int N, void* stream) {
  using namespace gf;
  if (p > PMAX || q > PMAX) return static_cast<int>(cudaErrorInvalidValue);
  size_t n = size_t(I) * N;
  if (n == 0) return 0;
  Args a{{knots_u, knots_v, su_vals, su_ids, sv_vals, sv_ids, w_cp, n_v, Ku,
          Kv, Su, Sv, C, p, q},
         pairA, pairB, xi, dxiA, dxiB, w, ad, ar, d, cp, h, E, lam, I, N};
  mi_penalty_xi_kernel<<<unsigned((n + 63) / 64), 64, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, out);
  return launch_status();
}
