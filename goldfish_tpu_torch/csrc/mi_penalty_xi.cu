// K6 mi_penalty_xi: the xi-derivative of the adjoint-weighted penalty
// residual of moving intersections.
//
// Replaces the xi part of the JAX device program
//   goldfish_tpu/solver/system_mi.py: _jit_res_vjp_mi (the vjp of
//     residual_mi w.r.t. xi; its (cp, h) part is K2 mode 2 on K5's rows).
//
// For every interface point it evaluates
//   G = lambda_z . grad_z f(z, X, hA, hB; dxiA, dxiB),  f = w * density,
// where the jets z (of d), lambda_z (of lambda), X (of cp) and h come from
// basis rows at the point's xi on each side, and writes dG/d(xiA, xiB,
// dxiA, dxiB) (8 numbers, out (I, N, 8)). Torch chains the tangent part
// through the neighbour map of coupling_mi._curve_tangents and multiplies
// by -1.
//
// Design: a warp a point, half a warp a side.
// 1. Rows: in each half, lane l < L = (p + 1)(q + 1) owns basis function
//    l of its side and evaluates its R, R_u, R_v and the second
//    derivatives R_uu, R_uv, R_vv (bspline_rows.cuh: lane_row2, in plain
//    doubles), since G depends on xi through R, R_u and R_v. The two sides
//    run side by side.
// 2. Jets: each lane weights its rows by its node's cp, d, lambda and h;
//    each half sums its side's 25 jets (X 6, z 9, lambda_z 9, h) by the
//    xor butterfly and swaps them with the other half (xor 16), so that
//    every lane holds the same 50.
// 3. Sweep: one hand-written reverse sweep of the density
//    (penalty_sweep.cuh, ALL) in Dual<double, 1> with z's tangent seeded
//    by lambda_z: forward over reverse. Its value part is grad_z f; its
//    tangent part is dG/dy for every input y of the density (z, X, hA,
//    hB, dxiA, dxiB). Every lane runs it on the same sums, so every lane
//    then holds every cotangent.
// 4. Chain: each lane contracts its side's cotangents with its rows' xi
//    derivatives and its node's values (dz/dxi through d, dX/dxi through
//    cp, dlambda_z/dxi against grad_z f, dh/dxi through h), and each half
//    sums them; the dxiA, dxiB cotangents go out as they are. Each output
//    is written once a point: no atomics, the same bits on every launch. A
//    padded point (w = 0) writes zeros.
//
// Mode 1 (`mi_penalty_xi_fwd_kernel`, entry gf_mi_penalty_xi_fwd): the
// xi-forward tangent of the penalty residual r_pen = B^T dF/dz (P, C, 3),
// given t_xi (I, N, 2, 2) and the curve tangents' tangents (I, N, 2) a
// side (coupling_mi._curve_tangents is linear: theirs is its value at
// t_xi). Both the rows and the jets move: d(B^T g) = dB^T g + B^T dg, with
// dB the rows' xi-derivatives (lane_row2's second derivatives) along t_xi
// and dg the tangent of dF/dz through X, z, hA, hB and dxiA, dxiB. The
// same layout: a warp a point, half a warp a side, lane l its basis
// function's rows and their tangents; the halves sum and swap X, z and h
// with their tangents (32 numbers a side); every lane runs one
// penalty_sweep with S = R = Dual<double, 1> (not GEO: the forward
// tangent of dF/dz) and adds its node's dR^T g + R^T dg with three f64
// atomics (as K2 mode 0 scatters; the run-to-run order of the sums
// differs in the last bits). Padded points (w = 0) write nothing. The
// jvp in xi of the JAX package's residual_mi (operations/disp_mi_imop.py,
// jax.jvp of system_mi.py:56).
//
// What bounds it on the H100: latency, at 17-140 points a launch: the
// rows' dependent loads (span starts, knots, weights, nodes) and divisions
// (more than half of a launch when one half-warp took both sides in
// turn), then the sweep's ~1.5 10^3 dependent f64 operations. The rows
// wait in shared memory while the sweep runs, so no register spills.
#include "bspline_rows.cuh"
#include "penalty_sweep.cuh"

namespace gf {
namespace {

constexpr int NOUT = 8;       // (xiA_u, xiA_v, xiB_u, xiB_v, dxiA, dxiB)
constexpr int THREADS = 64;   // 2 points a block
constexpr int RS = 5;         // row derivatives a lane keeps in shared memory
typedef Dual<double, 1> T;

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
  const double* lam;   // (P, C, 3), mode 0
  const double* txi;   // (I, N, 2, 2), mode 1: the tangent of xi
  const double* tdxA;  // (I, N, 2), mode 1: the tangent of dxiA
  const double* tdxB;
  int I, N;
};

// this lane's share of one side's jets: X (Xu, Xv), z and lambda_z
// (value, u, v) and h, through the rows of node `node` (none: -1)
__device__ __forceinline__ void lane_jets(const Args& a, const LaneRow2& r,
                                          long node, double* X, double* z,
                                          double* lz, double& h) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const double cpc = node < 0 ? 0.0 : a.cp[node * 3 + c];
    const double dc = node < 0 ? 0.0 : a.d[node * 3 + c];
    const double lc = node < 0 ? 0.0 : a.lam[node * 3 + c];
    X[c] = r.Ru * cpc;
    X[3 + c] = r.Rv * cpc;
    z[c] = r.R0 * dc;
    z[3 + c] = r.Ru * dc;
    z[6 + c] = r.Rv * dc;
    lz[c] = r.R0 * lc;
    lz[3 + c] = r.Ru * lc;
    lz[6 + c] = r.Rv * lc;
  }
  h = node < 0 ? 0.0 : r.R0 * a.h[node];
}

// this lane's part of dG/d(xi_u, xi_v) of one side: gz, gX the side's
// cotangents (z: 9, X: 6), gh dG/dh; rw this lane's R_u, R_v, R_uu,
// R_uv, R_vv
__device__ __forceinline__ void lane_chain(const Args& a, const double* rw,
                                           long node, const T* gz,
                                           const T* gX, double gh,
                                           double& du, double& dv) {
  double c0 = 0.0, c1 = 0.0, c2 = 0.0;
  if (node >= 0) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const double dc = a.d[node * 3 + c];
      const double cpc = a.cp[node * 3 + c];
      const double lc = a.lam[node * 3 + c];
      // rows R0 (z, lambda_z value, h), R_u (z_u, X_u, ...), R_v
      c0 += gz[c].g[0] * dc + gz[c].v * lc;
      c1 += gz[3 + c].g[0] * dc + gX[c].g[0] * cpc + gz[3 + c].v * lc;
      c2 += gz[6 + c].g[0] * dc + gX[3 + c].g[0] * cpc + gz[6 + c].v * lc;
    }
    c0 += gh * a.h[node];
  }
  // d/du of (R0, R_u, R_v) = (R_u, R_uu, R_uv); d/dv = (R_v, R_uv, R_vv)
  du = rw[0] * c0 + rw[2] * c1 + rw[3] * c2;
  dv = rw[1] * c0 + rw[3] * c1 + rw[4] * c2;
}

// v of side 0 (A) and of side 1 (B) from this lane's value `mine` of side
// `side` and the other half's
__device__ __forceinline__ void swap_halves(double mine, int side,
                                            double& a, double& b) {
  const double other = __shfl_xor_sync(0xffffffffu, mine, 16);
  a = side == 0 ? mine : other;
  b = side == 0 ? other : mine;
}

__global__ void __launch_bounds__(THREADS, 1)
    mi_penalty_xi_kernel(Args a, double* out) {
  __shared__ double sRow[THREADS][RS];
  const size_t n = size_t(a.I) * a.N;
  const size_t pt = (size_t(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const bool live = pt < n;
  // every lane takes part in the ballots and shuffles: a warp past the
  // last point repeats it and writes nothing
  const size_t ik = live ? pt : n - 1;
  const int l = threadIdx.x & 15;
  const int side = (threadIdx.x >> 4) & 1;
  const int i = int(ik / a.N);
  const int pA = a.pairA[i], pB = a.pairB[i];
  const int ip = side == 0 ? pA : pB;
  const LaneRow2 r = lane_row2(a.ss, ip, a.xi[(ik * 2 + side) * 2],
                               a.xi[(ik * 2 + side) * 2 + 1]);
  const long node = r.conn < 0 ? -1 : long(ip) * a.ss.C + r.conn;
  double* rw = sRow[threadIdx.x];
  rw[0] = r.Ru;
  rw[1] = r.Rv;
  rw[2] = r.Ruu;
  rw[3] = r.Ruv;
  rw[4] = r.Rvv;
  double Xs[6], zs[9], ls[9], hs;
  lane_jets(a, r, node, Xs, zs, ls, hs);
  double X[PEN_NX], hA, hB;
  T zt[PEN_NZ];
#pragma unroll
  for (int k = 0; k < 6; ++k) swap_halves(half_sum(Xs[k]), side, X[k], X[6 + k]);
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    double zA, zB, lA, lB;
    swap_halves(half_sum(zs[k]), side, zA, zB);
    swap_halves(half_sum(ls[k]), side, lA, lB);
    zt[k] = T(zA);
    zt[k].g[0] = lA;
    zt[9 + k] = T(zB);
    zt[9 + k].g[0] = lB;
  }
  swap_halves(half_sum(hs), side, hA, hB);
  const double w = a.w[ik];
  T val, gz[PEN_NZ], gX[PEN_NX], gh, gdx[4];
  penalty_sweep<T, true, true>(X, zt, hA, hB, a.dxiA + 2 * ik,
                               a.dxiB + 2 * ik, fmax(a.E[pA], a.E[pB]),
                               a.ad[i], a.ar[i], w, val, gz, gh, gX, gdx);
  // this side's cotangents, selected without a runtime index
  T gzs[9], gXs[6];
#pragma unroll
  for (int k = 0; k < 9; ++k) gzs[k] = side == 0 ? gz[k] : gz[9 + k];
#pragma unroll
  for (int k = 0; k < 6; ++k) gXs[k] = side == 0 ? gX[k] : gX[6 + k];
  double du, dv;
  lane_chain(a, rw, node, gzs, gXs, gh.g[0], du, dv);
  du = half_sum(du);
  dv = half_sum(dv);
  if (live && l < 4) {
    // half A: xiA (outputs 0, 1), dxiA (4, 5); half B: xiB (2, 3), dxiB
    // (6, 7)
    const double v = l == 0 ? du : l == 1 ? dv
                   : side == 0 ? (l == 2 ? gdx[0].g[0] : gdx[1].g[0])
                               : (l == 2 ? gdx[2].g[0] : gdx[3].g[0]);
    const int o = l < 2 ? 2 * side + l : 4 + 2 * side + (l - 2);
    out[ik * NOUT + o] = w == 0.0 ? 0.0 : v;
  }
}

// Mode 1: a warp a point, half a warp a side (see the head of the file)
__global__ void __launch_bounds__(THREADS, 1)
    mi_penalty_xi_fwd_kernel(Args a, double* out) {
  __shared__ double sRow[THREADS][6];
  const size_t n = size_t(a.I) * a.N;
  const size_t pt = (size_t(blockIdx.x) * THREADS + threadIdx.x) >> 5;
  const bool live = pt < n;
  const size_t ik = live ? pt : n - 1;
  const int side = (threadIdx.x >> 4) & 1;
  const int i = int(ik / a.N);
  const int pA = a.pairA[i], pB = a.pairB[i];
  const int ip = side == 0 ? pA : pB;
  const size_t xo = (ik * 2 + side) * 2;
  const LaneRow2 r = lane_row2(a.ss, ip, a.xi[xo], a.xi[xo + 1]);
  const long node = r.conn < 0 ? -1 : long(ip) * a.ss.C + r.conn;
  const double tu = a.txi[xo], tv = a.txi[xo + 1];
  // the rows (R0, R_u, R_v) and their tangents along t_xi
  double* rw = sRow[threadIdx.x];
  rw[0] = r.R0;
  rw[1] = r.Ru;
  rw[2] = r.Rv;
  rw[3] = r.Ru * tu + r.Rv * tv;
  rw[4] = r.Ruu * tu + r.Ruv * tv;
  rw[5] = r.Ruv * tu + r.Rvv * tv;
  // this lane's share of X (Xu, Xv), z (value, u, v) and h, and of their
  // tangents (rows 3-5 in place of 0-2)
  double X[PEN_NX], tX[PEN_NX];
  T zt[PEN_NZ], Xt[PEN_NX], hA, hB;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const int c = k % 3, j = 1 + k / 3;
    const double cpc = node < 0 ? 0.0 : a.cp[node * 3 + c];
    swap_halves(half_sum(rw[j] * cpc), side, X[k], X[6 + k]);
    swap_halves(half_sum(rw[3 + j] * cpc), side, tX[k], tX[6 + k]);
  }
#pragma unroll
  for (int k = 0; k < PEN_NX; ++k) {
    Xt[k] = T(X[k]);
    Xt[k].g[0] = tX[k];
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int c = k % 3, j = k / 3;
    const double dc = node < 0 ? 0.0 : a.d[node * 3 + c];
    double zA, zB, tA, tB;
    swap_halves(half_sum(rw[j] * dc), side, zA, zB);
    swap_halves(half_sum(rw[3 + j] * dc), side, tA, tB);
    zt[k] = T(zA);
    zt[k].g[0] = tA;
    zt[9 + k] = T(zB);
    zt[9 + k].g[0] = tB;
  }
  {
    const double hc = node < 0 ? 0.0 : a.h[node];
    double vA, vB, tA, tB;
    swap_halves(half_sum(rw[0] * hc), side, vA, vB);
    swap_halves(half_sum(rw[3] * hc), side, tA, tB);
    hA = T(vA);
    hA.g[0] = tA;
    hB = T(vB);
    hB.g[0] = tB;
  }
  T dA[2], dB[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    dA[c] = T(a.dxiA[2 * ik + c]);
    dA[c].g[0] = a.tdxA[2 * ik + c];
    dB[c] = T(a.dxiB[2 * ik + c]);
    dB[c].g[0] = a.tdxB[2 * ik + c];
  }
  const double w = a.w[ik];
  T val, g[PEN_NZ], gh;
  penalty_sweep<T, false, false, T>(Xt, zt, hA, hB, dA, dB,
                                    fmax(a.E[pA], a.E[pB]), a.ad[i], a.ar[i],
                                    w, val, g, gh);
  if (!live || node < 0 || w == 0.0) return;
  // this node's dR^T g + R^T dg over its side's 9-jet
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    double acc = 0.0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      // this side's cotangent, selected without a runtime index
      const double gv = side == 0 ? g[3 * j + c].v : g[9 + 3 * j + c].v;
      const double gt =
          side == 0 ? g[3 * j + c].g[0] : g[9 + 3 * j + c].g[0];
      acc += rw[3 + j] * gv + rw[j] * gt;
    }
    atomicAdd(out + node * 3 + c, acc);
  }
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
  if (p < 1 || q < 1 || p > PMAX || q > PMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = size_t(I) * N;
  if (n == 0) return 0;
  Args a{{knots_u, knots_v, su_vals, su_ids, sv_vals, sv_ids, w_cp, n_v, Ku,
          Kv, Su, Sv, C, p, q},
         pairA, pairB, xi, dxiA, dxiB, w, ad, ar, d, cp, h, E, lam,
         nullptr, nullptr, nullptr, I, N};
  const unsigned blocks = unsigned((32 * n + THREADS - 1) / THREADS);
  mi_penalty_xi_kernel<<<blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(a, out);
  return launch_status();
}

// mode 1: out (P, C, 3), zeroed by the caller, += d r_pen/dxi . t_xi
extern "C" int gf_mi_penalty_xi_fwd(
    const double* knots_u, const double* knots_v, const double* su_vals,
    const int* su_ids, const double* sv_vals, const int* sv_ids,
    const double* w_cp, const int* n_v, const int* pairA, const int* pairB,
    const double* xi, const double* dxiA, const double* dxiB,
    const double* txi, const double* tdxA, const double* tdxB,
    const double* w, const double* ad, const double* ar, const double* d,
    const double* cp, const double* h, const double* E, double* out, int Ku,
    int Kv, int Su, int Sv, int C, int p, int q, int I, int N, void* stream) {
  using namespace gf;
  if (p < 1 || q < 1 || p > PMAX || q > PMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t n = size_t(I) * N;
  if (n == 0) return 0;
  Args a{{knots_u, knots_v, su_vals, su_ids, sv_vals, sv_ids, w_cp, n_v, Ku,
          Kv, Su, Sv, C, p, q},
         pairA, pairB, xi, dxiA, dxiB, w, ad, ar, d, cp, h, E, nullptr,
         txi, tdxA, tdxB, I, N};
  const unsigned blocks = unsigned((32 * n + THREADS - 1) / THREADS);
  mi_penalty_xi_fwd_kernel<<<blocks, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(a, out);
  return launch_status();
}
