// K11 vlm_aic: the vortex-lattice aerodynamic influence matrix (AIC) of
// unit horseshoe vortices and its pullback to the lattice geometry.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/vlm.py: _seg_induced (:94), _semiinf_induced
//     (:112), _horseshoe_induced (:126), and the AIC contraction of
//     solve_panel_forces (:162-166); and jax's VJP through them (the
//     coupled aeroelastic gradient differentiates the AIC).
//
// For collocation point c_i with unit normal n_i and panel j with bound
// segment A_j -> B_j (trailing legs to infinity along the unit wake w):
//   AIC[i, j] = (v_hs(c_i; A_j, B_j) + v_hs(c_i; m B_j, m A_j)) . n_i,
//   m = (1, -1, 1) (the mirrored half wing, when `symmetric`),
//   v_hs = v_seg(A, B) + v_semi(B) - v_semi(A) with the reference's
//   regularization: + 1e-300 on the norms, core 1e-8 added to |r1 x r2|^2
//   and |w x r|^2.
//
// Layout (both modes): a block is 4 warps; a warp spans 32 consecutive
// panels j, a thread owns one panel and loops over a strip of S
// collocation points i (warp k of the block takes rows [i0 + k S, i0 + (k
// + 1) S)). The block stages its 4 S points and normals in shared memory;
// a thread reads its panel's ends once.
//   0 value: AIC (N, N) f64, one store a pair, coalesced along j.
//   1 VJP: given gbar = dL/dAIC (N, N), dL/dc, dL/dn (row sums over j) and
//     dL/dA, dL/dB (column sums over i), each (N, 3). v_ij is a plain sum of
//     three segment contributions a horseshoe (six with the mirror), and
//     the cotangent of each is the same 3-vector gbar_ij n_i, known before
//     any is evaluated; so each segment is evaluated and swept back on its
//     own, in plain doubles, with no tape across segments (`horseshoe_rev`:
//     the bound segment and the two legs share r1 = P - A, r2 = P - B and
//     their norms). The mirror's chain runs through m and its reversed ends.
//     dL/dn_i gets gbar_ij v_ij from the same forward evaluations. A
//     thread's dA, dB partials stay in registers across its strip and are
//     summed over the block's warps in shared memory in a fixed order (one
//     f64 atomic per (column, block, component)); each row's dc, dn
//     partials are summed across the warp by __shfl_xor_sync, a
//     reduce-scatter (`warp_sum8`; one atomic per (row, warp, component),
//     from six lanes). Lanes past N stay in every shuffle with zeros.
//
// What bounds it on the H100: f64 operations (the value's ~265 a pair, the
// VJP's sweep count in chip_smoke.py, SWEEP_AIC, with its divisions and
// square roots), not bytes: N^2 gbar reads or AIC stores are 8 MB at N =
// 1024.
#include "dual.cuh"

namespace gf {
namespace {

constexpr double FOUR_PI = 4.0 * 3.141592653589793;
constexpr double CORE = 1e-8;
constexpr int WARPS = 4;   // warps a block, each on its own rows
constexpr int SMAX = 8;    // rows a warp at most (the strip length S)

// A horseshoe A -> B at P: its three segments share r1 = P - A, r2 = P - B
// and their norms l; il = 1 / (l + 1e-300), the reference's regularized
// quotient, is also 1 / l wherever l > 1e-284 (the norms' derivatives r /
// l). Each segment divides once: its 1 / den.
struct Shoe {
  double r1[3], r2[3], r0[3], l1, l2, il1, il2;
  __device__ Shoe(const double* P, const double* A, const double* B) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r1[k] = P[k] - A[k];
      r2[k] = P[k] - B[k];
      r0[k] = B[k] - A[k];
    }
    l1 = sqrt(dot3(r1, r1));
    l2 = sqrt(dot3(r2, r2));
    il1 = 1.0 / (l1 + 1e-300);
    il2 = 1.0 / (l2 + 1e-300);
  }
};

// the bound segment: v = cr k, cr = r1 x r2, k = (t1 - t2) iden, t =
// (r0 . r) il, iden = 1 / ((|cr|^2 + CORE) 4 pi)
__device__ inline double bound_k(const Shoe& s, double* cr, double& t1,
                                 double& t2, double& iden) {
  cross3(s.r1, s.r2, cr);
  t1 = dot3(s.r0, s.r1) * s.il1;
  t2 = dot3(s.r0, s.r2) * s.il2;
  iden = 1.0 / ((dot3(cr, cr) + CORE) * FOUR_PI);
  return (t1 - t2) * iden;
}

// the semi-infinite leg from E along the unit w at r = P - E: v = cr k, cr
// = w x r, k = (cosv + 1) iden, cosv = (w . r) il, iden = 1 / ((|cr|^2 +
// CORE) 4 pi)
__device__ inline double leg_k(const double* r, double il, const double* w,
                               double* cr, double& cosv, double& iden) {
  cross3(w, r, cr);
  cosv = dot3(w, r) * il;
  iden = 1.0 / ((dot3(cr, cr) + CORE) * FOUR_PI);
  return (cosv + 1.0) * iden;
}

// unit horseshoe A -> B: bound segment, (B -> inf), (inf -> A); adds to v
__device__ inline void horseshoe_add(const double* P, const double* A,
                                     const double* B, const double* w,
                                     double* v) {
  const Shoe s(P, A, B);
  double cb[3], cB[3], cA[3], t1, t2, cosv, iden;
  const double kb = bound_k(s, cb, t1, t2, iden);
  const double kB = leg_k(s.r2, s.il2, w, cB, cosv, iden);
  const double kA = leg_k(s.r1, s.il1, w, cA, cosv, iden);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[c] = v[c] + ((cb[c] * kb + cB[c] * kB) - cA[c] * kA);
}

// AIC entry v . n of panel (A, B) at c
__device__ inline double aic_entry(const double* c, const double* A,
                                   const double* B, const double* n,
                                   const double* w, int sym) {
  double v[3] = {0.0, 0.0, 0.0};
  horseshoe_add(c, A, B, w, v);
  if (sym) {
    // the mirror image across y = 0, ends reversed: m B -> m A
    const double Am[3] = {A[0], -A[1], A[2]};
    const double Bm[3] = {B[0], -B[1], B[2]};
    horseshoe_add(c, Bm, Am, w, v);
  }
  return (v[0] * n[0] + v[1] * n[1]) + v[2] * n[2];
}

// One semi-infinite leg at r (|r| = l, il as in Shoe) with the cotangent s
// vb of its velocity (s = +-1): adds s v_leg to v and the leg's pullback
// in r to rb, in l to lb.
__device__ inline void leg_rev(const double* r, double il, const double* w,
                               const double* vb, double s, double* v,
                               double* rb, double& lb) {
  double cr[3], cosv, iden;
  const double k = leg_k(r, il, w, cr, cosv, iden);
  double kb = 0.0;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    v[c] += s * (cr[c] * k);
    kb += vb[c] * cr[c];
  }
  // k = (cosv + 1) iden: cosv's cotangent cb, |cr|^2's cr2b
  const double cb = s * kb * iden;
  const double cr2b2 = -2.0 * (cb * k) * FOUR_PI;
  double crb[3], x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) crb[c] = s * vb[c] * k + cr2b2 * cr[c];
  cross3(crb, w, x);   // cr = w x r: rb += crb x w
  // cosv = (w . r) il
  const double ab = cb * il;
  lb -= ab * cosv;
#pragma unroll
  for (int c = 0; c < 3; ++c) rb[c] += ab * w[c] + x[c];
}

// The unit horseshoe A -> B at P swept back by hand: adds its velocity to
// v and, for the cotangent vb of that velocity, its pullback to Pb, Ab, Bb.
// Each segment is evaluated and swept back on its own.
__device__ inline void horseshoe_rev(const double* P, const double* A,
                                     const double* B, const double* w,
                                     const double* vb, double* v, double* Pb,
                                     double* Ab, double* Bb) {
  const Shoe s(P, A, B);
  double r1b[3], r2b[3], r0b[3], l1b, l2b;
  {
    // the bound segment: k = (t1 - t2) iden, iden of |cr|^2
    double cr[3], t1, t2, iden;
    const double k = bound_k(s, cr, t1, t2, iden);
    double kb = 0.0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[c] += cr[c] * k;
      kb += vb[c] * cr[c];
    }
    const double nb = kb * iden;
    const double cr2b2 = -2.0 * (nb * k) * FOUR_PI;
    double crb[3], x1[3], x2[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) crb[c] = vb[c] * k + cr2b2 * cr[c];
    cross3(s.r2, crb, x1);   // cr = r1 x r2: r1b += r2 x crb, r2b += crb x r1
    cross3(crb, s.r1, x2);
    // t = (r0 . r) il
    const double a1b = nb * s.il1, a2b = -(nb * s.il2);
    l1b = -(a1b * t1);
    l2b = -(a2b * t2);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      r1b[c] = a1b * s.r0[c] + x1[c];
      r2b[c] = a2b * s.r0[c] + x2[c];
      r0b[c] = a1b * s.r1[c] + a2b * s.r2[c];
    }
  }
  leg_rev(s.r2, s.il2, w, vb, 1.0, v, r2b, l2b);    // B -> infinity
  leg_rev(s.r1, s.il1, w, vb, -1.0, v, r1b, l1b);   // infinity -> A
  const double s1 = l1b * s.il1, s2 = l2b * s.il2;  // l = |r|
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const double g1 = r1b[c] + s1 * s.r1[c], g2 = r2b[c] + s2 * s.r2[c];
    Pb[c] += g1 + g2;
    Ab[c] -= g1 + r0b[c];
    Bb[c] += r0b[c] - g2;
  }
}

// The warp's sum of v[0..7] by a reduce-scatter in a fixed order: three
// halving exchanges (xor 16, 8, 4; 4 + 2 + 1 shuffles) leave each lane with
// one slot summed over the 8 lanes that share its bits 1 and 0, two more
// (xor 2, 1) over all 32. Returns slot lane >> 2 of the sum; 9 shuffles
// where a butterfly of each value takes 40.
__device__ inline double warp_sum8(const double* v, int lane) {
  const unsigned full = 0xffffffffu;
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  double x[4], y[2];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    x[t] = (h4 ? v[4 + t] : v[t]) +
           __shfl_xor_sync(full, h4 ? v[t] : v[4 + t], 16);
#pragma unroll
  for (int t = 0; t < 2; ++t)
    y[t] = (h3 ? x[2 + t] : x[t]) +
           __shfl_xor_sync(full, h3 ? x[t] : x[2 + t], 8);
  double z = (h2 ? y[1] : y[0]) + __shfl_xor_sync(full, h2 ? y[0] : y[1], 4);
  z += __shfl_xor_sync(full, z, 2);
  z += __shfl_xor_sync(full, z, 1);
  return z;
}

// the block's rows [i0, i0 + nrow) of colloc and nhat into shared memory
__device__ inline int stage_rows(const double* colloc, const double* nhat,
                                 int N, int S, double (*sc)[3],
                                 double (*sn)[3], int& i0) {
  i0 = blockIdx.y * WARPS * S;
  const int nrow = min(WARPS * S, N - i0);
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int t = tid; t < 3 * nrow; t += 32 * WARPS) {
    sc[t / 3][t % 3] = colloc[3 * size_t(i0) + t];
    sn[t / 3][t % 3] = nhat[3 * size_t(i0) + t];
  }
  return nrow;
}

__global__ void __launch_bounds__(32 * WARPS)
aic_value_kernel(const double* colloc, const double* nhat, const double* A,
                 const double* B, const double* wake, int N, int sym, int S,
                 double* aic) {
  __shared__ double sc[WARPS * SMAX][3], sn[WARPS * SMAX][3];
  int i0;
  const int nrow = stage_rows(colloc, nhat, N, S, sc, sn, i0);
  __syncthreads();
  const int j = blockIdx.x * 32 + threadIdx.x;
  if (j >= N) return;   // no shuffle in this mode
  const double w[3] = {wake[0], wake[1], wake[2]};
  const double a[3] = {A[3 * j], A[3 * j + 1], A[3 * j + 2]};
  const double b[3] = {B[3 * j], B[3 * j + 1], B[3 * j + 2]};
  for (int r = 0; r < S; ++r) {
    const int ii = threadIdx.y * S + r;
    if (ii >= nrow) break;
    aic[size_t(i0 + ii) * N + j] = aic_entry(sc[ii], a, b, sn[ii], w, sym);
  }
}

__global__ void __launch_bounds__(32 * WARPS)
aic_vjp_kernel(const double* colloc, const double* nhat, const double* A,
               const double* B, const double* wake, const double* gbar,
               int N, int sym, int S, double* dcol, double* dn, double* dA,
               double* dB) {
  __shared__ double sc[WARPS * SMAX][3], sn[WARPS * SMAX][3];
  __shared__ double scol[WARPS][32][6];
  int i0;
  const int nrow = stage_rows(colloc, nhat, N, S, sc, sn, i0);
  __syncthreads();
  const int lane = threadIdx.x;
  const int j = blockIdx.x * 32 + lane;
  const bool live = j < N;
  const int jj = live ? j : N - 1;   // a real panel, its result unused
  const double w[3] = {wake[0], wake[1], wake[2]};
  const double a[3] = {A[3 * jj], A[3 * jj + 1], A[3 * jj + 2]};
  const double b[3] = {B[3 * jj], B[3 * jj + 1], B[3 * jj + 2]};
  const double am[3] = {a[0], -a[1], a[2]}, bm[3] = {b[0], -b[1], b[2]};
  double ga[3] = {0.0, 0.0, 0.0}, gb[3] = {0.0, 0.0, 0.0};
  for (int r = 0; r < S; ++r) {
    const int ii = threadIdx.y * S + r;
    if (ii >= nrow) break;   // uniform across the warp
    double row[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};  // dc, dn
    if (live) {
      const double g = gbar[size_t(i0 + ii) * N + j];
      const double vb[3] = {g * sn[ii][0], g * sn[ii][1], g * sn[ii][2]};
      double v[3] = {0.0, 0.0, 0.0};
      horseshoe_rev(sc[ii], a, b, w, vb, v, row, ga, gb);
      if (sym) {
        // horseshoe m B -> m A; its ends' cotangents back through m
        double gam[3] = {0.0, 0.0, 0.0}, gbm[3] = {0.0, 0.0, 0.0};
        horseshoe_rev(sc[ii], bm, am, w, vb, v, row, gbm, gam);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const double m = c == 1 ? -1.0 : 1.0;
          ga[c] += m * gam[c];
          gb[c] += m * gbm[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) row[3 + c] = g * v[c];
    }
    const double sum = warp_sum8(row, lane);
    const int slot = lane >> 2;
    if ((lane & 3) == 0 && slot < 6) {
      const size_t i = size_t(i0 + ii);
      atomicAdd((slot < 3 ? dcol : dn) + 3 * i + slot % 3, sum);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    scol[threadIdx.y][lane][c] = ga[c];
    scol[threadIdx.y][lane][3 + c] = gb[c];
  }
  __syncthreads();
  // 32 columns x 6 components, the block's warps summed in order
  const int tid = threadIdx.y * 32 + lane;
  for (int t = tid; t < 32 * 6; t += 32 * WARPS) {
    const int col = t / 6, q = t % 6;
    const int jc = blockIdx.x * 32 + col;
    if (jc < N) {
      double s = 0.0;
      for (int k = 0; k < WARPS; ++k) s += scol[k][col][q];
      atomicAdd((q < 3 ? dA : dB) + 3 * size_t(jc) + q % 3, s);
    }
  }
}

}  // namespace
}  // namespace gf

// mode 0: aic (N, N); mode 1: dcol, dn, dA, dB (N, 3), zeroed by the caller.
extern "C" int gf_vlm_aic(int mode, const double* colloc, const double* nhat,
                          const double* A, const double* B,
                          const double* wake, const double* gbar,
                          double* aic, double* dcol, double* dn, double* dA,
                          double* dB, int N, int symmetric,
                          cudaStream_t stream) {
  using namespace gf;
  if (N <= 0) return 0;
  // the strip: S rows a warp, fewer where N is small, so that the grid
  // keeps at least ~16 row strips for every column tile
  const int s16 = N / (WARPS * 16);
  const int S = s16 < 1 ? 1 : s16 > SMAX ? SMAX : s16;
  const dim3 block(32, WARPS);
  const dim3 grid((N + 31) / 32, (N + WARPS * S - 1) / (WARPS * S));
  if (mode == 0) {
    aic_value_kernel<<<grid, block, 0, stream>>>(colloc, nhat, A, B, wake, N,
                                                 symmetric, S, aic);
  } else if (mode == 1) {
    aic_vjp_kernel<<<grid, block, 0, stream>>>(colloc, nhat, A, B, wake, gbar,
                                               N, symmetric, S, dcol, dn, dA,
                                               dB);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
