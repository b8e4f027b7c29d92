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
// Modes (a 16 x 16 tile of (i, j) pairs per block, one thread per pair):
//   0 value: AIC (N, N) f64, written in place; no (N, N, 3) temporary;
//   1 VJP: given gbar = dL/dAIC (N, N), dL/dc, dL/dn (row sums over j) and
//     dL/dA, dL/dB (column sums over i), each (N, 3). The per-pair partials
//     in (c_i, A_j, B_j) come from one forward pass in Dual<double, 9> of
//     the same `aic_entry` template as the value (the mirror's chain through
//     m and its reversed ends included); dL/dn_i gets gbar_ij v_ij, the
//     induced velocity, recomputed and never stored. The tile's 16 rows and
//     16 columns are summed in shared memory, then added to the outputs by
//     f64 atomics (N / 16 adds per entry): one pass over the pairs, where a
//     second pass without atomics would evaluate every pair twice.
//
// What bounds it on the H100: at the lattices of the VLM path (60 and 1024
// panels) the value mode's ~200 f64 operations per pair and its N^2 output
// are microseconds of work, so launch latency decides; the VJP carries 10
// doubles per dual scalar, so its register use (ptxas counts in PERF.md)
// sets the occupancy.
#include "dual.cuh"

namespace gf {
namespace {

constexpr double FOUR_PI = 4.0 * 3.141592653589793;
constexpr double CORE = 1e-8;
constexpr int TILE = 16;

template <class S>
__device__ inline S norm3(const S* a) { return dsqrt(dot3(a, a)); }

// finite segment A -> B at P, unit strength
template <class S>
__device__ inline void seg_induced(const S* P, const S* A, const S* B,
                                   S* v) {
  S r1[3], r2[3], r0[3], cr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r1[k] = P[k] - A[k];
    r2[k] = P[k] - B[k];
    r0[k] = B[k] - A[k];
  }
  cross3(r1, r2, cr);
  S cr2 = dot3(cr, cr);
  S num = dot3(r0, r1) / (norm3(r1) + 1e-300) -
          dot3(r0, r2) / (norm3(r2) + 1e-300);
  S k = num / ((cr2 + CORE) * FOUR_PI);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = cr[c] * k;
}

// semi-infinite leg from A along the unit direction w at P
template <class S>
__device__ inline void semiinf_induced(const S* P, const S* A,
                                       const double* w, S* v) {
  S r[3], d[3], cr[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[k] = P[k] - A[k];
    d[k] = S(w[k]);
  }
  cross3(d, r, cr);
  S cr2 = dot3(cr, cr);
  S cosv = dot3(d, r) / (norm3(r) + 1e-300);
  S k = (cosv + 1.0) / ((cr2 + CORE) * FOUR_PI);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = cr[c] * k;
}

// unit horseshoe A -> B: bound segment, (B -> inf), (inf -> A); adds to v
template <class S>
__device__ inline void horseshoe_add(const S* P, const S* A, const S* B,
                                     const double* w, S* v) {
  S vb[3], vB[3], vA[3];
  seg_induced(P, A, B, vb);
  semiinf_induced(P, B, w, vB);
  semiinf_induced(P, A, w, vA);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = v[c] + ((vb[c] + vB[c]) - vA[c]);
}

// AIC entry (v . n) and the induced velocity v of panel (A, B) at c
template <class S>
__device__ inline S aic_entry(const S* c, const S* A, const S* B,
                              const double* n, const double* w, int sym,
                              S* v) {
#pragma unroll
  for (int k = 0; k < 3; ++k) v[k] = S(0.0);
  horseshoe_add(c, A, B, w, v);
  if (sym) {
    // the mirror image across y = 0, ends reversed: m B -> m A
    S Am[3] = {A[0], -A[1], A[2]};
    S Bm[3] = {B[0], -B[1], B[2]};
    horseshoe_add(c, Bm, Am, w, v);
  }
  return (v[0] * n[0] + v[1] * n[1]) + v[2] * n[2];
}

__global__ void aic_value_kernel(const double* colloc, const double* nhat,
                                 const double* A, const double* B,
                                 const double* wake, int N, int sym,
                                 double* aic) {
  const int j = blockIdx.x * TILE + threadIdx.x;
  const int i = blockIdx.y * TILE + threadIdx.y;
  if (i >= N || j >= N) return;
  double w[3] = {wake[0], wake[1], wake[2]};
  double c[3], a[3], b[3], n[3], v[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c[k] = colloc[3 * i + k];
    n[k] = nhat[3 * i + k];
    a[k] = A[3 * j + k];
    b[k] = B[3 * j + k];
  }
  aic[size_t(i) * N + j] = aic_entry(c, a, b, n, w, sym, v);
}

__global__ void aic_vjp_kernel(const double* colloc, const double* nhat,
                               const double* A, const double* B,
                               const double* wake, const double* gbar,
                               int N, int sym, double* dcol, double* dn,
                               double* dA, double* dB) {
  // per pair: d colloc (0-2), d A (3-5), d B (6-8), d n (9-11)
  __shared__ double sh[TILE][TILE][12];
  const int jj = threadIdx.x, ii = threadIdx.y;
  const int j = blockIdx.x * TILE + jj;
  const int i = blockIdx.y * TILE + ii;
  double loc[12];
#pragma unroll
  for (int t = 0; t < 12; ++t) loc[t] = 0.0;
  if (i < N && j < N) {
    typedef Dual<double, 9> D;
    double w[3] = {wake[0], wake[1], wake[2]};
    double n[3];
    D c[3], a[3], b[3], v[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n[k] = nhat[3 * i + k];
      c[k] = D(colloc[3 * i + k]);
      a[k] = D(A[3 * j + k]);
      b[k] = D(B[3 * j + k]);
      c[k].g[k] = 1.0;
      a[k].g[3 + k] = 1.0;
      b[k].g[6 + k] = 1.0;
    }
    D e = aic_entry(c, a, b, n, w, sym, v);
    const double g = gbar[size_t(i) * N + j];
#pragma unroll
    for (int t = 0; t < 9; ++t) loc[t] = g * e.g[t];
#pragma unroll
    for (int k = 0; k < 3; ++k) loc[9 + k] = g * v[k].v;
  }
#pragma unroll
  for (int t = 0; t < 12; ++t) sh[ii][jj][t] = loc[t];
  __syncthreads();
  // 96 row tasks (16 rows x {c, n} x 3) and 96 column tasks (16 columns x
  // {A, B} x 3), one per thread
  const int tid = ii * TILE + jj;
  if (tid < 96) {
    const int r = tid / 6, q = tid % 6;
    const int comp = q < 3 ? q : 9 + (q - 3);
    const int row = blockIdx.y * TILE + r;
    if (row < N) {
      double s = 0.0;
      for (int x = 0; x < TILE; ++x) s += sh[r][x][comp];
      atomicAdd((q < 3 ? dcol : dn) + 3 * row + (q % 3), s);
    }
  } else if (tid < 192) {
    const int r = (tid - 96) / 6, q = (tid - 96) % 6;
    const int col = blockIdx.x * TILE + r;
    if (col < N) {
      double s = 0.0;
      for (int y = 0; y < TILE; ++y) s += sh[y][r][3 + q];
      atomicAdd((q < 3 ? dA : dB) + 3 * col + (q % 3), s);
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
  if (N <= 0) return 0;
  const dim3 block(gf::TILE, gf::TILE);
  const dim3 grid((N + gf::TILE - 1) / gf::TILE,
                  (N + gf::TILE - 1) / gf::TILE);
  if (mode == 0) {
    gf::aic_value_kernel<<<grid, block, 0, stream>>>(colloc, nhat, A, B,
                                                     wake, N, symmetric, aic);
  } else {
    gf::aic_vjp_kernel<<<grid, block, 0, stream>>>(
        colloc, nhat, A, B, wake, gbar, N, symmetric, dcol, dn, dA, dB);
  }
  return gf::launch_status();
}
