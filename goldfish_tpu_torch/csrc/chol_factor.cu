// K14 chol_factor: the blocked f64 Cholesky factorization K = L L^T of the
// equilibrated tangent, in place, with the inverses of L's 64-row diagonal
// blocks that K13's substitution uses.
//
// Replaces the JAX device programs of goldfish_tpu/solver/tpu_cholesky.py:
//   :139 blocked_cholesky_unrolled, :171 blocked_cholesky (the facade's
//   factor, :302 _equilibrate_pad_factor, :314 DeviceCholesky), with their
//   panel factorizations and inverses (:44 _tri_inv_doubling, :65
//   _micro_chol_inv, :88 _panel_chol_and_inv, `invs` :177-200).
// It computes what they compute, K = L L^T, not panel for panel.
//
// In place. The input is the row-major (N, N) buffer; the factor reads A
// from its lower triangle (A[i][j], i >= j, at i N + j: the triangle
// `torch.linalg.cholesky_ex` reads) and writes L column-major into the
// other half (L[i][j] at j N + i), so the two regions meet only on the
// diagonal, and zeroes the strict lower half once it has read it: the view
// K.t() (strides (1, N)) is then the lower-triangular factor, laid out as
// cholesky_ex returns it and as K13 reads it. No copy of K is made.
//
// What bounds it on the H100: N^3 / 3 f64 operations (1.43 ms at N = 6600
// on the f64 tensor cores, 67 TFLOP/s). It is left-looking with 256-column
// panels: panel p's update A[c0:, c0:c0+256] -= L[c0:, :c0] L[c0:c0+256,
// :c0]^T is one product of depth c0 (`update_kernel`, mma.sync m8n8k4 on
// 64 x 128 output tiles as K13's M-column substitution), which reads
// L[c0:, :c0] once: ~1.5 GB over the factorization at N = 6600, under the
// operation bound, where right-looking rank-64 updates would move ~24 GB.
// Where a panel's output tiles would fill the SMs' last wave badly (late
// panels: few tiles, a long depth), the depth is split into parts, each
// written apart and summed into A in a fixed order by `reduce_kernel` (a
// thread an entry), so that the card stays busy and the bits stay fixed.
//
// Inside a panel (`panel_kernel`, one launch): a thread block a 64-row
// tile, holding its 64 x 256 slab of the panel in shared memory (copied
// with cp.async, every copy in flight at once). The four 64-column
// sub-blocks go in order: the tile of sub-block b's diagonal factors it
// (after the update by sub-blocks < b of the same panel), with its inverse,
// in registers, two barriers a column (`factor_block`), writes L_bb and
// L_bb^-1 (to `invs`, K13's layout) and publishes a flag; every tile below
// waits on that flag and computes its rows as (A_b - ...) L_bb^-T on the
// tensor cores. Tiles take tickets in row order, so a tile waits only on
// tiles that run: no deadlock, whatever the occupancy. The chain of N / 64
// diagonal blocks (64 column steps each; ~30 us a block on an NVIDIA H100
// 80GB HBM3 at its 700 W limit) is the serial part.
//
// Launches: per panel an update (and a reduction where it is split) and
// the panel's launch, ~3 N / 256 in all, enqueued by gf_chol_factor's C
// loop on the caller's stream: one call, no host synchronization.
//
// A pivot that is not > 0 (NaN included, as LAPACK's dpotf2) records its
// column, 1-based, into `info` (the first such column: cholesky_ex's
// info); the factorization runs on.
//
// Deterministic: no floating-point atomics; every sum is taken in a fixed
// order (a 64-deep tile's products summed apart, then added to the running
// sum in tile order; split parts summed in part order), so the result is the
// same bits from launch to launch.
#include <algorithm>

#include "chol_blocks.cuh"

namespace gf {
namespace {

constexpr int PW = 256;          // columns of a panel (the reference's nb)
constexpr int NSUB = PW / NB;    // 64-column sub-blocks of a panel
constexpr int SP = NB + 4;       // pitch of a column of the slab and of T
constexpr size_t SMEM_PANEL = (size_t(PW + NB) * SP + 4 * NB) *
                              sizeof(double);
// pitches of the update's k-major tiles: 4 mod 16 doubles, so that the
// 16 lanes of a half-warp (g = 0..3, t = 0..3) read 16 distinct banks
constexpr int UAP = NB + 4;
constexpr int UBP = CT + 4;
constexpr int UASZ = NB * UAP, UBSZ = NB * UBP;
constexpr size_t SMEM_UPDATE = 2 * size_t(UASZ + UBSZ) * sizeof(double);
static_assert(SMEM_PANEL <= 232448 - 16, "panel slab exceeds 227 KB");
static_assert(SMEM_UPDATE <= 232448, "update stages exceed 227 KB");
static_assert(PW % CT == 0 && PW % NB == 0, "panel width");
// The update's depth is split into up to SPLIT_MAX parts (`split_of`)
// where whole waves of SMS blocks would otherwise leave SMs idle; the
// reduction reads every part, so their count is capped.
constexpr int SMS = 132;   // the H100 SXM's SMs
constexpr int SPLIT_MAX = 16;

// ------------------------------------------------------------ update
// Stage k tile k0.. of the update: A(m, k) = L(r0 + m, k0 + k) at
// a[k UAP + m], B(k, n) = L(n0 + n, k0 + k) at b[k UBP + n], both column k
// of L read along its rows (column-major L, N k + row), SPAN entries a
// cp.async; rows past N (A) or past the panel's end (B) are zeros.
template <int SPAN>
__device__ __forceinline__ void stage_update(double* a, double* b,
                                             const double* A, int N, int k0,
                                             int r0, int n0, int cend) {
  auto put = [](double* dst, const double* src, bool inside) {
    if (!inside) {
      dst[0] = 0.0;
      if (SPAN == 2) dst[1] = 0.0;
    } else if (SPAN == 2) {
      cp_async16(dst, src);
    } else {
      cp_async8(dst, src);
    }
  };
  for (int e = SPAN * threadIdx.x; e < NB * NB; e += SPAN * THREADS) {
    const int k = e / NB, m = e - k * NB;
    put(a + k * UAP + m, A + size_t(k0 + k) * N + r0 + m, r0 + m < N);
  }
  for (int e = SPAN * threadIdx.x; e < NB * CT; e += SPAN * THREADS) {
    const int k = e / CT, n = e - k * CT;
    put(b + k * UBP + n, A + size_t(k0 + k) * N + n0 + n, n0 + n < cend);
  }
}

// Item (row tile rt, column tile ct, part s): the sum over the part's k
// tiles of L(r, k) L(c, k), r in c0 + 64 rt.., c in c0 + 128 ct.. (a
// 64-deep tile's products summed apart, then added in order); with one
// part it is subtracted from A's lower triangle in place, else written to
// the part's slice of W (row-major, PW columns a row).
__global__ void __launch_bounds__(THREADS, 1)
    update_kernel(double* A, double* W, int N, int c0, int nct, int nsplit,
                  int kt) {
  extern __shared__ double smem[];
  const int item = blockIdx.x;
  const int part = item % nsplit, tile = item / nsplit;
  const int rt = tile / nct, ct = tile % nct;
  const int r0 = c0 + rt * NB, n0 = c0 + ct * CT;
  const int cend = min(N, c0 + PW);
  if (r0 + NB - 1 < n0) return;   // no entry on or below the diagonal
  const int kb = part * kt / nsplit, ke = (part + 1) * kt / nsplit;
  auto As = [&](int s) { return smem + s * UASZ; };
  auto Bs = [&](int s) { return smem + 2 * UASZ + s * UBSZ; };
  // with N even, two entries a copy (16 bytes: r0, n0, the pitches and
  // the row ends N and cend are even, so a pair is aligned and whole)
  const bool pairs = (N & 1) == 0;
  auto stage = [&](int kk, int s) {
    if (pairs)
      stage_update<2>(As(s), Bs(s), A, N, kk * NB, r0, n0, cend);
    else
      stage_update<1>(As(s), Bs(s), A, N, kk * NB, r0, n0, cend);
    cp_commit();
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tt = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  double acc[4][4][2], prt[4][4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
  const int ntiles = ke - kb;
  if (ntiles > 0) stage(kb, 0);
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(kb + it + 1, (it + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) prt[mt][nt][0] = prt[mt][nt][1] = 0.0;
    tile_mma<false, UAP, UBP>(As(it & 1), Bs(it & 1), prt, wm, wn);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][0] += prt[mt][nt][0];
        acc[mt][nt][1] += prt[mt][nt][1];
      }
    __syncthreads();
  }
  const size_t wstride = size_t((N - c0 + NB - 1) / NB) * NB * PW;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + wm + mt * 8 + g, c = n0 + wn + nt * 8 + 2 * tt + h;
        if (nsplit == 1) {
          if (r < N && c < cend && c <= r)
            A[size_t(r) * N + c] -= acc[mt][nt][h];
        } else {
          W[part * wstride + size_t(r - c0) * PW + (c - c0)] =
              acc[mt][nt][h];
        }
      }
}

// The split update's parts summed into A's lower triangle in part order:
// A[r][c] -= W_0[r][c], then W_1, ..., one thread an entry (r >= c0, c in
// the panel, c <= r), so that every SM takes a share of the reads.
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(double* A, const double* __restrict__ W, int N, int c0,
                  int nparts) {
  const long e = long(blockIdx.x) * THREADS + threadIdx.x;
  const int w = min(PW, N - c0);
  const int rr = int(e / PW), c = int(e - long(rr) * PW);
  const int r = c0 + rr, col = c0 + c;
  if (r >= N || c >= w || col > r) return;
  const size_t wstride = size_t((N - c0 + NB - 1) / NB) * NB * PW;
  const size_t at = size_t(r) * N + col;
  double v = A[at];
  for (int j = 0; j < nparts; ++j) v -= W[j * wstride + size_t(rr) * PW + c];
  A[at] = v;
}

// ------------------------------------------------------------ panel
// acc += A B for the warp's 32 x 16 outputs of a 64 x 64 product (rows
// wm.., columns wn..), A(m, k) = As[k SP + m], B(k, n) = Bs[k SP + n], k in
// order.
__device__ __forceinline__ void mma64(const double* As, const double* Bs,
                                      double (&acc)[4][2][2], int wm,
                                      int wn) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tt = lane & 3;
#pragma unroll 4
  for (int k0 = 0; k0 < NB; k0 += 4) {
    double a[4], b[2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) a[mt] = As[(k0 + tt) * SP + wm + mt * 8 + g];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) b[nt] = Bs[(k0 + tt) * SP + wn + nt * 8 + g];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        dmma(acc[mt][nt][0], acc[mt][nt][1], a[mt], b[nt]);
  }
}

__device__ __forceinline__ void zero(double (&v)[4][2][2]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) v[mt][nt][0] = v[mt][nt][1] = 0.0;
}

// The diagonal block (Sb: column k at Sb + k SP, rows 0..63; updated by
// every earlier column) factored with its inverse X = L^-1, right-looking.
// Thread (i = tid % 64, q = tid / 64) holds A(i, k) and the substitution's
// S(i, k) (S = I at the start) for the 16 columns k = 16 q + m of its
// quarter; column j's owner is register j % 16 of quarter j / 16. The loop
// over a quarter's 16 columns is unrolled (registers indexed at compile
// time), the loop over the quarters is not. Step j, two barriers:
//   1. the pivot's owner takes r = rsqrt(a_jj) (a pivot that is not > 0
//      records its column into `info`) and publishes it;
//   2. the owners of column j scale it, l_ij = a_ij r (l_jj = a_jj r), and
//      publish it; row j's owners scale row j of S, x_jk = s_jk r, the
//      row of X, and publish it;
//   3. every row below j updates its entries of A right of column j
//      (a_ik -= l_ij l_kj, j < k <= i) or of S up to it (s_ik -= l_ij
//      x_jk, k <= j): which of the two is uniform over a warp (its quarter
//      against j's), so the only per-lane choice, k against i, is a select.
// Writes L (column cb + k, row R + i, k <= i, column-major into A) and X
// to `invs` (X[i][k] at k NB + i, K13's layout). cbuf holds column j of L,
// rbuf row j of X, rs the pivot's r.
__device__ __forceinline__ void factor_block(const double* Sb, double* cbuf,
                                             double* rbuf, double* rs,
                                             double* A, double* X, int* info,
                                             int N, int cb) {
  constexpr int QW = NB / 4;   // columns of a quarter
  const int i = threadIdx.x & (NB - 1), q = threadIdx.x >> 6;
  double a[QW], x[QW];
#pragma unroll
  for (int m = 0; m < QW; ++m) {
    const int k = QW * q + m;
    a[m] = k <= i ? Sb[k * SP + i] : 0.0;
    x[m] = k == i ? 1.0 : 0.0;
  }
#pragma unroll 1
  for (int jq = 0; jq < 4; ++jq) {
#pragma unroll
    for (int mm = 0; mm < QW; ++mm) {
      const int j = QW * jq + mm;
      const bool own = q == jq;   // this quarter holds column j
      if (own && i == j) {
        const double piv = a[mm];
        if (!(piv > 0.0) && cb + j < N) atomicCAS(info, 0, cb + j + 1);
        *rs = rsqrt(piv);
      }
      __syncthreads();
      const double r = *rs;
      if (own && i >= j) {
        a[mm] *= r;
        cbuf[i] = a[mm];
      }
      if (i == j) {
#pragma unroll
        for (int m = 0; m < QW; ++m) {
          x[m] *= r;
          rbuf[QW * q + m] = x[m];
        }
      }
      __syncthreads();
      if (i > j) {
        const double lij = cbuf[i];
        if (q > jq) {   // the quarter lies right of column j: A only
#pragma unroll
          for (int m = 0; m < QW; ++m) {
            const int k = QW * q + m;
            const double u = fma(-lij, cbuf[k], a[m]);
            a[m] = k <= i ? u : a[m];
          }
        } else if (q < jq) {   // left of column j: S only
#pragma unroll
          for (int m = 0; m < QW; ++m)
            x[m] = fma(-lij, rbuf[QW * q + m], x[m]);
        } else {   // column j's own quarter: S up to j, A right of it
#pragma unroll
          for (int m = 0; m < QW; ++m) {
            const int k = QW * q + m;
            if (m <= mm) {
              x[m] = fma(-lij, rbuf[k], x[m]);
            } else {
              const double u = fma(-lij, cbuf[k], a[m]);
              a[m] = k <= i ? u : a[m];
            }
          }
        }
      }
    }
  }
  const int R = cb;   // the diagonal block's rows are its columns
#pragma unroll
  for (int m = 0; m < QW; ++m) {
    const int k = QW * q + m;
    if (k <= i && R + i < N) A[size_t(cb + k) * N + R + i] = a[m];
    X[k * NB + i] = x[m];
  }
}

// One launch a panel (columns c0 .. c0 + w, w = min(PW, N - c0)): block
// ticket t takes rows R = c0 + 64 t ..; `flags` holds the panel's NSUB
// flags, then its ticket. The slab: A's lower triangle, updated (the
// entries right of the diagonal zero, the padded diagonal of the last block
// one), copied into shared memory with cp.async (all of a thread's copies
// in flight at once); the strict lower half of A is zeroed behind the read.
__global__ void __launch_bounds__(THREADS, 1)
    panel_kernel(double* A, double* invs, int* info, int* flags, int N,
                 int c0) {
  extern __shared__ double smem[];
  double* S = smem;                  // S[c SP + m]: panel column c, row m
  double* T = S + PW * SP;           // a staged B operand, T[k SP + n]
  double* cbuf = T + NB * SP;        // column j of L; at NB the pivot's r
  double* rbuf = cbuf + 2 * NB;      // row j of X
  const int t = take_ticket(flags + NSUB);
  const int R = c0 + t * NB;
  const int w = min(PW, N - c0), nsub = (w + NB - 1) / NB;
  for (int e = threadIdx.x; e < NB * PW; e += THREADS) {
    const int m = e / PW, c = e - m * PW;   // along A's rows: coalesced
    const int r = R + m, col = c0 + c;
    if (r < N && col < N && col <= r)
      cp_async8(S + c * SP + m, A + size_t(r) * N + col);
    else
      S[c * SP + m] = r == col ? 1.0 : 0.0;
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  for (int e = threadIdx.x; e < NB * PW; e += THREADS) {
    const int m = e / PW, c = e - m * PW;
    const int r = R + m, col = c0 + c;
    if (r < N && col < r) A[size_t(r) * N + col] = 0.0;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tt = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 16;
  const int bmax = min(t, nsub - 1);
  for (int b = 0; b <= bmax; ++b) {
    const bool diag = b == t;
    double* Sb = S + b * NB * SP;
    const int cb = c0 + b * NB;
    if (!diag) {   // sub-block b's diagonal tile has published L and X
      if (threadIdx.x == 0) spin(flags + b);
      __syncthreads();
    }
    if (b > 0) {   // S_b -= S[:, :64b] D^T, D = L(rows cb.., cols c0..cb)
      double acc[4][2][2], prt[4][2][2];
      zero(acc);
      for (int kc = 0; kc < b; ++kc) {
        const double* Bop = S + kc * NB * SP;   // the diagonal tile's own
        if (!diag) {
          for (int e = threadIdx.x; e < NB * NB; e += THREADS) {
            const int k = e >> 6, n = e & (NB - 1);
            T[k * SP + n] =
                cb + n < N ? __ldcg(A + size_t(c0 + kc * NB + k) * N + cb + n)
                           : 0.0;
          }
          __syncthreads();
          Bop = T;
        }
        zero(prt);
        mma64(S + kc * NB * SP, Bop, prt, wm, wn);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            acc[mt][nt][0] += prt[mt][nt][0];
            acc[mt][nt][1] += prt[mt][nt][1];
          }
        __syncthreads();
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            Sb[(wn + nt * 8 + 2 * tt + h) * SP + wm + mt * 8 + g] -=
                acc[mt][nt][h];
      __syncthreads();
    }
    if (diag) {
      factor_block(Sb, cbuf, rbuf, cbuf + NB, A,
                   invs + size_t(cb / NB) * NB * NB, info, N, cb);
      publish(flags + b);
      return;
    }
    // S_b = S_b X^T, X = L_bb^-1 (column-major in invs: X(n, k) at k NB + n)
    const double* X = invs + size_t(cb / NB) * NB * NB;
    for (int e = threadIdx.x; e < NB * NB; e += THREADS)
      T[(e >> 6) * SP + (e & (NB - 1))] = __ldcg(X + e);
    __syncthreads();
    double acc[4][2][2];
    zero(acc);
    mma64(Sb, T, acc, wm, wn);
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          Sb[(wn + nt * 8 + 2 * tt + h) * SP + wm + mt * 8 + g] =
              acc[mt][nt][h];
    __syncthreads();
    for (int e = threadIdx.x; e < NB * NB; e += THREADS) {
      const int n = e >> 6, m = e & (NB - 1);
      if (R + m < N && cb + n < N)
        A[size_t(cb + n) * N + R + m] = Sb[n * SP + m];
    }
  }
}

// Parts of panel c0's update (1: subtracted in place): the count, of 1 ..
// min(k tiles, SPLIT_MAX), that minimizes a model of the update's time on
// SMS SMs, one block an SM: the waves of blocks times the 64-deep k tiles
// a part takes, plus half a k tile for each part that the reduction reads
// and one for its launch. A constant of the code, not of the card, so the
// bits depend on N alone.
int split_of(int N, int c0) {
  if (c0 == 0) return 1;
  const int nrt = (N - c0 + NB - 1) / NB;
  const int nct = (std::min(PW, N - c0) + CT - 1) / CT;
  // output tiles that hold an entry on or below the diagonal
  const int items = nrt * nct - (nct == 2 ? 2 : 0);
  const int kt = c0 / NB;
  int best = 1;
  long best_cost = 0;
  for (int sp = 1; sp <= std::min(kt, SPLIT_MAX); ++sp) {
    const long waves = (long(items) * sp + SMS - 1) / SMS;
    // in halves of a k tile
    const long cost = 2 * waves * ((kt + sp - 1) / sp) + (sp > 1 ? sp + 2 : 0);
    if (sp == 1 || cost < best_cost) {
      best = sp;
      best_cost = cost;
    }
  }
  return best;
}

long long scratch_doubles(int N) {
  long long most = 0;
  for (int c0 = PW; c0 < N; c0 += PW) {
    const int s = split_of(N, c0);
    if (s > 1)
      most = std::max(most, (long long)s * ((N - c0 + NB - 1) / NB) * NB * PW);
  }
  return most;
}

}  // namespace
}  // namespace gf

// Doubles of W, the update's parts, that gf_chol_factor needs at N.
extern "C" int gf_chol_factor_scratch(int N) {
  return static_cast<int>(gf::scratch_doubles(N));
}

// A: (N, N) row-major, factored in place (see above); invs: (nblk, 64, 64);
// info: one int; W: wsize doubles (gf_chol_factor_scratch); flags: nflags
// ints, 5 a panel (zeroed here, as info is).
extern "C" int gf_chol_factor(double* A, double* invs, int* info, double* W,
                              long long wsize, int* flags, int nflags, int N,
                              int nblk, void* stream) {
  using namespace gf;
  const int npanels = (N + PW - 1) / PW;
  if (N < 1 || nblk != (N + NB - 1) / NB || nflags != npanels * (NSUB + 1) ||
      wsize < scratch_doubles(N))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(info, 0, sizeof(int), s);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(flags, 0, size_t(nflags) * sizeof(int), s);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(panel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_PANEL));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(update_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(SMEM_UPDATE));
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int p = 0; p < npanels; ++p) {
    const int c0 = p * PW;
    const int nrt = (N - c0 + NB - 1) / NB;
    const int split = split_of(N, c0);
    if (c0 > 0) {
      const int nct = (std::min(PW, N - c0) + CT - 1) / CT;
      update_kernel<<<nrt * nct * split, THREADS, SMEM_UPDATE, s>>>(
          A, W, N, c0, nct, split, c0 / NB);
      e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      if (split > 1) {
        const long entries = long(nrt) * NB * PW;
        reduce_kernel<<<int((entries + THREADS - 1) / THREADS), THREADS, 0,
                        s>>>(A, W, N, c0, split);
        e = cudaGetLastError();
        if (e != cudaSuccess) return static_cast<int>(e);
      }
    }
    panel_kernel<<<nrt, THREADS, SMEM_PANEL, s>>>(
        A, invs, info, flags + p * (NSUB + 1), N, c0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}
