// K13 chol_subst: the forward and back substitution of the persistent
// Cholesky factor, x = dsc * (L L^T)^-1 (dsc * B), reading the factor where
// cuSOLVER left it.
//
// Replaces the JAX device programs of goldfish_tpu/solver/tpu_cholesky.py:
//   :205 _chol_substitute        one right-hand side (every Newton
//                                direction, refinement sweep and adjoint);
//   :235 _chol_substitute_multi  M right-hand sides (the Woodbury basis
//                                W = K_ref^-1 U^T, once a factorization);
// and, as their `invs`, the inverses of the diagonal panels that
// tpu_cholesky.py:177-200 keeps beside L. The JAX package polishes those
// inverses by Newton-Schulz on the TPU; here `diag_inv_kernel` computes them
// once a factorization, in f64, by substitution.
//
// The factor is the one `torch.linalg.cholesky_ex` returns: column-major
// (strides (1, N)), lower triangle, read in place (never copied) and only
// below the diagonal. It is cut into NB = 64-row blocks; the last block is
// padded with the identity. Both sweeps are blocked as the JAX package's:
//   forward  y_I = D_I (dsc_I b_I - sum_{J<I} L_IJ y_J),    D_I = L_II^-1,
//   back     z_I = D_I^T (y_I - sum_{J>I} L_JI^T z_J),       x_I = dsc_I z_I.
//
// What bounds it on the H100. One right-hand side reads the lower triangle
// twice, N (N + 1) 8 bytes (0.104 ms at N = 6600 at 3.35 TB/s), and its
// critical path is the chain of diagonal blocks: block I can finish only
// after block I - 1 published. A launch per block would pay two launch
// latencies a block, so `subst_vec_kernel` is one launch for both sweeps,
// sync-free: 2 nblk thread blocks take row blocks in order from an atomic
// ticket (forward blocks 0..nblk-1, then back blocks nblk-1..0), so a block
// waits only on blocks that hold an earlier ticket and are therefore
// resident: no deadlock, whatever the occupancy. A block streams its
// off-diagonal tiles (64 x 64, coalesced along the factor's columns) as the
// x-blocks they need are published, loading each tile before it waits for
// the values it multiplies; it then applies its diagonal block's inverse (a
// matrix-vector product, not a chain of 64 dependent steps) and publishes
// its x-block. A value is published by itself (see SENT below): the hand-off
// from one block to the next costs one store and the polling loads that see
// it, with no flag, fence or second read. The back sweep's blocks start as
// soon as they get a ticket, prefetch their tiles, and need the forward y
// only of their own rows; its first tiles are the rows the forward sweep
// read last, still in L2. On an H100 80GB HBM3 at 700 W a solve at N = 6600
// takes 0.39 ms, 3.7x the two sweeps' byte bound: the hand-off (~1.8 us a
// block step along the chain), not the bandwidth, holds it.
//
// M right-hand sides (`subst_multi_kernel`) do 2 N^2 M f64 operations
// (1.54 ms at N = 6072, M = 1404 on the f64 tensor cores at 67 TFLOP/s):
// compute-bound. A work item is (row block, 128 columns): one pass over
// each 64 x 64 L tile serves two 64-column tiles of B. The tile products
// run on the f64 tensor cores (mma.sync m8n8k4, as K10's stage 1), 8 warps
// of 32 x 32 outputs, with the L tile (cp.async, 8 bytes) and the
// right-hand-side tile (cp.async.cg, 16 bytes: the scratch rows are padded
// to whole 128-column tiles, so no cache line holds two items' data and no
// L1 line can be stale) double-buffered in 208 KB of shared memory. Items
// take tickets row block by row block, so the waits are as above.
//
// Deterministic: no floating-point atomics; every sum is taken in a fixed
// order (a tile's products summed apart, then added to the running sum in
// tile order, which also keeps the summation chain at ~nblk + 64 terms
// rather than N / 4), so the result is the same bits from launch to launch.
#include "chol_blocks.cuh"

namespace gf {
namespace {

constexpr size_t SMEM_MULTI = 2 * size_t(ASZ + BSZ) * sizeof(double);
static_assert(SMEM_MULTI <= 232448, "multi-RHS stages exceed 227 KB");

// ------------------------------------------------------------ diag_inv
// One block a diagonal block k: thread c computes column c of L_kk^-1 by
// forward substitution, z_i = (delta_ic - sum_{j<i} L_ij z_j) / L_ii, with
// the column in registers (fully unrolled; z_j = 0 for j < c, so the sum
// adds exact zeros below the column's first entry) and L_kk in shared
// memory, read by all threads at one address at a time (broadcast). Output:
// invs[k][c][i] = (L_kk^-1)[i][c] (the inverse column-major, 4096 doubles a
// block).
__global__ void __launch_bounds__(NB, 1)
    diag_inv_kernel(const double* __restrict__ L, double* __restrict__ invs,
                    int N) {
  __shared__ double Ls[NB][NB + 1];   // Ls[i][j] = L_kk[i][j]
  const int k = blockIdx.x, c = threadIdx.x, r0 = k * NB;
  for (int j = 0; j < NB; ++j) {   // column j of the block, coalesced in c
    const int row = r0 + c, col = r0 + j;
    // the lower triangle only: the entries above the diagonal are not read
    Ls[c][j] = (row < N && col < N) ? (j <= c ? L[size_t(col) * N + row]
                                              : 0.0)
                                    : (c == j ? 1.0 : 0.0);
  }
  __syncthreads();
  double z[NB];
#pragma unroll
  for (int i = 0; i < NB; ++i) {
    double s = (i == c) ? 1.0 : 0.0;
#pragma unroll
    for (int j = 0; j < i; ++j) s = fma(-Ls[i][j], z[j], s);
    z[i] = s / Ls[i][i];
  }
  double* out = invs + size_t(k) * NB * NB + size_t(c) * NB;
#pragma unroll
  for (int i = 0; i < NB; ++i) out[i] = z[i];
}

// ------------------------------------------------------------ one column
// A value of y or z is published by itself: the wrapper fills y and z with
// SENT, a signalling NaN that no arithmetic produces (operations return
// quiet NaNs), the owning thread stores the value with a relaxed store, and
// a reader polls the value with relaxed loads until it is not SENT. An
// aligned 8-byte access is single-copy atomic, so a value read is whole and
// final; no flag, fence or second read stands on the critical path. The
// ticket is the word after z.
constexpr unsigned long long SENT = 0x7FF4DEAD00000000ull;

// y and z unset, the ticket (the word after them) 0.
__global__ void fill_unset(unsigned long long* yz, int n, int words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < words) yz[i] = i < n ? SENT : 0ull;
}

__device__ __forceinline__ double ld_relaxed(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.global.f64 %0, [%1];"
               : "=d"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(double* p, double v) {
  asm volatile("st.relaxed.gpu.global.f64 [%0], %1;" ::"l"(p), "d"(v)
               : "memory");
}

__device__ __forceinline__ bool unset(double v) {
  return static_cast<unsigned long long>(__double_as_longlong(v)) == SENT;
}

// v[k] = p[k], k < n, once all n are published (the loads issued together,
// repeated until none is SENT; past 2^24 rounds a fault, as in `spin`).
template <int n>
__device__ __forceinline__ void read_published(const double* p,
                                               double (&v)[n]) {
  for (long it = 0;; ++it) {
    bool ok = true;
#pragma unroll
    for (int k = 0; k < n; ++k) v[k] = ld_relaxed(p + k);
#pragma unroll
    for (int k = 0; k < n; ++k) ok = ok && !unset(v[k]);
    if (ok) return;
    if (it > (1l << 24)) __trap();
  }
}

// Thread (i = tid % 64, c = tid / 64). Forward block I: the thread sums row
// I0 + i against columns c*16 .. c*16 + 15 of every tile J < I; back block
// I: the thread holds row J0 + i of tile (J, I) against columns c*16 ..
// c*16 + 15 of block I (16 sums, reduced over the 64 rows at the end).
__global__ void __launch_bounds__(THREADS)
    subst_vec_kernel(const double* __restrict__ L,
                     const double* __restrict__ invs,
                     const double* __restrict__ dsc,
                     const double* __restrict__ b, double* y, double* z,
                     double* __restrict__ out, int* ticket, int N,
                     int nblk) {
  __shared__ double part[4][NB];
  __shared__ double rhs[NB];
  const int t = take_ticket(ticket);
  const int tid = threadIdx.x, i = tid & (NB - 1), c = tid >> 6;
  const int lane = tid & 31;
  if (t < nblk) {   // ---------------- forward block I
    const int I = t, R = I * NB + i;
    const bool row_ok = R < N;
    const double sb = (tid < NB && row_ok) ? dsc[R] * b[R] : 0.0;
    const double* D = invs + size_t(I) * NB * NB;
    double dinv[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) dinv[k] = D[(c * 16 + k) * NB + i];
    double acc = 0.0;
    double cur[16], nxt[16];
    auto load = [&](double(&v)[16], int J) {
      const double* col = L + size_t(J * NB + c * 16) * N + R;
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = row_ok ? __ldg(col + size_t(k) * N)
                                                 : 0.0;
    };
    if (I > 0) load(cur, 0);
    for (int J = 0; J < I; ++J) {
      if (J + 1 < I) load(nxt, J + 1);
      double yv[16];
      read_published(y + J * NB + c * 16, yv);
      double p = 0.0;
#pragma unroll
      for (int k = 0; k < 16; ++k) p = fma(cur[k], yv[k], p);
      acc += p;
      if (J + 1 < I) {
#pragma unroll
        for (int k = 0; k < 16; ++k) cur[k] = nxt[k];
      }
    }
    part[c][i] = acc;
    __syncthreads();
    if (tid < NB)
      rhs[i] = row_ok ? sb - (((part[0][i] + part[1][i]) + part[2][i]) +
                              part[3][i])
                      : 0.0;
    __syncthreads();
    double q = 0.0;
#pragma unroll
    for (int k = 0; k < 16; ++k) q = fma(dinv[k], rhs[c * 16 + k], q);
    part[c][i] = q;
    __syncthreads();
    if (tid < NB && row_ok)
      st_relaxed(y + R,
                 ((part[0][i] + part[1][i]) + part[2][i]) + part[3][i]);
    return;
  }
  // ---------------- back block I
  const int I = 2 * nblk - 1 - t, I0 = I * NB, R = I0 + i;
  const bool row_ok = R < N;
  // y of this block's rows, published before any z this block waits for
  double yI[1] = {0.0};
  if (tid < NB && row_ok) read_published(y + R, yI);
  const double* D = invs + size_t(I) * NB * NB;
  double dinvT[16];   // D_I^T[i][c*16 + k] = D_I[c*16 + k][i]
#pragma unroll
  for (int k = 0; k < 16; ++k) dinvT[k] = D[i * NB + c * 16 + k];
  double acc[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0;
  double cur[16], nxt[16];
  auto load = [&](double(&v)[16], int J) {
    const int row = J * NB + i;
    const double* p = L + size_t(I0 + c * 16) * N + row;
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = row < N ? __ldg(p + size_t(k) * N)
                                                : 0.0;
  };
  if (I + 1 < nblk) load(cur, nblk - 1);
  for (int J = nblk - 1; J > I; --J) {
    if (J - 1 > I) load(nxt, J - 1);
    const int row = J * NB + i;
    double zj[1] = {0.0};
    if (row < N) read_published(z + row, zj);
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[k] = fma(cur[k], zj[0], acc[k]);
    if (J - 1 > I) {
#pragma unroll
      for (int k = 0; k < 16; ++k) cur[k] = nxt[k];
    }
  }
  // reduce-scatter of the 16 sums over the warp's 32 rows: after the steps
  // of 16, 8, 4 and 2 lanes, lane l holds the sum of column
  // 8 b4 + 4 b3 + 2 b2 + b1 (b = the bits of l), added in a fixed tree
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const bool hi = lane & 16;
    const double send = hi ? acc[k] : acc[k + 8];
    const double keep = hi ? acc[k + 8] : acc[k];
    acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bool hi = lane & 8;
    const double send = hi ? acc[k] : acc[k + 4];
    const double keep = hi ? acc[k + 4] : acc[k];
    acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const bool hi = lane & 4;
    const double send = hi ? acc[k] : acc[k + 2];
    const double keep = hi ? acc[k + 2] : acc[k];
    acc[k] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  {
    const bool hi = lane & 2;
    const double send = hi ? acc[0] : acc[1];
    const double keep = hi ? acc[1] : acc[0];
    acc[0] = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  }
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 1);
  const int col = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                  ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  if ((lane & 1) == 0) part[(tid >> 5) & 1][c * 16 + col] = acc[0];
  __syncthreads();
  if (tid < NB) rhs[i] = row_ok ? yI[0] - (part[0][i] + part[1][i]) : 0.0;
  __syncthreads();
  double q = 0.0;
#pragma unroll
  for (int k = 0; k < 16; ++k) q = fma(dinvT[k], rhs[c * 16 + k], q);
  part[c][i] = q;
  __syncthreads();
  if (tid < NB && row_ok) {
    const double zi = ((part[0][i] + part[1][i]) + part[2][i]) + part[3][i];
    st_relaxed(z + R, zi);
    out[R] = dsc[R] * zi;
  }
}

// ------------------------------------------------------------ M columns
// Stage the L tile feeding block I from block J (forward: L[I0+m][J0+k],
// k-major; back: L[J0+k][I0+m], m-major), rows past N as zeros.
template <bool BACK>
__device__ __forceinline__ void stage_L(double* As, const double* L, int N,
                                        int I, int J) {
  const int I0 = I * NB, J0 = J * NB;
  for (int e = threadIdx.x; e < NB * NB; e += THREADS) {
    const int hi = e >> 6, lo = e & (NB - 1);   // lo runs along memory
    if (!BACK) {   // column J0 + hi of L, rows I0 + lo
      double* dst = As + hi * APF + lo;
      if (I0 + lo < N)
        cp_async8(dst, L + size_t(J0 + hi) * N + I0 + lo);
      else
        *dst = 0.0;
    } else {       // column I0 + hi of L, rows J0 + lo: A(m = hi, k = lo)
      double* dst = As + hi * APB + lo;
      if (J0 + lo < N && I0 + hi < N)
        cp_async8(dst, L + size_t(I0 + hi) * N + J0 + lo);
      else
        *dst = 0.0;
    }
  }
}

// Stage rows J0.. of a right-hand-side scratch (pitch MP, whole tiles),
// columns c0.., rows past N as zeros.
__device__ __forceinline__ void stage_B(double* Bs, const double* S, int N,
                                        int MP, int J, int c0) {
  const int J0 = J * NB;
  for (int e = threadIdx.x; e < NB * CT / 2; e += THREADS) {
    const int k = e / (CT / 2), n = (e - k * (CT / 2)) * 2;
    double* dst = Bs + k * BP + n;
    if (J0 + k < N) {
      cp_async16(dst, S + size_t(J0 + k) * MP + c0 + n);
    } else {
      dst[0] = 0.0;
      dst[1] = 0.0;
    }
  }
}

// Stage D_I (forward, k-major: A(m, k) = D[m][k]) or D_I^T (back, m-major:
// A(m, k) = D[k][m]); invs holds D column-major.
template <bool BACK>
__device__ __forceinline__ void stage_D(double* As, const double* invs,
                                        int I) {
  const double* D = invs + size_t(I) * NB * NB;
  for (int e = threadIdx.x; e < NB * NB; e += THREADS) {
    const int hi = e >> 6, lo = e & (NB - 1);
    // BACK: A(m = hi, k = lo) = D[lo][hi] = D[hi * NB + lo] (column hi);
    // forward: A(m = lo, k = hi) = D[lo][hi], the same address
    cp_async8(BACK ? As + hi * APB + lo : As + hi * APF + lo,
              D + hi * NB + lo);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    subst_multi_kernel(const double* __restrict__ L,
                       const double* __restrict__ invs,
                       const double* __restrict__ dsc,
                       const double* __restrict__ B, double* Y, double* Z,
                       double* __restrict__ out, int* flags, int* ticket,
                       int N, int M, int MP, int nblk, int nct) {
  extern __shared__ double smem[];
  // stage s: A at smem + s ASZ, B at smem + 2 ASZ + s BSZ
  auto As = [&](int s) { return smem + s * ASZ; };
  auto Bs = [&](int s) { return smem + 2 * ASZ + s * BSZ; };
  const int t = take_ticket(ticket);
  const int items = nblk * nct;
  const bool back = t >= items;
  const int u = back ? t - items : t;
  const int I = back ? nblk - 1 - u / nct : u / nct, ct = u % nct;
  const int c0 = ct * CT, I0 = I * NB;
  int* fwd = flags;
  int* bwd = flags + items;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tt = lane & 3;
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * 32;
  double acc[4][4][2], part[4][4][2];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = 0.0;
  const int ntiles = back ? nblk - 1 - I : I;
  const double* S = back ? Z : Y;
  int* sflags = back ? bwd : fwd;
  // tile it: J = it (forward) or nblk - 1 - it (back)
  auto wait_all = [&](int f) {
    if (threadIdx.x == 0) spin(sflags + f);
    __syncthreads();
  };
  auto stage = [&](int it, int s) {
    const int J = back ? nblk - 1 - it : it;
    if (back)
      stage_L<true>(As(s), L, N, I, J);
    else
      stage_L<false>(As(s), L, N, I, J);
    wait_all(J * nct + ct);
    stage_B(Bs(s), S, N, MP, J, c0);
    cp_commit();
  };
  if (ntiles > 0) stage(0, 0);
  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) {
      stage(it + 1, (it + 1) & 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) part[mt][nt][0] = part[mt][nt][1] = 0.0;
    if (back)
      tile_mma<true>(As(it & 1), Bs(it & 1), part, wm, wn);
    else
      tile_mma<false>(As(it & 1), Bs(it & 1), part, wm, wn);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        acc[mt][nt][0] += part[mt][nt][0];
        acc[mt][nt][1] += part[mt][nt][1];
      }
    __syncthreads();
  }
  // the right-hand side of the diagonal step into B stage 0 (rows past N
  // and columns past M zero), D_I (or D_I^T) into A stage 0
  if (back)
    stage_D<true>(As(0), invs, I);
  else
    stage_D<false>(As(0), invs, I);
  cp_commit();
  if (back) {   // y of this item's rows
    if (threadIdx.x == 0) spin(fwd + I * nct + ct);
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 8 + g, n = wn + nt * 8 + 2 * tt + h;
        const int row = I0 + m, colg = c0 + n;
        double v = 0.0;
        if (row < N && colg < M)
          v = back ? __ldcg(Y + size_t(row) * MP + colg) - acc[mt][nt][h]
                   : dsc[row] * B[size_t(row) * M + colg] - acc[mt][nt][h];
        Bs(0)[m * BP + n] = v;
        acc[mt][nt][h] = 0.0;
      }
  cp_wait<0>();
  __syncthreads();
  if (back)
    tile_mma<true>(As(0), Bs(0), acc, wm, wn);
  else
    tile_mma<false>(As(0), Bs(0), acc, wm, wn);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = wm + mt * 8 + g, n = wn + nt * 8 + 2 * tt + h;
        const int row = I0 + m, colg = c0 + n;
        if (row < N && colg < M) {
          const double v = acc[mt][nt][h];
          if (back) {
            Z[size_t(row) * MP + colg] = v;
            out[size_t(row) * M + colg] = dsc[row] * v;
          } else {
            Y[size_t(row) * MP + colg] = v;
          }
        }
      }
  publish((back ? bwd : fwd) + I * nct + ct);
}

}  // namespace
}  // namespace gf

extern "C" int gf_chol_diag_inv(const double* L, double* invs, int N,
                                int nblk, void* stream) {
  using namespace gf;
  if (nblk == 0) return 0;
  if (N < 1 || nblk != (N + NB - 1) / NB)
    return static_cast<int>(cudaErrorInvalidValue);
  diag_inv_kernel<<<nblk, NB, 0, static_cast<cudaStream_t>(stream)>>>(
      L, invs, N);
  return static_cast<int>(cudaGetLastError());
}

// yz: 2 N + 1 words of scratch: y, z, then the ticket. Filled here with
// SENT (the ticket with 0) before the substitution, on the same stream.
extern "C" int gf_chol_subst(const double* L, const double* invs,
                             const double* dsc, const double* b, double* yz,
                             double* out, int N, int nblk, void* stream) {
  using namespace gf;
  if (N < 1 || nblk != (N + NB - 1) / NB)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int words = 2 * N + 1;
  fill_unset<<<(words + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      reinterpret_cast<unsigned long long*>(yz), 2 * N, words);
  subst_vec_kernel<<<2 * nblk, THREADS, 0, s>>>(
      L, invs, dsc, b, yz, yz + N, out, reinterpret_cast<int*>(yz + 2 * N),
      N, nblk);
  return static_cast<int>(cudaGetLastError());
}

// B, out: (N, M) row-major; Y, Z: (N, MP) scratch, MP = nct * CT; flags:
// 2 nblk nct + 1 ints of scratch (the items' flags, then the ticket),
// zeroed here.
extern "C" int gf_chol_subst_multi(const double* L, const double* invs,
                                   const double* dsc, const double* B,
                                   double* Y, double* Z, double* out,
                                   int* flags, int N, int M, int MP,
                                   int nblk, int nct, void* stream) {
  using namespace gf;
  if (N < 1 || M < 1 || nblk != (N + NB - 1) / NB ||
      nct != (M + CT - 1) / CT || MP != nct * CT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int items = 2 * nblk * nct;
  cudaError_t e = cudaMemsetAsync(flags, 0, (items + 1) * sizeof(int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(subst_multi_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(SMEM_MULTI));
  if (e != cudaSuccess) return static_cast<int>(e);
  subst_multi_kernel<<<items, THREADS, SMEM_MULTI, s>>>(
      L, invs, dsc, B, Y, Z, out, flags, flags + items, N, M, MP, nblk, nct);
  return static_cast<int>(cudaGetLastError());
}
