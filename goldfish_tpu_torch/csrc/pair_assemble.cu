// K10 pair_assemble: the dense diagonal blocks of K that the Newton-Krylov
// preconditioners factor, from the per-qp jet Hessians.
//
// Replaces the JAX device programs
//   goldfish_tpu/solver/krylov.py:59 patch_block_precond (the (P, 3C, 3C)
//     patch blocks: element_hessians + interface self-quadrants, scattered);
//   goldfish_tpu/solver/krylov.py:177 PairSchwarz.assemble (the (I, 6C, 6C)
//     pair blocks [[Kp[a] + QAA + extras, QAB], [QAB^T, Kp[b] + QBB + extras]]).
// It follows the reference's own structure: each patch block is summed once
// (stage 1, `patch_assemble_kernel`), and a pair block is two copies of patch
// blocks plus its interface's cross quadrant (stage 2, `pair_assemble_kernel`).
// Kp[a] + QAA[i] + extras is patch a's block: its elements plus the
// self-quadrants of every interface that touches a.
//
// An entry is one group's contribution to one block quadrant:
//   SHELL     an element, nq = Q qps, 5 jets over its L locals (H_e, R_e);
//   PRESSURE  an element's follower-pressure Hessian, 3 jets (H_p, R_p);
//   SELF_A/B  a run of consecutive interface qps whose side-A (B) locals sit
//             on the same CPs: the side's 3 jets, its 9 x 9 quadrant of H_i;
//   CROSS_AB  a run whose A and B locals are both constant: rows on side A,
//             columns on side B (the quadrant QAB); CROSS_BA the transpose
//             side (QBA = QAB^T, summed from H_BA).
// cps[e] holds the CP of each row local and each column local (-1: none).
// For an entry, with B_q the (3 nj, 3 nl) jet rows R[q] (x) I3:
//   blk[3 cps_r[l] + x, 3 cps_c[m] + y] += sum_q sum_j R_r[q,j,l] T_q[j,x,m,y],
//   T_q[j,x,m,y] = sum_k H_q[(j,x),(k,y)] R_c[q,k,m].
// The factorization through T_q costs (9 nj nl nj + 9 nl^2 nj) a qp against
// 9 nl^2 nj^2 for the direct sum: 4x fewer operations for an element.
//
// Layout: one block of 256 threads per (patch, band of rows) in stage 1 and
// per (pair block, half, band of rows) in stage 2. The band (rows x 3C f64)
// lives in shared memory; the block walks the entries listed for its band
// (a CSR built once on the host) in a fixed order, QC qps at a time: the
// next chunk's basis rows and H quadrants are copied by cp.async into one
// staging buffer while the other is summed. With 16 locals a side (p = 3)
// both products run on the f64 tensor cores (mma.sync m8n8k4): T_q for the
// chunk's qps, then C_x = R_r^T T_x over them, 36 tiles of 8 x 8 spread over
// the warps and kept in registers until the entry ends; other shapes run
// the same sums on the FMA pipes, a thread keeping the 3 x 3 blocks of up to
// NI (row local, column local) pairs. At an entry's end the tiles are added
// into the band with plain shared-memory adds (a group's locals sit on
// distinct CPs, so no two threads meet; a barrier separates chunks). No
// global atomics and no zero-fill: each band is stored once, with the free
// mask and the identity on fixed dofs applied, by 16-byte stores; stage 2
// copies the diagonal quadrants from stage 1's output (P 3C 3C f64, resident
// in the 50 MB L2). The sums run in one order, so the blocks are the same
// bits on every launch.
//
// What bounds it on the H100: stage 2 writes the (I, 6C, 6C) blocks (110 MB
// at pegasus-91: bytes); stage 1 reads every jet Hessian once and does the
// B^T H B products (~0.4 GFLOP at pegasus-91 through T against ~40 MB of
// inputs and output, near the balance of the f64 tensor-core rate and the
// memory rate). Both are held above that by the chain of chunks of the
// heaviest band (a patch's elements and interface runs, in order), which
// the copy pipeline and the tensor cores shorten.
#include <cuda_pipeline.h>

#include <cstdint>

#include "dual.cuh"

namespace gf {
namespace {

constexpr int THREADS = 256;
constexpr int QC = 4;            // qps a chunk (krylov.QC)
constexpr int MAX_LOC = 27;      // locals a side: (l, m) pairs <= 3 x 256
constexpr int NINT = 97;         // ints of shared memory: maps (64), list (33)
constexpr size_t SMEM_MAX = 232448;

constexpr int ML = 16;        // locals a side of the tensor-core path
constexpr int RP = ML + 8;    // its staged rows' pitch and
constexpr int TP = 3 * ML + 8;  // its T rows' (doubles): a fragment's four
                                // rows then fall on disjoint banks

// pitch of a staged basis row of nl locals
__device__ __forceinline__ int rpitch(int nl) { return nl == ML ? RP : nl; }

enum Kind { SHELL = 0, PRESSURE = 1, SELF_A = 2, SELF_B = 3, CROSS_AB = 4,
            CROSS_BA = 5 };

// the jet tables of the three group types
struct Src {
  const double *H_e, *R_e;   // (G, Q, 15, 15), (G, Q, 5, L)
  const double *H_p, *R_p;   // (G, Q, 9, 9), (G, Q, 3, L) or null
  const double *H_i, *R_i;   // (I N, 1, 18, 18), (I N, 1, 6, 2 Li) or null
  int Q, L, Li;
};

// the entry list and its bands
struct Ents {
  const int *kind, *group, *nq, *cps;   // cps (S, 2, Lw)
  const int *band_ptr, *band_ent;
  int Lw;
};

// where an entry's rows and H quadrant sit in its tables
struct View {
  const double *R, *H;
  long long qbase;   // first qp, counted over all qps of the table
  int rq, hq;        // R's and H's doubles a qp
  int nlt, nzt;      // R's locals a jet, H's row length
  int jr, lr, jc, lc;
  int nj, nl;
};

__device__ __forceinline__ View view_of(const Src& s, int kind, int g) {
  View v;
  if (kind == SHELL || kind == PRESSURE) {
    const bool sh = kind == SHELL;
    v.R = sh ? s.R_e : s.R_p;
    v.H = sh ? s.H_e : s.H_p;
    v.nj = sh ? 5 : 3;
    v.nl = v.nlt = s.L;
    v.qbase = (long long)g * s.Q;
    v.jr = v.jc = v.lr = v.lc = 0;
  } else {
    const bool rowB = kind == SELF_B || kind == CROSS_BA;
    const bool colB = kind == SELF_B || kind == CROSS_AB;
    v.R = s.R_i;
    v.H = s.H_i;
    v.nj = 3;
    v.nl = s.Li;
    v.nlt = 2 * s.Li;
    v.qbase = g;
    v.jr = rowB ? 3 : 0;
    v.lr = rowB ? s.Li : 0;
    v.jc = colB ? 3 : 0;
    v.lc = colB ? s.Li : 0;
  }
  const int njt = kind == SHELL ? 5 : (kind == PRESSURE ? 3 : 6);
  v.nzt = 3 * njt;
  v.rq = njt * v.nlt;
  v.hq = v.nzt * v.nzt;
  return v;
}

// dst[0 .. n-1] <- src[0 .. n-1] by cp.async, 16 bytes a copy where both
// allow it
__device__ __forceinline__ void copy_async(double* dst, const double* src,
                                           int n) {
  if (((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) &
       15) == 0) {
    for (int i = threadIdx.x; i < n / 2; i += THREADS)
      __pipeline_memcpy_async(dst + 2 * i, src + 2 * i, 16);
    if ((n & 1) && threadIdx.x == 0)
      __pipeline_memcpy_async(dst + n - 1, src + n - 1, 8);
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS)
      __pipeline_memcpy_async(dst + i, src + i, 8);
  }
}

// A chunk of a band's walk: entry t of the band list (entry e of the
// table, its kind, qps and first group) and its first qp q0.
struct Cur {
  int t, q0, e, kind, nq, g;
};

// The chunk at (t, q0); its metadata is loaded here, one iteration before
// the walk reaches it, so the loads are in flight while a chunk is summed.
__device__ __forceinline__ Cur chunk_at(const Ents& en, int t, int q0,
                                        int t1) {
  Cur c{t, q0, 0, 0, 0, 0};
  if (t < t1) {
    c.e = en.band_ent[t];
    c.kind = en.kind[c.e];
    c.nq = en.nq[c.e];
    c.g = en.group[c.e];
  }
  return c;
}

__device__ __forceinline__ Cur next_chunk(const Ents& en, const Cur& c,
                                          int t1) {
  if (c.q0 + QC < c.nq) return Cur{c.t, c.q0 + QC, c.e, c.kind, c.nq, c.g};
  return chunk_at(en, c.t + 1, 0, t1);
}

// Issue the cp.async copies of chunk c into one staging buffer: the rows'
// basis rows, the columns' (a CROSS entry), then the H quadrants, each qp
// after the other.
__device__ __forceinline__ void issue_chunk(const Src& s, const Cur& c,
                                            double* st) {
  const int kind = c.kind;
  const View v = view_of(s, kind, c.g);
  const int nc = min(QC, c.nq - c.q0);
  const bool same = kind < CROSS_AB;
  const int nj = v.nj, nl = v.nl, nz = 3 * nj, rp = rpitch(nl);
  double* sH = st + QC * nj * rp * (same ? 1 : 2);
  const long long q = v.qbase + c.q0;
  if (kind == SHELL || kind == PRESSURE) {   // whole qps
    copy_async(sH, v.H + q * v.hq, nc * nz * nz);
    if (rp == nl) {
      copy_async(st, v.R + q * v.rq, nc * nj * nl);
      return;
    }
    const double* R = v.R + q * v.rq;   // rows of 16 locals, 16-byte copies
    for (int i = threadIdx.x; i < nc * nj * (ML / 2); i += THREADS) {
      const int row = i / (ML / 2), c2 = 2 * (i - row * (ML / 2));
      __pipeline_memcpy_async(st + row * RP + c2, R + row * ML + c2, 16);
    }
    return;
  }
  for (int i = threadIdx.x; i < nc * nj * nl; i += THREADS) {
    const int row = i / nl, l = i - row * nl, qq = row / nj, j = row - qq * nj;
    const double* src = v.R + (q + qq) * v.rq;
    __pipeline_memcpy_async(st + row * rp + l,
                            src + (v.jr + j) * v.nlt + v.lr + l, 8);
    if (!same)
      __pipeline_memcpy_async(st + QC * nj * rp + row * rp + l,
                              src + (v.jc + j) * v.nlt + v.lc + l, 8);
  }
  for (int i = threadIdx.x; i < nc * nz * nz; i += THREADS) {
    const int qq = i / (nz * nz), r = i - qq * nz * nz, a = r / nz,
              b = r - a * nz;
    __pipeline_memcpy_async(
        sH + i, v.H + (q + qq) * v.hq + (3 * v.jr + a) * v.nzt + 3 * v.jc + b,
        8);
  }
}

// d += a b on the f64 tensor cores: one m8n8k4 product of the warp. Lane
// (g = lane / 4, t = lane % 4) holds A[g][t], B[t][g] and D[g][2t], D[g][2t+1].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, "
      "{%0, %1};\n"
      : "+d"(d0), "+d"(d1)
      : "d"(a), "d"(b));
}

constexpr int NW = THREADS / 32;
constexpr int MJ = 18;   // its output jobs: (x, 8 columns of (m, y)), each
                         // two 8 x 8 tiles (l < 8, l >= 8)
constexpr int MJW = (MJ + NW - 1) / NW;   // jobs a warp

// One staged chunk of nc qps with 16 locals a side, on the tensor cores.
// First T_q[(j,x), m, y] = sum_k H_q[(j,x),(k,y)] R_c[q,k,m] for every qp
// and y: a (3NJ x NJ) (NJ x 16) product padded to 16 x 8 x 16, one warp a
// (qp, y), written to T. Then, for each x, C_x[l][(m,y)] += sum_(q,j)
// R_r[q,j,l] T_q[(j,x),m,y]: a (16 x nc NJ) (nc NJ x 48) product; a warp
// takes (x, 8 columns) jobs, both 8-row tiles of one sharing its B
// fragments, and keeps them in `cm` across the entry's chunks.
template <int NJ>
__device__ __forceinline__ void mma_chunk(bool same, int nc, const double* st,
                                          double* T, double (&cm)[MJW][4]) {
  constexpr int NZ = 3 * NJ, NR = NJ * RP, TQ = NZ * TP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tt = lane & 3;
  const double* sRr = st;
  const double* sRc = same ? st : st + QC * NR;
  const double* sH = st + QC * NR * (same ? 1 : 2);
  for (int job = warp; job < nc * 3; job += NW) {
    const int qq = job / 3, y = job - qq * 3;
    const double* Hq = sH + qq * NZ * NZ + 3 * tt + y;
    const double* Rq = sRc + qq * NR + tt * RP + g;
    double d[2][2][2] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const bool ok = ks * 4 + tt < NJ;   // k = 4 ks + tt
      double a[2], b[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h * 8 + g;
        a[h] = ok && r < NZ ? Hq[r * NZ + 12 * ks] : 0.0;
        b[h] = ok ? Rq[ks * 4 * RP + h * 8] : 0.0;
      }
#pragma unroll
      for (int rt = 0; rt < 2; ++rt)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          dmma(d[rt][mt][0], d[rt][mt][1], a[rt], b[mt]);
    }
#pragma unroll
    for (int rt = 0; rt < 2; ++rt) {
      const int r = rt * 8 + g;
      if (r < NZ) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          double* Tr = T + qq * TQ + r * TP + (mt * 8 + 2 * tt) * 3 + y;
          Tr[0] = d[rt][mt][0];
          Tr[3] = d[rt][mt][1];
        }
      }
    }
  }
  __syncthreads();
  const int K = nc * NJ;
  for (int k0 = 0; k0 < K; k0 += 4) {   // a warp's jobs share A
    const int kk = k0 + tt, qq = kk / NJ, j = kk - qq * NJ;
    const bool ok = kk < K;
    const double* Ra = sRr + qq * NR + j * RP + g;
    const double a0 = ok ? Ra[0] : 0.0, a1 = ok ? Ra[8] : 0.0;
    const double* Tk = T + qq * TQ + 3 * j * TP + g;
#pragma unroll
    for (int i = 0; i < MJW; ++i) {
      const int job = warp + i * NW;
      if (job < MJ) {
        const int x = job / 6, nt = job - x * 6;
        const double b = ok ? Tk[x * TP + nt * 8] : 0.0;
        dmma(cm[i][0], cm[i][1], a0, b);
        dmma(cm[i][2], cm[i][3], a1, b);
      }
    }
  }
}

// Add a warp's tiles into the band (rows whose local is in the band, and
// columns whose local has a CP), then clear them.
__device__ __forceinline__ void mma_add(double (&cm)[MJW][4], const int* smap,
                                        double* band, int ld, int r0,
                                        int r1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tt = lane & 3;
#pragma unroll
  for (int i = 0; i < MJW; ++i) {
    const int job = warp + i * NW;
    if (job < MJ) {
      const int x = job / 6, nt = job - x * 6;
#pragma unroll
      for (int lt = 0; lt < 2; ++lt) {
        const int cr = smap[lt * 8 + g];
        if (cr >= 0 && 3 * cr >= r0 && 3 * cr < r1) {
          double* row = band + size_t(3 * cr + x - r0) * ld;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = nt * 8 + 2 * tt + h, m = n / 3, y = n - 3 * m;
            const int cc = smap[32 + m];
            if (cc >= 0) row[3 * cc + y] += cm[i][2 * lt + h];
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) cm[i][h] = 0.0;
  }
}

// One staged chunk of nc qps with any shapes, on the f64 FMA pipes: T_q for
// all of them into T, a barrier, then each thread's (l, m) 3 x 3 blocks.
template <int NI>
__device__ __forceinline__ void run_chunk(const View& v, bool same, int nc,
                                          const double* st, double* T,
                                          const int* slist,
                                          double (&acc)[NI][3][3]) {
  const int tid = threadIdx.x;
  const int nj = v.nj, nl = v.nl, nz = 3 * nj;
  const int rp = rpitch(nl), nr = nj * rp, tq = 3 * nz * nl;   // T: a qp's
  const double* sRr = st;
  const double* sRc = same ? st : st + QC * nr;
  const double* sH = st + QC * nr * (same ? 1 : 2);
  for (int i = tid; i < nc * tq; i += THREADS) {
    // i = qq tq + ((3j + x) nl + m) 3 + y
    const int qq = i / tq, ii = i - qq * tq;
    const int y = ii % 3, rest = ii / 3, m = rest % nl, jx = rest / nl;
    const double* hrow = sH + qq * nz * nz + jx * nz + y;
    const double* Rc = sRc + qq * nr + m;
    double sum = 0.0;
    for (int k = 0; k < nj; ++k) sum += hrow[3 * k] * Rc[k * rp];
    T[i] = sum;
  }
  __syncthreads();
  const int items = slist[32] * nl;
#pragma unroll
  for (int it = 0; it < NI; ++it) {
    const int w = tid + it * THREADS;
    if (w >= items) continue;
    const int li = w / nl, m = w - li * nl, l = slist[li];
    for (int qq = 0; qq < nc; ++qq) {
      const double* Rr = sRr + qq * nr + l;
      const double* Tq = T + qq * tq + 3 * m;
      for (int j = 0; j < nj; ++j) {
        const double r = Rr[j * rp];
        const double* Tj = Tq + 9 * j * nl;
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int y = 0; y < 3; ++y)
            acc[it][x][y] += r * Tj[3 * x * nl + y];
      }
    }
  }
}

// Add the entries band_ent[band_ptr[blk] ..] into `band` (rows r0 .. r1-1 of
// the row patch's dofs, row length ld, columns the column patch's dofs),
// chunk by chunk: the next chunk's copies are in flight while this one is
// summed (two staging buffers of `half_stage` doubles). Entries with 16
// locals a side go through the tensor cores, the rest through the FMA
// pipes (NI (l, m) blocks a thread).
template <int NI>
__device__ void add_entries(const Src& s, const Ents& en, int blk,
                            double* band, int ld, int r0, int r1,
                            double* stage, int half_stage, double* T,
                            int* smap, int* slist) {
  const int tid = threadIdx.x;
  const int t0 = en.band_ptr[blk], t1 = en.band_ptr[blk + 1];
  if (t0 == t1) return;
  Cur cur = chunk_at(en, t0, 0, t1);
  issue_chunk(s, cur, stage);
  __pipeline_commit();
  Cur nxt = next_chunk(en, cur, t1);
  // warp 0 holds the next entry's CPs (lane l: its row and column CP)
  int cpr = -1, cpc = -1;
  if (tid < en.Lw) {
    cpr = en.cps[size_t(cur.e) * 2 * en.Lw + tid];
    cpc = en.cps[size_t(cur.e) * 2 * en.Lw + en.Lw + tid];
  }
  double acc[NI][3][3];
#pragma unroll
  for (int it = 0; it < NI; ++it)
#pragma unroll
    for (int x = 0; x < 3; ++x)
#pragma unroll
      for (int y = 0; y < 3; ++y) acc[it][x][y] = 0.0;
  double cm[MJW][4] = {};
  int buf = 0;
  while (cur.t < t1) {
    if (nxt.t < t1) issue_chunk(s, nxt, stage + (buf ^ 1) * half_stage);
    __pipeline_commit();
    const Cur after = next_chunk(en, nxt, t1);   // loads for the next turn
    const View v = view_of(s, cur.kind, cur.g);
    if (cur.q0 == 0 && tid < 32) {   // warp 0: the maps, the row locals in band
      const int c = tid < v.nl ? cpr : -1;
      const bool in = c >= 0 && 3 * c >= r0 && 3 * c < r1;
      const unsigned mask = __ballot_sync(0xffffffffu, in);
      if (in) slist[__popc(mask & ((1u << tid) - 1u))] = tid;
      if (tid == 0) slist[32] = __popc(mask);
      if (tid < v.nl) {
        smap[tid] = c;
        smap[32 + tid] = cpc;
      }
    }
    const bool last = nxt.t != cur.t;   // the entry's last chunk
    if (last && nxt.t < t1 && tid < en.Lw) {
      cpr = en.cps[size_t(nxt.e) * 2 * en.Lw + tid];
      cpc = en.cps[size_t(nxt.e) * 2 * en.Lw + en.Lw + tid];
    }
    __pipeline_wait_prior(1);
    __syncthreads();   // this chunk staged, the maps built
    const int nc = min(QC, cur.nq - cur.q0);
    const bool same = cur.kind < CROSS_AB;
    const double* st = stage + buf * half_stage;
    // (the tensor-core path is compiled into the NI = 1 kernels only)
    const bool tc = NI == 1 && v.nl == ML && (v.nj == 5 || v.nj == 3);
    if constexpr (NI == 1) {
      if (tc && v.nj == 5) mma_chunk<5>(same, nc, st, T, cm);
      if (tc && v.nj == 3) mma_chunk<3>(same, nc, st, T, cm);
      if (last && tc) mma_add(cm, smap, band, ld, r0, r1);
    }
    if (!tc) run_chunk<NI>(v, same, nc, st, T, slist, acc);
    if (last && !tc) {   // add this thread's blocks into the band
      const int items = slist[32] * v.nl;
#pragma unroll
      for (int it = 0; it < NI; ++it) {
        const int w = tid + it * THREADS;
        if (w < items) {
          const int li = w / v.nl, m = w - li * v.nl;
          const int cc = smap[32 + m];
          if (cc >= 0) {
            double* dst =
                band + size_t(3 * smap[slist[li]] - r0) * ld + 3 * cc;
#pragma unroll
            for (int x = 0; x < 3; ++x)
#pragma unroll
              for (int y = 0; y < 3; ++y) dst[x * ld + y] += acc[it][x][y];
          }
        }
#pragma unroll
        for (int x = 0; x < 3; ++x)
#pragma unroll
          for (int y = 0; y < 3; ++y) acc[it][x][y] = 0.0;
      }
    }
    __syncthreads();   // T, this buffer, the maps and the band are free
    cur = nxt;
    nxt = after;
    buf ^= 1;
  }
}

// Rows [0, rows) of row length ld from f(r, c), a warp a row, 16-byte
// stores where ld is even (dst is then 16-byte aligned)
template <class F>
__device__ __forceinline__ void store_rows(double* dst, int rows, int ld,
                                           F f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if ((ld & 1) == 0) {
    for (int r = warp; r < rows; r += THREADS / 32) {
      double* row = dst + size_t(r) * ld;
      for (int c = 2 * lane; c < ld; c += 64)
        *reinterpret_cast<double2*>(row + c) =
            make_double2(f(r, c), f(r, c + 1));
    }
  } else {
    for (int r = warp; r < rows; r += THREADS / 32)
      for (int c = lane; c < ld; c += 32) dst[size_t(r) * ld + c] = f(r, c);
  }
}

struct Smem {
  double *band, *stage, *tbuf;
  int *smap, *slist;
};

__device__ __forceinline__ Smem carve(int band_rows, int n, int stage_sz,
                                      int tsz) {
  extern __shared__ double sm[];
  Smem m;
  m.band = sm;
  m.stage = sm + (size_t(band_rows) * n + 1) / 2 * 2;   // 16-byte aligned
  m.tbuf = m.stage + stage_sz;
  m.smap = reinterpret_cast<int*>(m.tbuf + tsz);
  m.slist = m.smap + 64;
  return m;
}

// Stage 1: block (p, b) sums rows [b R, b R + R) of patch p's block and
// stores them masked: out[p] = free_r free_c K + diag(1 - free).
template <int NI>
__global__ void __launch_bounds__(THREADS, 2)
    patch_assemble_kernel(Src s, Ents en, const double* __restrict__ free,
                          double* __restrict__ out, int nbands, int band_rows,
                          int n, int stage_sz, int tsz) {
  const int p = blockIdx.x / nbands, b = blockIdx.x - p * nbands;
  const int r0 = b * band_rows, rows = min(n, r0 + band_rows) - r0;
  const Smem sm = carve(band_rows, n, stage_sz, tsz);
  for (int i = threadIdx.x; i < rows * n; i += THREADS) sm.band[i] = 0.0;
  add_entries<NI>(s, en, blockIdx.x, sm.band, n, r0, r0 + rows, sm.stage,
                  stage_sz / 2, sm.tbuf, sm.smap, sm.slist);
  __syncthreads();
  const double* f = free + size_t(p) * n;
  const double* band = sm.band;
  store_rows(out + (size_t(p) * n + r0) * n, rows, n, [&](int r, int c) {
    const double fr = f[r0 + r];
    const double v = (fr > 0.0 && f[c] > 0.0) ? band[r * n + c] : 0.0;
    return r0 + r == c ? v + (1.0 - fr) : v;
  });
}

// Stage 2: block (k, half, b) writes rows [b R, b R + R) of half `half` of
// pair block k: [Kp[a] | X] on top, [X' | Kp[b]] below, X the masked cross
// quadrant summed here from the block's CROSS entries of that half.
template <int NI>
__global__ void __launch_bounds__(THREADS, 2)
    pair_assemble_kernel(Src s, Ents en, const double* __restrict__ Kp,
                         const int* __restrict__ pa,
                         const int* __restrict__ pb,
                         const double* __restrict__ free,
                         double* __restrict__ out, int nbh, int band_rows,
                         int n, int stage_sz, int tsz) {
  const int k = blockIdx.x / (2 * nbh), t = blockIdx.x - k * 2 * nbh;
  const int half = t / nbh, b = t - half * nbh;
  const int r0 = b * band_rows, rows = min(n, r0 + band_rows) - r0;
  const Smem sm = carve(band_rows, n, stage_sz, tsz);
  for (int i = threadIdx.x; i < rows * n; i += THREADS) sm.band[i] = 0.0;
  add_entries<NI>(s, en, blockIdx.x, sm.band, n, r0, r0 + rows, sm.stage,
                  stage_sz / 2, sm.tbuf, sm.smap, sm.slist);
  __syncthreads();
  const int a = pa[k], bb = pb[k];
  const double* fr = free + size_t(half ? bb : a) * n;
  const double* fc = free + size_t(half ? a : bb) * n;
  const double* Kd = Kp + (size_t(half ? bb : a) * n + r0) * n;
  const double* X = sm.band;
  const int n2 = 2 * n;
  double* dst = out + (size_t(k) * n2 + size_t(half) * n + r0) * n2;
  double* dK = dst + (half ? n : 0);   // the copied quadrant's columns
  double* dX = dst + (half ? 0 : n);   // the cross quadrant's
  if ((n & 1) == 0) {   // 16-byte copies and stores
    const int h = n / 2;
#pragma unroll 4
    for (int i = threadIdx.x; i < rows * h; i += THREADS) {
      const int r = i / h, c = 2 * (i - r * h);
      *reinterpret_cast<double2*>(dK + size_t(r) * n2 + c) =
          __ldg(reinterpret_cast<const double2*>(Kd + size_t(r) * n + c));
    }
    for (int i = threadIdx.x; i < rows * h; i += THREADS) {
      const int r = i / h, c = 2 * (i - r * h);
      const bool ok = fr[r0 + r] > 0.0;
      *reinterpret_cast<double2*>(dX + size_t(r) * n2 + c) = make_double2(
          ok && fc[c] > 0.0 ? X[r * n + c] : 0.0,
          ok && fc[c + 1] > 0.0 ? X[r * n + c + 1] : 0.0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += THREADS) {
      const int r = i / n, c = i - r * n;
      dK[size_t(r) * n2 + c] = __ldg(Kd + size_t(r) * n + c);
      dX[size_t(r) * n2 + c] =
          fr[r0 + r] > 0.0 && fc[c] > 0.0 ? X[r * n + c] : 0.0;
    }
  }
}

size_t smem_bytes(int band_rows, int n, int stage_sz, int tsz) {
  return ((size_t(band_rows) * n + 1) / 2 * 2 + stage_sz + size_t(tsz)) *
             sizeof(double) +
         NINT * sizeof(int);
}

template <class K>
int opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

// (l, m) pairs a thread: 1 up to 16 locals a side, else 3
int items_per_thread(int nl) {
  if (nl > MAX_LOC) return 0;
  return nl * nl <= THREADS ? 1 : 3;
}

}  // namespace
}  // namespace gf

extern "C" int gf_patch_assemble(
    const double* H_e, const double* R_e, const double* H_p,
    const double* R_p, const double* H_i, const double* R_i, const int* kind,
    const int* group, const int* nq, const int* cps, const int* band_ptr,
    const int* band_ent, const double* free, double* out, int P, int nbands,
    int band_rows, int n, int Q, int L, int Li, int Lw, int stage_sz,
    int tsz, void* stream) {
  using namespace gf;
  if (P == 0 || nbands == 0) return 0;
  const size_t smem = smem_bytes(band_rows, n, stage_sz, tsz);
  const int ni = items_per_thread(L > Li ? L : Li);
  if (smem > SMEM_MAX || ni == 0 || Lw > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Src s{H_e, R_e, H_p, R_p, H_i, R_i, Q, L, Li};
  const Ents en{kind, group, nq, cps, band_ptr, band_ent, Lw};
  auto kern = ni == 1 ? patch_assemble_kernel<1> : patch_assemble_kernel<3>;
  if (int e = opt_in(kern, smem)) return e;
  kern<<<P * nbands, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      s, en, free, out, nbands, band_rows, n, stage_sz, tsz);
  return launch_status();
}

extern "C" int gf_pair_assemble(
    const double* Kp, const double* H_i, const double* R_i, const int* kind,
    const int* group, const int* nq, const int* cps, const int* band_ptr,
    const int* band_ent, const int* pa, const int* pb, const double* free,
    double* out, int B, int nbh, int band_rows, int n, int Li, int Lw,
    int stage_sz, int tsz, void* stream) {
  using namespace gf;
  if (B == 0 || nbh == 0) return 0;
  const size_t smem = smem_bytes(band_rows, n, stage_sz, tsz);
  const int ni = items_per_thread(Li);
  if (smem > SMEM_MAX || ni == 0 || Lw > 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Src s{nullptr, nullptr, nullptr, nullptr, H_i, R_i, 0, 0, Li};
  const Ents en{kind, group, nq, cps, band_ptr, band_ent, Lw};
  auto kern = ni == 1 ? pair_assemble_kernel<1> : pair_assemble_kernel<3>;
  if (int e = opt_in(kern, smem)) return e;
  kern<<<B * 2 * nbh, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      s, en, Kp, pa, pb, free, out, nbh, band_rows, n, stage_sz, tsz);
  return launch_status();
}
