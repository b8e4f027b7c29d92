// K7 c2x_res_jac: residual, Jacobian, Newton step and control-point
// adjoint of the implicit control-point -> intersection-coordinate map
// (CPIGA2Xi).
//
// Replaces the JAX device programs of goldfish_tpu/geometry/cpiga2xi.py:
//   mode 0  _c2x_res, _c2x_jac, _c2x_res_jac: r (I, 4N) and the dense
//           dr/dx (I, 4N, 4N), every entry written (no zero-fill by the
//           caller);
//   mode 1  _c2x_res_vjp: dcp = -lam^T dr/dcp (P, C, 3) for a given lam;
//   mode 2  _c2x_step: one full Newton step, fused: r(x) and dr/dx, the
//           solve dr/dx dx = -r, r(x + dx); writes x + dx and the two
//           per-intersection norms (I, 2) = |r(x)|, |r(x + dx)|;
//   mode 3  _c2x_adjoint_direct: dr/dx^T lam = g, then mode 1's pullback;
//   mode 4  the cp-forward tangent dr/dcp . tcp (I, 4N) for a given tcp
//           (P, C, 3), for the same rows as mode 0 (jax.jvp of _c2x_res in
//           cp, the JAX package's operations/disp_mi_imop.py): the points'
//           tangents dP = sum R0 tcp by the same half-warps, then each
//           owner contracts its rows' derivatives in the points with them
//           (a pin's tangent is 0), every slot written once.
//
// Unknowns per intersection (padded to N points): x = xi (N, 2, 2)
// flattened, x[(k * 2 + side) * 2 + c]. Residual slots (4N), as in
// _residual_one:
//   3k..3k+2      real k: S_A(xiA_k) - S_B(xiB_k), or, when both sides run
//                 along parametric edges, [xiA_k pinned edge coordinate,
//                 xiB_k pinned edge coordinate, (S_A - S_B) . t_k] with t_k
//                 the unit chord tangent of side A; padded k: pins of
//                 (xiA_k0, xiA_k1, xiB_k0) to their initial values;
//   3N + k - 2    (k >= 2) real k: |P_k - P_{k-1}|^2 - |P_{k-1} - P_{k-2}|^2
//                 (P = S_A(xiA), equal spacing); padded k: pin of xiB_k1;
//   4N - 2, 4N-1  end pins of side A.
//
// One block of 512 threads per intersection. The half-warps evaluate the
// 2N surface points S and dS/dxi (bspline_rows.cuh, 16 lanes a point) into
// shared memory; then the thread of point k ("owner" k) forms the rows it
// owns (its coincidence rows, the spacing row 3N + k - 2, and at k = 0 the
// end pins) with their derivatives in the points in closed form, plain
// doubles: a coincidence row is +-e_m, a spacing row has 2 s0,
// -2 (s0 + s1), 2 s1 (s1 = P_k - P_{k-1}, s0 = P_{k-1} - P_{k-2}), the edge
// projection t^ in the coincidence vector and (c - (c . t^) t^) / |t| in
// the chord's end points; dr/dx = dr/dP . dP/dxi, the pins unit entries.
//
// Modes 2 and 3 factor the augmented 4N x (4N + 1) system [J | -r] (or
// [J^T | g]) in dynamic shared memory (J alone 37 KB at N = 17, 157 KB at
// N = 35;
// up to N = FUSED_N_MAX = 39) by Gaussian elimination with partial
// pivoting, block-wide (`lu_solve`): the rows are never moved (the pivot order is kept); each
// warp eliminates column k from its live rows, its lanes over the columns,
// skipping rows whose multiplier is 0 (most of the sparse Jacobian's rows
// early on), and offers its largest |entry| of column k + 1, so that a
// step costs one block barrier. The back substitution goes in blocks of 32
// unknowns: one warp solves a block's triangle by shuffles, then the
// block's terms leave the rows above it in parallel. The adjoint pulls
// -lam^T dr/dP back to the control points without atomics: each point's
// gradient g_P is gathered over the rows of its owners in a fixed order; each control point of a side takes its sum over
// the side's points in point order (by its first occurrence) into a
// per-intersection partial; a second kernel sums the partials over
// intersections in order. dcp is the same, bit for bit, from launch to
// launch.
//
// What bounds it on the H100: latency. At the T-beam's size one block
// solves a 68 x 68 system (~2e5 f64 operations), at the tube's four blocks
// 140 x 140 (~2e6 each); the 4N elimination steps are chains of shared-
// memory loads, a division and a barrier, and the surface evaluations
// chains of global loads. Fusing the step (the parent ran a zero-fill,
// this kernel's mode 0, batched torch.linalg.solve and mode 0 again)
// removes three launches and a dense J in device memory.
#include "bspline_rows.cuh"

namespace gf {
namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int HALVES = THREADS / 16;
constexpr int ROWS_MAX = 10;  // rows a warp holds in modes 2, 3: 4N <= 160
constexpr size_t SMEM_MAX = 232448;  // a block's dynamic shared memory, sm_90
constexpr size_t SMEM_DEFAULT = 48 * 1024;  // without the opt-in
// The longest seam modes 2 and 3 hold (geometry/cpiga2xi.FUSED_N_MAX
// states the same number); longer seams take the composed route.
constexpr int FUSED_N_MAX = 39;

struct Args {
  SurfSetArgs ss;
  const int* pairA;      // (I,)
  const int* pairB;
  const int* n_pts;      // (I,)
  const int* end_dir;    // (I, 2)
  const double* end_val; // (I, 2)
  const double* xi0;     // (I, N, 2, 2)
  const double* both_edges;  // (I,)
  const int* epin_dir;   // (I, 2)
  const double* epin_val;    // (I, 2)
  const double* cp;      // (P, C, 3)
  const double* x;       // (I, 4N)
  const double* vec;     // (I, 4N): lam (mode 1) or g (mode 3); tcp
                         // (P, C, 3) in mode 4
  int I, N;
};

// A block's shared memory by mode (doubles, then ints)
struct Layout {
  size_t a = 0, xs = 0, pts = 0, res = 0, sol = 0, GA = 0, GB = 0, gP = 0,
         R0 = 0, tp = 0, redv = 0, nd = 0;
  size_t redi = 0, order = 0, spans = 0, ni = 0;
  __host__ __device__ constexpr Layout(int N, int mode) {
    const size_t n = 4 * size_t(N);
    const bool lu = mode == 2 || mode == 3, adj = mode == 1 || mode == 3;
    size_t o = 0;
    a = o;     o += lu ? n * (n + 1) : 0;  // [J | rhs], row-major, ld n + 1
    xs = o;    o += 4 * size_t(N);         // the coordinates evaluated at
    pts = o;   o += 18 * size_t(N);        // PA 3N, dPA 6N, PB 3N, dPB 6N
    res = o;   o += 4 * size_t(N);         // row values
    sol = o;   o += lu ? n : 0;            // dx or lam
    GA = o;    o += adj ? 12 * size_t(N) : 0;  // owner k: d/dP_{k-2..k+1}
    GB = o;    o += adj ? 3 * size_t(N) : 0;
    gP = o;    o += adj ? 6 * size_t(N) : 0;   // (2N, 3)
    R0 = o;    o += adj ? 32 * size_t(N) : 0;  // (2N, 16)
    tp = o;    o += mode == 4 ? 6 * size_t(N) : 0;  // tangents of PA, PB
    redv = o;  o += 2 * WARPS;             // pivot offers, two buffers
    nd = o;
    size_t q = 0;
    redi = q;  q += 2 * WARPS;
    order = q; q += lu ? n : 0;
    spans = q; q += adj ? 4 * size_t(N) : 0;   // (2N, 2) knot spans
    ni = q;
  }
  __host__ __device__ constexpr size_t bytes() const {
    return nd * 8 + ni * 4;
  }
};
static_assert(Layout(FUSED_N_MAX, 2).bytes() <= SMEM_MAX &&
                  Layout(FUSED_N_MAX, 3).bytes() <= SMEM_MAX,
              "modes 2 and 3 at FUSED_N_MAX must fit a block's shared memory");
static_assert(4 * FUSED_N_MAX <= WARPS * ROWS_MAX,
              "lu_solve holds at most WARPS * ROWS_MAX rows");

struct Sm {
  double *a, *xs, *PA, *dPA, *PB, *dPB, *res, *sol, *GA, *GB, *gP, *R0,
      *tPA, *tPB, *redv;
  int *redi, *order, *spans;
  __device__ Sm(double* d, const Layout& L, int N) {
    a = d + L.a;
    xs = d + L.xs;
    PA = d + L.pts;
    dPA = PA + 3 * N;
    PB = dPA + 6 * N;
    dPB = PB + 3 * N;
    res = d + L.res;
    sol = d + L.sol;
    GA = d + L.GA;
    GB = d + L.GB;
    gP = d + L.gP;
    R0 = d + L.R0;
    tPA = d + L.tp;
    tPB = tPA + 3 * N;
    redv = d + L.redv;
    int* b = reinterpret_cast<int*>(d + L.nd);
    redi = b + L.redi;
    order = b + L.order;
    spans = b + L.spans;
  }
};

__device__ __forceinline__ int col_of(int k, int side, int c) {
  return (k * 2 + side) * 2 + c;
}

// S and dS/dxi of the 2N side-points (side-point sp = side * N + k) at
// xs, by half-warps; with `keep`, also their R0 rows and knot spans for
// the adjoint's pullback; with TAN, also the points' tangents sum R0 tcp
// (tcp in a.vec)
template <bool TAN = false>
__device__ __forceinline__ void
eval_points(const Args& a, int i, const Sm& s, bool keep) {
  const int N = a.N, C = a.ss.C;
  const int hw = threadIdx.x >> 4, l = threadIdx.x & 15;
  const int pA = a.pairA[i], pB = a.pairB[i];
  for (int base = 0; base < 2 * N; base += HALVES) {
    const bool act = base + hw < 2 * N;
    const int sp = act ? base + hw : 2 * N - 1;
    const int side = sp >= N ? 1 : 0, k = sp - side * N;
    const int ip = side ? pB : pA;
    const double* xk = s.xs + col_of(k, side, 0);
    const LaneRow r = lane_row(a.ss, ip, xk[0], xk[1]);
    double v[9];
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const double c =
          r.conn >= 0 ? a.cp[(size_t(ip) * C + r.conn) * 3 + m] : 0.0;
      v[m] = r.R0 * c;
      v[3 + 2 * m] = r.Ru * c;
      v[4 + 2 * m] = r.Rv * c;
    }
#pragma unroll
    for (int t = 0; t < 9; ++t) v[t] = half_sum(v[t]);
    double tv[3] = {0.0, 0.0, 0.0};
    if constexpr (TAN) {
#pragma unroll
      for (int m = 0; m < 3; ++m)
        tv[m] = half_sum(
            r.conn >= 0 ? r.R0 * a.vec[(size_t(ip) * C + r.conn) * 3 + m]
                        : 0.0);
    }
    if (!act) continue;
    if (l == 0) {
      double* P = (side ? s.PB : s.PA) + 3 * k;
      double* dP = (side ? s.dPB : s.dPA) + 6 * k;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        P[m] = v[m];
        dP[2 * m] = v[3 + 2 * m];
        dP[2 * m + 1] = v[4 + 2 * m];
      }
      if constexpr (TAN) {
        double* tP = (side ? s.tPB : s.tPA) + 3 * k;
#pragma unroll
        for (int m = 0; m < 3; ++m) tP[m] = tv[m];
      }
    }
    if (keep) {
      s.R0[sp * 16 + l] = r.R0;
      if (l == 0) {
        s.spans[2 * sp] = r.su;
        s.spans[2 * sp + 1] = r.sv;
      }
    }
  }
}

// Rows into a Jacobian J[r * ld + c] (or, `trans`, J[c * ld + r]), their
// values into `res` and -value into `rhs` (column 4N of [J | -r]), each
// where non-null. A row's entries go to distinct columns, written once.
struct JSink {
  double* J;
  size_t ld;
  bool trans;
  double* res;
  double* rhs;
  const double *xs, *dPA, *dPB;
  int k;
  __device__ __forceinline__ void put(int r, int c, double v) const {
    if (trans)
      J[size_t(c) * ld + r] = v;
    else
      J[size_t(r) * ld + c] = v;
  }
  __device__ __forceinline__ void value(int slot, double v) const {
    if (res) res[slot] = v;
    if (rhs) rhs[size_t(slot) * ld] = -v;
  }
  __device__ __forceinline__ void pin(int slot, int col, double target) const {
    value(slot, xs[col] - target);
    if (J) put(slot, col, 1.0);
  }
  // S_A(xiA_k)_m - S_B(xiB_k)_m
  __device__ __forceinline__ void coin_row(int slot, double v, int m) const {
    value(slot, v);
    if (!J) return;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      put(slot, col_of(k, 0, c), dPA[(k * 3 + m) * 2 + c]);
      put(slot, col_of(k, 1, c), -dPB[(k * 3 + m) * 2 + c]);
    }
  }
  // a row with derivatives gA in P_{k-2+w} of side A (w in wmask) and gB
  // in P_k of side B (where `bside`)
  __device__ __forceinline__ void row(int slot, double v,
                                      const double (&gA)[4][3],
                                      const double (&gB)[3], int wmask,
                                      bool bside) const {
    value(slot, v);
    if (!J) return;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (!((wmask >> w) & 1)) continue;
      const int j = k - 2 + w;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        double sum = 0.0;
#pragma unroll
        for (int m = 0; m < 3; ++m) sum += gA[w][m] * dPA[(j * 3 + m) * 2 + c];
        put(slot, col_of(j, 0, c), sum);
      }
    }
    if (!bside) return;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      double sum = 0.0;
#pragma unroll
      for (int m = 0; m < 3; ++m) sum += gB[m] * dPB[(k * 3 + m) * 2 + c];
      put(slot, col_of(k, 1, c), sum);
    }
  }
};

// lam-weighted sums of the owner's row derivatives in the points: GA[w]
// in P_{k-2+w} of side A, GB in P_k of side B (pins carry none)
struct AdjSink {
  const double* lam;
  double GA[4][3], GB[3];
  __device__ __forceinline__ void pin(int, int, double) {}
  __device__ __forceinline__ void coin_row(int slot, double, int m) {
    const double l = lam[slot];
    GA[2][m] += l;
    GB[m] -= l;
  }
  __device__ __forceinline__ void row(int slot, double,
                                      const double (&gA)[4][3],
                                      const double (&gB)[3], int wmask,
                                      bool bside) {
    const double l = lam[slot];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (!((wmask >> w) & 1)) continue;
#pragma unroll
      for (int m = 0; m < 3; ++m) GA[w][m] += l * gA[w][m];
    }
    if (!bside) return;
#pragma unroll
    for (int m = 0; m < 3; ++m) GB[m] += l * gB[m];
  }
};

// the tangents of the owner's rows along the points' tangents tPA, tPB
// (mode 4): each slot written once, a pin's 0
struct TanSink {
  double* out;
  const double *tPA, *tPB;
  int k;
  __device__ __forceinline__ void pin(int slot, int, double) {
    out[slot] = 0.0;
  }
  __device__ __forceinline__ void coin_row(int slot, double, int m) {
    out[slot] = tPA[3 * k + m] - tPB[3 * k + m];
  }
  __device__ __forceinline__ void row(int slot, double,
                                      const double (&gA)[4][3],
                                      const double (&gB)[3], int wmask,
                                      bool bside) {
    double t = 0.0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if (!((wmask >> w) & 1)) continue;
      const int j = k - 2 + w;
#pragma unroll
      for (int m = 0; m < 3; ++m) t += gA[w][m] * tPA[3 * j + m];
    }
    if (bside) {
#pragma unroll
      for (int m = 0; m < 3; ++m) t += gB[m] * tPB[3 * k + m];
    }
    out[slot] = t;
  }
};

// the rows of owner k, in slot order within each block of rows
template <class Sink>
__device__ __forceinline__ void owner_rows(const Args& a, int i, int k,
                                           const Sm& s, Sink& sink) {
  const int N = a.N, n = a.n_pts[i], last = n - 1;
  const double* x0 = a.xi0 + size_t(i) * 4 * N;
  const double* PA = s.PA;
  double gA[4][3], gB[3];
  if (k < n) {
    double coin[3];
#pragma unroll
    for (int m = 0; m < 3; ++m) coin[m] = PA[3 * k + m] - s.PB[3 * k + m];
    if (a.both_edges[i] > 0.5) {
      const int e0 = a.epin_dir[2 * i], e1 = a.epin_dir[2 * i + 1];
      sink.pin(3 * k, col_of(k, 0, e0), a.epin_val[2 * i]);
      sink.pin(3 * k + 1, col_of(k, 1, e1), a.epin_val[2 * i + 1]);
      // the chord tangent P_ta - P_tb of side A
      const bool k0 = k == 0, kl = !k0 && k >= last;
      const int ta = k0 ? 1 : (kl ? k : k + 1), tb = k0 ? 0 : k - 1;
      double tan[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) tan[m] = PA[3 * ta + m] - PA[3 * tb + m];
      const double nrm =
          sqrt(tan[0] * tan[0] + tan[1] * tan[1] + tan[2] * tan[2]) + 1e-300;
      double th[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) th[m] = tan[m] / nrm;
      const double proj = coin[0] * th[0] + coin[1] * th[1] + coin[2] * th[2];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const double gt = (coin[m] - proj * th[m]) / nrm;
        gA[0][m] = 0.0;
        gA[1][m] = k0 ? 0.0 : -gt;
        gA[2][m] = th[m] + (k0 ? -gt : (kl ? gt : 0.0));
        gA[3][m] = kl ? 0.0 : gt;
        gB[m] = -th[m];
      }
      sink.row(3 * k + 2, proj, gA, gB, k0 ? 0xc : (kl ? 0x6 : 0xe), true);
    } else {
#pragma unroll
      for (int m = 0; m < 3; ++m) sink.coin_row(3 * k + m, coin[m], m);
    }
  } else {
    sink.pin(3 * k, col_of(k, 0, 0), x0[col_of(k, 0, 0)]);
    sink.pin(3 * k + 1, col_of(k, 0, 1), x0[col_of(k, 0, 1)]);
    sink.pin(3 * k + 2, col_of(k, 1, 0), x0[col_of(k, 1, 0)]);
  }
  if (k >= 2) {
    const int slot = 3 * N + k - 2;
    if (k < n) {
      double s1[3], s0[3];
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        s1[m] = PA[3 * k + m] - PA[3 * (k - 1) + m];
        s0[m] = PA[3 * (k - 1) + m] - PA[3 * (k - 2) + m];
      }
      const double val = (s1[0] * s1[0] + s1[1] * s1[1] + s1[2] * s1[2]) -
                         (s0[0] * s0[0] + s0[1] * s0[1] + s0[2] * s0[2]);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        gA[0][m] = 2.0 * s0[m];
        gA[1][m] = -2.0 * (s1[m] + s0[m]);
        gA[2][m] = 2.0 * s1[m];
        gA[3][m] = 0.0;
        gB[m] = 0.0;
      }
      sink.row(slot, val, gA, gB, 0x7, false);
    } else {
      sink.pin(slot, col_of(k, 1, 1), x0[col_of(k, 1, 1)]);
    }
  }
  if (k == 0) {
    sink.pin(4 * N - 2, col_of(0, 0, a.end_dir[2 * i]), a.end_val[2 * i]);
    sink.pin(4 * N - 1, col_of(last, 0, a.end_dir[2 * i + 1]),
             a.end_val[2 * i + 1]);
  }
}

// |r| of this intersection's row values, by warp 0 in a fixed order
__device__ __forceinline__ double
warp_norm(const double* r, int n) {
  const int lane = threadIdx.x & 31;
  double acc = 0.0;
  for (int t = lane; t < n; t += 32) acc += r[t] * r[t];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return sqrt(acc);
}

// Solve the augmented n x (n + 1) system in s.a (column n the right-hand
// side) into s.sol: elimination with partial pivoting over the whole
// block, then a blocked back substitution. Rows are never moved: step k
// takes as pivot the largest |entry| of column k among the rows not yet
// pivoted (ties to the lower row) and records it in s.order. Warp w holds
// rows w + t WARPS (t < ROWS_MAX) and a bit mask of those still live; its
// lanes read their rows' multipliers at once, then sweep the columns, each
// lane a column and every live row of the warp; lane 0, which swept column
// k + 1, offers the warp's largest |entry| there, so that the next pivot
// is known after the step's one barrier (the offers alternate between two
// buffers; every warp reduces them by shuffles). The pivots' reciprocals
// replace them on the diagonal.
__device__ __forceinline__ void
lu_solve(const Sm& s, int n) {
  const int ld = n + 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  double* A = s.a;
  {  // the first pivot: thread t offers row t
    double v = tid < n ? fabs(A[size_t(tid) * ld]) : -1.0;
    int idx = tid;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double v2 = __shfl_xor_sync(0xffffffffu, v, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
      if (v2 > v || (v2 == v && i2 < idx)) {
        v = v2;
        idx = i2;
      }
    }
    if (lane == 0) {
      s.redv[warp] = v;
      s.redi[warp] = idx;
    }
  }
  // this warp's rows warp + t WARPS, t < nt, all live
  const int nt = warp < n ? (n - warp + WARPS - 1) / WARPS : 0;
  unsigned live = (1u << nt) - 1u;  // nt <= ROWS_MAX
  __syncthreads();
  double rp = 0.0;
  for (int k = 0; k < n; ++k) {
    const int buf = (k & 1) * WARPS;
    double v = lane < WARPS ? s.redv[buf + lane] : -2.0;
    int p = lane < WARPS ? s.redi[buf + lane] : n;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const double v2 = __shfl_xor_sync(0xffffffffu, v, o);
      const int i2 = __shfl_xor_sync(0xffffffffu, p, o);
      if (v2 > v || (v2 == v && i2 < p)) {
        v = v2;
        p = i2;
      }
    }
    if (tid == 0) {
      if (k > 0) A[size_t(s.order[k - 1]) * ld + k - 1] = rp;
      s.order[k] = p;
    }
    if (p % WARPS == warp) live &= ~(1u << (p / WARPS));
    const double* Ap = A + size_t(p) * ld;
    rp = 1.0 / Ap[k];
    double lt = 0.0;
    if (lane < nt && ((live >> lane) & 1u))
      lt = A[size_t(warp + lane * WARPS) * ld + k] * rp;
    double l[ROWS_MAX];
    bool any = false;
#pragma unroll
    for (int t = 0; t < ROWS_MAX; ++t) {
      l[t] = __shfl_sync(0xffffffffu, lt, t);
      any = any || l[t] != 0.0;
    }
    if (any) {
      for (int j = k + 1 + lane; j <= n; j += 32) {
        const double a = Ap[j];
#pragma unroll
        for (int t = 0; t < ROWS_MAX; ++t)
          if (l[t] != 0.0) A[size_t(warp + t * WARPS) * ld + j] -= l[t] * a;
      }
    }
    if (lane == 0) {
      double best = -1.0;
      int bi = n;
      if (k + 1 < n) {
#pragma unroll
        for (int t = 0; t < ROWS_MAX; ++t)
          if ((live >> t) & 1u) {
            const double c = fabs(A[size_t(warp + t * WARPS) * ld + k + 1]);
            if (c > best) {
              best = c;
              bi = warp + t * WARPS;
            }
          }
      }
      s.redv[WARPS - buf + warp] = best;
      s.redi[WARPS - buf + warp] = bi;
    }
    __syncthreads();
  }
  if (tid == 0) A[size_t(s.order[n - 1]) * ld + n - 1] = rp;
  __syncthreads();
  // back substitution in blocks of 32 unknowns, the last first: warp 0
  // solves a block's triangle with lane t on its unknown lo + t, then every
  // thread takes a row above the block and subtracts the block's terms
  for (int hi = n - 1; hi >= 0; hi -= 32) {
    const int lo = hi >= 31 ? hi - 31 : 0;
    if (warp == 0) {
      const int t = lo + lane;
      const double* At = A + size_t(s.order[t <= hi ? t : hi]) * ld;
      double b = At[n];
      for (int k = hi; k >= lo; --k) {
        const double xk = __shfl_sync(0xffffffffu, b * At[k], k - lo);
        if (t < k) b -= At[k] * xk;
        if (t == k) s.sol[k] = xk;
      }
    }
    __syncthreads();
    for (int i = tid; i < lo; i += THREADS) {
      double* Ai = A + size_t(s.order[i]) * ld;
      double acc = 0.0;
      for (int k = lo; k <= hi; ++k) acc += Ai[k] * s.sol[k];
      Ai[n] -= acc;
    }
    __syncthreads();
  }
}

// modes 1 and 3 after the owners' AdjSink sums are in s.GA, s.GB: the
// points' gradients, then -sum R0 g_P into this intersection's partial
// (2, C, 3) (zeroed in phase 0), each control point by its first
// occurrence along its side, in point order
__device__ __forceinline__ void
pullback(const Args& a, int i, const Sm& s, double* part) {
  const int N = a.N, C = a.ss.C, p = a.ss.p, q = a.ss.q, q1 = q + 1;
  const int L = (p + 1) * q1;
  for (int t = threadIdx.x; t < 6 * N; t += THREADS) {
    const int sp = t / 3, m = t - 3 * (t / 3);
    double g = 0.0;
    if (sp < N) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int k = sp + 2 - w;
        if (k >= 0 && k < N) g += s.GA[(k * 4 + w) * 3 + m];
      }
    } else {
      g = s.GB[(sp - N) * 3 + m];
    }
    s.gP[t] = g;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 32 * N; e += THREADS) {
    const int sp = e >> 4, l = e & 15;
    if (l >= L) continue;
    const int side = sp >= N ? 1 : 0, k = sp - side * N;
    const int cu = s.spans[2 * sp] - p + l / q1;
    const int cv = s.spans[2 * sp + 1] - q + l % q1;
    bool first = true;
    for (int k2 = 0; k2 < k && first; ++k2) {
      const int su = s.spans[2 * (side * N + k2)];
      const int sv = s.spans[2 * (side * N + k2) + 1];
      first = !(cu >= su - p && cu <= su && cv >= sv - q && cv <= sv);
    }
    if (!first) continue;
    double acc0 = 0.0, acc1 = 0.0, acc2 = 0.0;
    for (int k2 = k; k2 < N; ++k2) {
      const int sp2 = side * N + k2;
      const int su = s.spans[2 * sp2], sv = s.spans[2 * sp2 + 1];
      if (cu < su - p || cu > su || cv < sv - q || cv > sv) continue;
      const double r0 = s.R0[sp2 * 16 + (cu - su + p) * q1 + (cv - sv + q)];
      acc0 -= r0 * s.gP[sp2 * 3];
      acc1 -= r0 * s.gP[sp2 * 3 + 1];
      acc2 -= r0 * s.gP[sp2 * 3 + 2];
    }
    const int ip = side ? a.pairB[i] : a.pairA[i];
    double* out =
        part + (size_t(side) * C + size_t(cu) * a.ss.n_v[ip] + cv) * 3;
    out[0] = acc0;
    out[1] = acc1;
    out[2] = acc2;
  }
}

// (THREADS, 1): with the minimum of one block an SM stated, ptxas keeps
// every mode in registers (<= 118); without it, it capped modes 0 and 2 at
// 80 and spilled 12 and 36 bytes
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
c2x_kernel(Args a, double* res_g, double* J_g, double* xnew_g,
           double* norms_g, double* part_g) {
  extern __shared__ double smem[];
  const int i = blockIdx.x, N = a.N, n = 4 * N, tid = threadIdx.x;
  const Layout lay(N, MODE);
  const Sm s(smem, lay, N);
  const size_t ld = size_t(n) + 1;
  const double* x = a.x + size_t(i) * n;
  // phase 0: stage x; zero what is filled sparsely
  for (int t = tid; t < n; t += THREADS) s.xs[t] = x[t];
  if (MODE == 2 || MODE == 3) {
    for (size_t t = tid; t < size_t(n) * ld; t += THREADS) s.a[t] = 0.0;
  }
  if (MODE == 0 && J_g) {
    double* J = J_g + size_t(i) * n * n;
    for (size_t t = tid; t < size_t(n) * n; t += THREADS) J[t] = 0.0;
  }
  double* part = part_g ? part_g + size_t(i) * 6 * a.ss.C : nullptr;
  if (MODE == 1 || MODE == 3)
    for (int t = tid; t < 6 * a.ss.C; t += THREADS) part[t] = 0.0;
  __syncthreads();
  eval_points<MODE == 4>(a, i, s, MODE == 1 || MODE == 3);
  __syncthreads();

  if (MODE == 4) {
    for (int k = tid; k < N; k += THREADS) {
      TanSink sink{res_g + size_t(i) * n, s.tPA, s.tPB, k};
      owner_rows(a, i, k, s, sink);
    }
    return;
  }
  if (MODE == 1) {
    for (int k = tid; k < N; k += THREADS) {
      AdjSink sink{a.vec + size_t(i) * n, {}, {}};
      owner_rows(a, i, k, s, sink);
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int m = 0; m < 3; ++m) s.GA[(k * 4 + w) * 3 + m] = sink.GA[w][m];
#pragma unroll
      for (int m = 0; m < 3; ++m) s.GB[k * 3 + m] = sink.GB[m];
    }
    __syncthreads();
    pullback(a, i, s, part);
    return;
  }
  if (MODE == 0) {
    for (int k = tid; k < N; k += THREADS) {
      JSink sink{J_g ? J_g + size_t(i) * n * n : nullptr, size_t(n), false,
                 res_g + size_t(i) * n, nullptr, s.xs, s.dPA, s.dPB, k};
      owner_rows(a, i, k, s, sink);
    }
    return;
  }
  // modes 2, 3: [J | -r] or [J^T | g] in shared memory, then the solve
  if (MODE == 3)
    for (int t = tid; t < n; t += THREADS)
      s.a[size_t(t) * ld + n] = a.vec[size_t(i) * n + t];
  for (int k = tid; k < N; k += THREADS) {
    JSink sink{s.a, ld, MODE == 3, MODE == 2 ? s.res : nullptr,
               MODE == 2 ? s.a + n : nullptr, s.xs, s.dPA, s.dPB, k};
    owner_rows(a, i, k, s, sink);
  }
  __syncthreads();
  lu_solve(s, n);
  if (MODE == 3) {
    for (int k = tid; k < N; k += THREADS) {
      AdjSink sink{s.sol, {}, {}};
      owner_rows(a, i, k, s, sink);
#pragma unroll
      for (int w = 0; w < 4; ++w)
#pragma unroll
        for (int m = 0; m < 3; ++m) s.GA[(k * 4 + w) * 3 + m] = sink.GA[w][m];
#pragma unroll
      for (int m = 0; m < 3; ++m) s.GB[k * 3 + m] = sink.GB[m];
    }
    __syncthreads();
    pullback(a, i, s, part);
    return;
  }
  // mode 2: |r(x)|, x + dx, then r(x + dx) and its norm
  if (tid < 32) {
    const double r0 = warp_norm(s.res, n);
    if (tid == 0) norms_g[2 * i] = r0;
  }
  for (int t = tid; t < n; t += THREADS) {
    s.xs[t] += s.sol[t];
    xnew_g[size_t(i) * n + t] = s.xs[t];
  }
  __syncthreads();
  eval_points(a, i, s, false);
  __syncthreads();
  for (int k = tid; k < N; k += THREADS) {
    JSink sink{nullptr, ld, false, s.res, nullptr, s.xs, s.dPA, s.dPB, k};
    owner_rows(a, i, k, s, sink);
  }
  __syncthreads();
  if (tid < 32) {
    const double r1 = warp_norm(s.res, n);
    if (tid == 0) norms_g[2 * i + 1] = r1;
  }
}

// dcp (P, C, 3): each entry the sum of its intersections' partials, in
// intersection and side order (every entry written)
__global__ void c2x_reduce_dcp(const int* pairA, const int* pairB,
                               const double* part, int I, int P, int C,
                               double* dcp) {
  const size_t t = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t C3 = size_t(C) * 3;
  if (t >= size_t(P) * C3) return;
  const int ip = int(t / C3);
  const size_t cm = t - size_t(ip) * C3;
  double s = 0.0;
  for (int i = 0; i < I; ++i) {
    if (pairA[i] == ip) s += part[(size_t(i) * 2 + 0) * C3 + cm];
    if (pairB[i] == ip) s += part[(size_t(i) * 2 + 1) * C3 + cm];
  }
  dcp[t] = s;
}

template <int MODE>
int launch_mode(const Args& a, size_t smem, cudaStream_t st, double* res,
                double* J, double* xnew, double* norms, double* part) {
  // the opt-in above 48 KB holds for the current device only: set it on
  // every launch that needs it (a host-side call, no device work)
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        c2x_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        int(SMEM_MAX));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  c2x_kernel<MODE><<<a.I, THREADS, smem, st>>>(a, res, J, xnew, norms, part);
  return launch_status();
}

}  // namespace
}  // namespace gf

extern "C" int gf_c2x_res_jac(
    int mode, const double* knots_u, const double* knots_v,
    const double* su_vals, const int* su_ids, const double* sv_vals,
    const int* sv_ids, const double* w, const int* n_v, const int* pairA,
    const int* pairB, const int* n_pts, const int* end_dir,
    const double* end_val, const double* xi0, const double* both_edges,
    const int* epin_dir, const double* epin_val, const double* cp,
    const double* x, const double* vec, double* res, double* J,
    double* xnew, double* norms, double* part, double* dcp, int Ku, int Kv,
    int Su, int Sv, int C, int p, int q, int P, int I, int N, void* stream) {
  using namespace gf;
  if (p < 1 || q < 1 || p > PMAX || q > PMAX || N < 3 || mode < 0 ||
      mode > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(N, mode).bytes();
  if (smem > SMEM_MAX || ((mode == 2 || mode == 3) && N > FUSED_N_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  if (I == 0) return 0;
  Args a{{knots_u, knots_v, su_vals, su_ids, sv_vals, sv_ids, w, n_v, Ku, Kv,
          Su, Sv, C, p, q},
         pairA, pairB, n_pts, end_dir, end_val, xi0, both_edges, epin_dir,
         epin_val, cp, x, vec, I, N};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
  switch (mode) {
    case 0: rc = launch_mode<0>(a, smem, st, res, J, xnew, norms, part); break;
    case 1: rc = launch_mode<1>(a, smem, st, res, J, xnew, norms, part); break;
    case 2: rc = launch_mode<2>(a, smem, st, res, J, xnew, norms, part); break;
    case 3: rc = launch_mode<3>(a, smem, st, res, J, xnew, norms, part); break;
    default: rc = launch_mode<4>(a, smem, st, res, J, xnew, norms, part);
  }
  if (rc != 0 || mode == 0 || mode == 2 || mode == 4) return rc;
  const size_t total = size_t(P) * C * 3;
  c2x_reduce_dcp<<<unsigned((total + 255) / 256), 256, 0, st>>>(
      pairA, pairB, part, I, P, C, dcp);
  return launch_status();
}
