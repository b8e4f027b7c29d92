// K7 c2x_res_jac: residual and Jacobian of the implicit control-point ->
// intersection-coordinate map (CPIGA2Xi), and its control-point adjoint.
//
// Replaces the JAX device programs
//   goldfish_tpu/geometry/cpiga2xi.py: _residual_one, _c2x_res, _c2x_jac,
//     _c2x_res_jac (mode 0) and _c2x_res_vjp (mode 1).
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
// One block per intersection, one thread per point. Phase 1: thread k
// evaluates S_A, S_B and dS/dxi at its own point from K5's basis code
// (bspline.cuh, Dual<double,2>) into shared memory. Phase 2: thread k
// evaluates the residual rows it owns as functions of the 15 point
// coordinates they can touch (P_{k-2..k+1} of side A and P_k of side B)
// with Dual<double,15>, so dRow/dP is exact whatever the row's formula.
//   mode 0: res (I, 4N) and, when J is given, the dense J (I, 4N, 4N)
//           (zero-filled by the caller; its nonzeros are banded) by the
//           chain rule dRow/dxi = dRow/dP . dP/dxi, plus the pins' unit
//           entries;
//   mode 1: given lambda (I, 4N), g_P = sum_rows lambda dRow/dP by shared
//           f64 atomics, then -R0^T g_P into dcp (P, C, 3) by global f64
//           atomics: -lambda^T dR/dcp (R depends on cp only through P).
//
// What bounds it on the H100: latency. At the T-beam's size one block of
// 17 threads writes a 68 x 68 Jacobian (37 KB); the work is ~10^4 flops a
// thread. The batched f64 solves of the Newton step and the adjoint run in
// torch.linalg.solve beside it.
#include "bspline.cuh"

namespace gf {
namespace {

constexpr int NP = 15;  // P_{k-2}, P_{k-1}, P_k, P_{k+1} of side A; P_k of B
typedef Dual<double, NP> D;
typedef Dual<double, 2> D2;

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
  const double* lam;     // (I, 4N), mode 1
  int I, N;
};

// S(xi) and dS/dxi (3 x 2) of one side at point k
__device__ void surface_point(const Args& a, int ip, const double* xk,
                              double* P, double* dP) {
  D2 u(xk[0]), v(xk[1]), R[LMAX];
  u.g[0] = 1.0;
  v.g[1] = 1.0;
  int conn[LMAX];
  rational_rows(a.ss, ip, u, v, conn, R);
  const int L = (a.ss.p + 1) * (a.ss.q + 1);
  for (int c = 0; c < 3; ++c) {
    double s = 0.0, su = 0.0, sv = 0.0;
    for (int l = 0; l < L; ++l) {
      const double cpc = a.cp[(size_t(ip) * a.ss.C + conn[l]) * 3 + c];
      s += R[l].v * cpc;
      su += R[l].g[0] * cpc;
      sv += R[l].g[1] * cpc;
    }
    P[c] = s;
    dP[2 * c] = su;
    dP[2 * c + 1] = sv;
  }
}

struct Shared {
  double* PA;   // (N, 3)
  double* dPA;  // (N, 3, 2)
  double* PB;
  double* dPB;
  double* gPA;  // (N, 3), mode 1
  double* gPB;
};

struct Out {
  int mode;
  double* res;  // (4N,) of this intersection
  double* J;    // (4N, 4N) or null
  const double* lam;
  Shared sh;
  int k, N;
};

// a residual row that depends on the points: value, Jacobian / adjoint
__device__ void emit(const Out& o, int slot, const D& r) {
  if (o.mode == 0) {
    o.res[slot] = r.v;
    if (!o.J) return;
    double* Jr = o.J + size_t(slot) * 4 * o.N;
    for (int w = 0; w < 4; ++w) {
      const int j = o.k - 2 + w;
      if (j < 0 || j >= o.N) continue;
      for (int c = 0; c < 2; ++c) {
        double s = 0.0;
        for (int m = 0; m < 3; ++m)
          s += r.g[3 * w + m] * o.sh.dPA[(j * 3 + m) * 2 + c];
        if (s != 0.0) Jr[(j * 2 + 0) * 2 + c] += s;
      }
    }
    for (int c = 0; c < 2; ++c) {
      double s = 0.0;
      for (int m = 0; m < 3; ++m)
        s += r.g[12 + m] * o.sh.dPB[(o.k * 3 + m) * 2 + c];
      if (s != 0.0) Jr[(o.k * 2 + 1) * 2 + c] += s;
    }
    return;
  }
  const double lw = o.lam[slot];
  if (lw == 0.0) return;
  for (int w = 0; w < 4; ++w) {
    const int j = o.k - 2 + w;
    if (j < 0 || j >= o.N) continue;
    for (int m = 0; m < 3; ++m)
      if (r.g[3 * w + m] != 0.0)
        atomicAdd(o.sh.gPA + j * 3 + m, lw * r.g[3 * w + m]);
  }
  for (int m = 0; m < 3; ++m)
    if (r.g[12 + m] != 0.0)
      atomicAdd(o.sh.gPB + o.k * 3 + m, lw * r.g[12 + m]);
}

// a row that depends on one coordinate of x directly: value x[col] - target
__device__ void emit_pin(const Out& o, int slot, const double* x, int col,
                         double target) {
  if (o.mode != 0) return;
  o.res[slot] = x[col] - target;
  if (o.J) o.J[size_t(slot) * 4 * o.N + col] = 1.0;
}

__global__ void c2x_kernel(Args a, int mode, double* res, double* J,
                           double* dcp) {
  extern __shared__ double sm[];
  const int i = blockIdx.x;
  const int N = a.N;
  const int k = threadIdx.x;
  Shared sh{sm, sm + 3 * N, sm + 9 * N, sm + 12 * N, sm + 18 * N,
            sm + 21 * N};
  const double* x = a.x + size_t(i) * 4 * N;
  const int pA = a.pairA[i], pB = a.pairB[i];
  if (k < N) {
    surface_point(a, pA, x + (k * 2 + 0) * 2, sh.PA + 3 * k, sh.dPA + 6 * k);
    surface_point(a, pB, x + (k * 2 + 1) * 2, sh.PB + 3 * k, sh.dPB + 6 * k);
    for (int m = 0; m < 3; ++m) sh.gPA[3 * k + m] = sh.gPB[3 * k + m] = 0.0;
  }
  __syncthreads();

  if (k < N) {
    Out o{mode,
          res ? res + size_t(i) * 4 * N : nullptr,
          J ? J + size_t(i) * 16 * N * N : nullptr,
          a.lam ? a.lam + size_t(i) * 4 * N : nullptr,
          sh, k, N};
    const int n = a.n_pts[i];
    const int last = n - 1;
    const double* x0 = a.xi0 + size_t(i) * 4 * N;
    D A[4][3], B[3];
    for (int w = 0; w < 4; ++w) {
      const int j = k - 2 + w;
      for (int m = 0; m < 3; ++m) {
        A[w][m] = D(j >= 0 && j < N ? sh.PA[3 * j + m] : 0.0);
        A[w][m].g[3 * w + m] = 1.0;
      }
    }
    for (int m = 0; m < 3; ++m) {
      B[m] = D(sh.PB[3 * k + m]);
      B[m].g[12 + m] = 1.0;
    }

    // block 1: coincidence (or its edge-to-edge variant) / padded pins
    if (k < n) {
      D coin[3];
      for (int m = 0; m < 3; ++m) coin[m] = A[2][m] - B[m];
      if (a.both_edges[i] > 0.5) {
        const int e0 = a.epin_dir[2 * i], e1 = a.epin_dir[2 * i + 1];
        emit_pin(o, 3 * k, x, (k * 2 + 0) * 2 + e0, a.epin_val[2 * i]);
        emit_pin(o, 3 * k + 1, x, (k * 2 + 1) * 2 + e1,
                 a.epin_val[2 * i + 1]);
        D tan[3];
        for (int m = 0; m < 3; ++m) {
          if (k == 0)
            tan[m] = A[3][m] - A[2][m];
          else if (k >= last)
            tan[m] = A[2][m] - A[1][m];
          else
            tan[m] = A[3][m] - A[1][m];
        }
        D nrm = dsqrt(dot3(tan, tan)) + 1e-300;
        D proj = coin[0] * (tan[0] / nrm) + coin[1] * (tan[1] / nrm) +
                 coin[2] * (tan[2] / nrm);
        emit(o, 3 * k + 2, proj);
      } else {
        for (int m = 0; m < 3; ++m) emit(o, 3 * k + m, coin[m]);
      }
    } else {
      emit_pin(o, 3 * k, x, (k * 2 + 0) * 2 + 0, x0[(k * 2 + 0) * 2 + 0]);
      emit_pin(o, 3 * k + 1, x, (k * 2 + 0) * 2 + 1, x0[(k * 2 + 0) * 2 + 1]);
      emit_pin(o, 3 * k + 2, x, (k * 2 + 1) * 2 + 0, x0[(k * 2 + 1) * 2 + 0]);
    }
    // block 2: equal spacing of side A, row k - 2
    if (k >= 2) {
      const int slot = 3 * N + k - 2;
      if (k < n) {
        D s1[3], s0[3];
        for (int m = 0; m < 3; ++m) {
          s1[m] = A[2][m] - A[1][m];
          s0[m] = A[1][m] - A[0][m];
        }
        emit(o, slot, dot3(s1, s1) - dot3(s0, s0));
      } else {
        emit_pin(o, slot, x, (k * 2 + 1) * 2 + 1, x0[(k * 2 + 1) * 2 + 1]);
      }
    }
    // block 3: the end points slide along fixed parametric lines of side A
    if (k == 0) {
      emit_pin(o, 4 * N - 2, x, (0 * 2 + 0) * 2 + a.end_dir[2 * i],
               a.end_val[2 * i]);
      emit_pin(o, 4 * N - 1, x, (last * 2 + 0) * 2 + a.end_dir[2 * i + 1],
               a.end_val[2 * i + 1]);
    }
  }
  if (mode != 1) return;
  __syncthreads();
  if (k >= N) return;
  // dcp += -R0^T g_P on both sides
  for (int side = 0; side < 2; ++side) {
    const int ip = side == 0 ? pA : pB;
    const double* g = (side == 0 ? sh.gPA : sh.gPB) + 3 * k;
    if (g[0] == 0.0 && g[1] == 0.0 && g[2] == 0.0) continue;
    const double* xk = x + (k * 2 + side) * 2;
    double R[LMAX];
    int conn[LMAX];
    rational_rows(a.ss, ip, xk[0], xk[1], conn, R);
    const int L = (a.ss.p + 1) * (a.ss.q + 1);
    for (int l = 0; l < L; ++l) {
      double* out = dcp + (size_t(ip) * a.ss.C + conn[l]) * 3;
      for (int m = 0; m < 3; ++m) atomicAdd(out + m, -R[l] * g[m]);
    }
  }
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
    const double* x, const double* lam, double* res, double* J, double* dcp,
    int Ku, int Kv, int Su, int Sv, int C, int p, int q, int I, int N,
    void* stream) {
  using namespace gf;
  if (p > PMAX || q > PMAX || N > 1024 || N < 3 || mode < 0 || mode > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (I == 0) return 0;
  Args a{{knots_u, knots_v, su_vals, su_ids, sv_vals, sv_ids, w, n_v, Ku, Kv,
          Su, Sv, C, p, q},
         pairA, pairB, n_pts, end_dir, end_val, xi0, both_edges, epin_dir,
         epin_val, cp, x, lam, I, N};
  size_t smem = size_t(24) * N * sizeof(double);
  c2x_kernel<<<I, N, smem, static_cast<cudaStream_t>(stream)>>>(a, mode, res,
                                                                 J, dcp);
  return launch_status();
}
