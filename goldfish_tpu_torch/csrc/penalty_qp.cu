// K2 penalty_qp: penalty coupling of non-matching patches at every interface
// quadrature point, with its derivatives by a hand-written reverse sweep.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/coupling.py: qp_penalty_density, penalty_energy
//     (value; gradient = system.residual's coupling part),
//     interface_hessians (the per-qp 18x18 jet Hessian),
//   goldfish_tpu/solver/implicit.py: _jit_entry/_jit_res_pot/_jit_trial and
//     _jit_residual_vjp (coupling part).
//
// The density depends on the displacement only through the 18-jet
//   z = (uA, uA_u, uA_v, uB, uB_u, uB_v),
// on the geometry through (XA_u, XA_v, XB_u, XB_v) and on the thickness
// through (hA, hB):
//   w dl [ad E h/2 |uA-uB|^2 + ar E h^3/24 (dphi^2 + dbeta^2)],
// with dphi, dbeta the normal and co-normal rotation jumps. Its derivatives
// come from `penalty_sweep` (penalty_sweep.cuh).
//
// Modes (the outputs of the dual-number kernels they replaced):
//   0 value+grad: per-qp energy (I, N) (the wrapper sums each interface's
//     qps), r = dW/dd (P,C,3) and dW/dh (P,C) by f64 atomics;
//   1 hess: (I, N, 18, 18). The u-u block is closed form, w dl alpha_d
//     [[I, -I], [-I, I]], u against the first jets is exactly zero, and the
//     12 first-jet columns are tangents (Dual<double, 1>) through the sweep;
//   2 adjoint: -d/d(cp,h) of lambda^T r_pen: the sweep extended back to the
//     geometry jets and h, with lambda's jets as the tangent of z;
//   3 design tangent: given tcp (P,C,3) and th (P,C), d/de of r_pen(cp +
//     e tcp, h + e th) (P,C,3): mode 0's sweep with both sides' X jets and
//     hA, hB as Dual<double, 1> tangents (z plain), the tangent of dF/dz
//     scattered as mode 0 scatters dF/dz (f64 atomics). It serves the fixed
//     interfaces and the moving ones' rows at xi (K5) alike (jax.jvp of the
//     residual in (cp, h) in the JAX package's operations).
//
// Layout. Modes 0, 2, 3: a block holds PCH consecutive qps; 6 PCH threads
// gather their jets into shared memory (one (qp, side, basis row) each),
// PCH threads sweep (one a qp), then all scatter B^T g (one (qp, side,
// local) each). Mode 1: a block holds HQB
// consecutive qps, 12 threads a qp (one a first-jet column; 6 of them also
// gather, and write the closed-form u rows); the block stages its HQB x 324
// outputs in shared memory and stores them coalesced.
#include "penalty_sweep.cuh"

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
  const double* lam;    // (P, C, 3): lambda (mode 2), tcp (mode 3)
  const double* th;     // (P, C), mode 3 only
  int I, N, L, C;
};

__device__ inline const double* row(const Args& a, int side, int j) {
  const double* const* R = side == 0 ? a.RA : a.RB;
  return j == 0 ? R[0] : j == 1 ? R[1] : R[2];
}

// The jets of qp t through basis row j of one side into shared memory:
// X (rows 1, 2: sX[6 side + 3 (j - 1)]), z (sZ[9 side + 3 j]), lambda's z
// (mode 2) and h (row 0: sH[side]); mode 3 puts tcp's X jets in sL[6 side +
// 3 (j - 1)] and th's value in sL[12 + side].
template <int MODE>
__device__ void gather(const Args& a, size_t t, int side, int j, double* sX,
                       double* sZ, double* sL, double* sH) {
  const int i = int(t / a.N);
  const int p = side == 0 ? a.pairA[i] : a.pairB[i];
  const double* R = row(a, side, j) + t * a.L;
  const int* conn = (side == 0 ? a.connA : a.connB) + t * a.L;
  double x[3] = {0.0, 0.0, 0.0}, z[3] = {0.0, 0.0, 0.0},
         l[3] = {0.0, 0.0, 0.0}, hh = 0.0, th = 0.0;
#pragma unroll 4
  for (int k = 0; k < a.L; ++k) {
    const double r = R[k];
    const size_t node = size_t(p) * a.C + conn[k];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (j > 0) x[c] += r * a.cp[node * 3 + c];
      z[c] += r * a.d[node * 3 + c];
      if (MODE == 2 || (MODE == 3 && j > 0)) l[c] += r * a.lam[node * 3 + c];
    }
    if (j == 0) hh += r * a.h[node];
    if (MODE == 3 && j == 0) th += r * a.th[node];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (j > 0) sX[6 * side + 3 * (j - 1) + c] = x[c];
    sZ[9 * side + 3 * j + c] = z[c];
    if (MODE == 2) sL[9 * side + 3 * j + c] = l[c];
    if (MODE == 3 && j > 0) sL[6 * side + 3 * (j - 1) + c] = l[c];
  }
  if (j == 0) sH[side] = hh;
  if (MODE == 3 && j == 0) sL[12 + side] = th;
}

constexpr int PCH = 16;        // qps a block (modes 0, 2, 3)
constexpr int PTH = 6 * PCH;   // threads a block: one gather task each
// doubles of shared memory a qp: X, z, lambda's z, hA hB, g, gh
constexpr int PSM = NX + NZ + NZ + 2 + NZ + 1;

// modes 0, 2, 3: PCH consecutive qps a block
template <int MODE>
__device__ void grad_block(const Args& a, double* Wq, double* out_f,
                           double* out_h) {
  extern __shared__ double sm[];
  double* sX = sm;                 // (PCH, 12)
  double* sZ = sX + PCH * NX;      // (PCH, 18)
  double* sL = sZ + PCH * NZ;      // (PCH, 18): lambda's z (mode 2), or
                                   // tcp's X jets and th (mode 3)
  double* sH = sL + PCH * NZ;      // (PCH, 2)
  double* sG = sH + PCH * 2;       // (PCH, 18): dF/dz, or the adjoint's
                                   // X-gradient in z's layout
  double* sGh = sG + PCH * NZ;     // (PCH,)
  const size_t nqp = size_t(a.I) * a.N;
  const size_t t0 = size_t(blockIdx.x) * PCH;
  const int nc = int(nqp - t0 < size_t(PCH) ? nqp - t0 : PCH);
  const double sign = MODE == 2 ? -1.0 : 1.0;
  for (int task = threadIdx.x; task < 6 * nc; task += blockDim.x) {
    const int qq = task / 6, side = (task % 6) / 3, j = task % 3;
    gather<MODE>(a, t0 + qq, side, j, sX + qq * NX, sZ + qq * NZ,
                 sL + qq * NZ, sH + 2 * qq);
  }
  __syncthreads();
  for (int qq = threadIdx.x; qq < nc; qq += blockDim.x) {
    const size_t t = t0 + qq;
    const int i = int(t / a.N);
    const double E = fmax(a.E[a.pairA[i]], a.E[a.pairB[i]]);
    const double* X = sX + qq * NX;
    double* G = sG + qq * NZ;
    if (MODE == 0) {
      double gh;
      penalty_sweep<double, false>(X, sZ + qq * NZ, sH[2 * qq],
                                   sH[2 * qq + 1], a.dxiA + 2 * t,
                                   a.dxiB + 2 * t, E, a.ad[i], a.ar[i],
                                   a.w[t], Wq[t], G, gh);
      sGh[qq] = gh;
    } else if (MODE == 3) {
      // the geometry (X, hA, hB) carries the design tangent, z none
      typedef Dual<double, 1> T;
      T Xt[NX], z[NZ], g[NZ], val, gh, dA[2], dB[2];
      const double* tL = sL + qq * NZ;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        Xt[k] = T(X[k]);
        Xt[k].g[0] = tL[k];
      }
#pragma unroll
      for (int k = 0; k < NZ; ++k) z[k] = T(sZ[qq * NZ + k]);
      T hA(sH[2 * qq]), hB(sH[2 * qq + 1]);
      hA.g[0] = tL[12];
      hB.g[0] = tL[13];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        dA[c] = T(a.dxiA[2 * t + c]);
        dB[c] = T(a.dxiB[2 * t + c]);
      }
      penalty_sweep<T, false, false, T>(Xt, z, hA, hB, dA, dB, E, a.ad[i],
                                        a.ar[i], a.w[t], val, g, gh);
#pragma unroll
      for (int k = 0; k < NZ; ++k) G[k] = g[k].g[0];
    } else {
      typedef Dual<double, 1> T;
      T z[NZ], g[NX], val, gh;
#pragma unroll
      for (int k = 0; k < NZ; ++k) {
        z[k] = T(sZ[qq * NZ + k]);
        z[k].g[0] = sL[qq * NZ + k];
      }
      penalty_sweep<T, true>(X, z, sH[2 * qq], sH[2 * qq + 1],
                             a.dxiA + 2 * t, a.dxiB + 2 * t, E, a.ad[i],
                             a.ar[i], a.w[t], val, g, gh);
      // the geometry enters through the d/du, d/dv rows only: zero value
      // rows of each side's 9-jet
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        G[k] = 0.0;
        G[9 + k] = 0.0;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        G[3 + k] = g[k].g[0];
        G[12 + k] = g[6 + k].g[0];
      }
      sGh[qq] = gh.g[0];
    }
  }
  __syncthreads();
  // B^T g: one (qp, side, local) a task
  for (int task = threadIdx.x; task < 2 * a.L * nc; task += blockDim.x) {
    const int qq = task / (2 * a.L), side = (task / a.L) % 2, k = task % a.L;
    const size_t t = t0 + qq;
    const int i = int(t / a.N);
    const int p = side == 0 ? a.pairA[i] : a.pairB[i];
    const int* conn = side == 0 ? a.connA : a.connB;
    const size_t node = size_t(p) * a.C + conn[t * a.L + k];
    const double* G = sG + qq * NZ + 9 * side;
    double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double r = row(a, side, j)[t * a.L + k];
      acc[0] += r * G[3 * j];
      acc[1] += r * G[3 * j + 1];
      acc[2] += r * G[3 * j + 2];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) atomicAdd(out_f + node * 3 + c, sign * acc[c]);
    if (MODE != 3)
      atomicAdd(out_h + node, sign * row(a, side, 0)[t * a.L + k] * sGh[qq]);
  }
}

// mode 0 writes each qp's energy (Wq, (I, N)); the wrapper sums them over
// each interface's qps
__global__ void penalty_value_grad(Args a, double* Wq, double* r,
                                   double* dh) {
  grad_block<0>(a, Wq, r, dh);
}

__global__ void penalty_adjoint(Args a, double* dcp, double* dh) {
  grad_block<2>(a, nullptr, dcp, dh);
}

__global__ void penalty_design_jvp(Args a, double* dr) {
  grad_block<3>(a, nullptr, dr, nullptr);
}

// ---------------------------------------------------------------- mode 1
constexpr int NM = 12;              // first-jet components
constexpr int HQB = 8;              // qps a block
constexpr int NH = NZ * NZ;         // outputs a qp
constexpr int HSM = NX + NZ + 2 + NH;

// z index of first-jet column k (uA_u, uA_v, uB_u, uB_v) and of u row k
__device__ inline int m_index(int k) { return k < 6 ? 3 + k : 6 + k; }
__device__ inline int u_index(int k) { return k < 3 ? k : 6 + k; }

// blockDim = 12 HQB: thread 12 qq + k is column k of the block's qp qq
__global__ void penalty_hess(Args a, double* H) {
  extern __shared__ double sm[];
  double* sX = sm;               // (HQB, 12)
  double* sZ = sX + HQB * NX;    // (HQB, 18)
  double* sH = sZ + HQB * NZ;    // (HQB, 2)
  double* sO = sH + HQB * 2;     // (HQB, 324): the block's output rows
  const size_t nqp = size_t(a.I) * a.N;
  const size_t q0 = size_t(blockIdx.x) * HQB;
  const int nact = int(nqp - q0 < size_t(HQB) ? nqp - q0 : HQB);
  const int qq = threadIdx.x / NM, k = threadIdx.x % NM;
  const bool active = qq < nact;
  const size_t t = q0 + qq;
  if (active && k < 6)
    gather<1>(a, t, k / 3, k % 3, sX + qq * NX, sZ + qq * NZ, nullptr,
              sH + 2 * qq);
  __syncthreads();
  if (active) {
    typedef Dual<double, 1> T;
    const int i = int(t / a.N);
    const double E = fmax(a.E[a.pairA[i]], a.E[a.pairB[i]]);
    const double* X = sX + qq * NX;
    const int mk = m_index(k);
    T z[NZ], g[NZ], val, gh;
#pragma unroll
    for (int j = 0; j < NZ; ++j) {
      z[j] = T(sZ[qq * NZ + j]);
      z[j].g[0] = j == mk ? 1.0 : 0.0;
    }
    const double* dxA = a.dxiA + 2 * t;
    const double hA = sH[2 * qq], hB = sH[2 * qq + 1];
    penalty_sweep<T, false>(X, z, hA, hB, dxA, a.dxiB + 2 * t, E, a.ad[i],
                            a.ar[i], a.w[t], val, g, gh);
    double* Hq = sO + qq * NH;
#pragma unroll
    for (int j = 0; j < NZ; ++j) Hq[mk * NZ + j] = g[j].g[0];
    if (k < 6) {
      // u row: w dl alpha_d on the diagonal, minus it against the other
      // side's u, zero elsewhere
      double dX[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) dX[c] = X[c] * dxA[0] + X[3 + c] * dxA[1];
      const double h = 0.5 * (hA + hB);
      const double kd = (a.w[t] * sqrt(dot3(dX, dX))) * ((a.ad[i] * E) * h);
      const int uk = u_index(k), uo = k < 3 ? uk + 9 : uk - 9;
#pragma unroll
      for (int j = 0; j < NZ; ++j)
        Hq[uk * NZ + j] = j == uk ? kd : j == uo ? -kd : 0.0;
    }
  }
  __syncthreads();
  double* out = H + q0 * NH;
  for (int e = threadIdx.x; e < nact * NH; e += blockDim.x) out[e] = sO[e];
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
                             const double* E, const double* lam,
                             const double* th, double* out_w,
                             double* out_f, double* out_h, int I, int N, int L,
                             int C, void* stream) {
  using namespace gf;
  Args a{{RA00, RA10, RA01}, {RB00, RB10, RB01}, connA, connB, pairA, pairB,
         w, dxiA, dxiB, ad, ar, d, cp, h, E, lam, th, I, N, L, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t nqp = size_t(I) * N;
  if (nqp == 0) return 0;
  if (mode == 0 || mode == 2 || mode == 3) {
    const unsigned blocks = unsigned((nqp + PCH - 1) / PCH);
    const size_t smem = size_t(PCH) * PSM * sizeof(double);
    if (mode == 0)
      penalty_value_grad<<<blocks, PTH, smem, s>>>(a, out_w, out_f, out_h);
    else if (mode == 2)
      penalty_adjoint<<<blocks, PTH, smem, s>>>(a, out_f, out_h);
    else
      penalty_design_jvp<<<blocks, PTH, smem, s>>>(a, out_f);
  } else if (mode == 1) {
    const size_t smem = size_t(HQB) * HSM * sizeof(double);  // 22.8 KB
    penalty_hess<<<unsigned((nqp + HQB - 1) / HQB), NM * HQB, smem, s>>>(
        a, out_f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
