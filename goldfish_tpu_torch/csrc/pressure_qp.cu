// K8 pressure_qp: work of a uniform follower (normal) pressure at every shell
// quadrature point, with its displacement derivatives in closed form.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/loads.py: follower_pressure_work (value; gradient =
//     the pressure part of system.residual),
//   goldfish_tpu/physics/kl_shell.py: element_hessians(pressure=), the
//     pressure part of its 18-jet qp Hessian,
//   goldfish_tpu/solver/implicit.py: _jit_residual_vjp (pressure part of the
//     adjoint design gradient).
//
// At a qp with parametric weight wq, on a patch with pressure p,
//   w = p ((x . (x_u x x_v) - X . (X_u x X_v)) / 3) wq,   x = X + u,
// depends on the displacement only through its 9-jet z = (u, u_u, u_v),
// gathered through (R00, R10, R01). w is trilinear in (a, b, e) = (x, x_u,
// x_v), so with c = p wq / 3
//   dw/dz = c (b x e, e x a, a x b),
// and d2w/dz2 has zero 3x3 diagonal blocks and off-diagonal blocks
// c [y]x, y the third of (a, b, e), of sign + in the cyclic order (a, b),
// (b, e), (e, a) and - in the other: every entry is 0 or +-c y_m.
//
// Modes:
//   0 value+grad: per-element W_p and dW_p/dd (P,C,3); the system subtracts
//     both (Pi = ... - W_ext);
//   1 hess: the per-qp 9x9 jet Hessian of the potential's pressure term,
//     -d2w/dz2, (P,E,Q,9,9), the third group of jet_assemble / jet_matvec;
//   2 adjoint: given lambda (P,C,3), -d/dcp of lambda^T r_p with r_p =
//     -dW_p/dd. W_p depends on the control points only through x = X + u
//     (the reference term has no d-derivative), so d2W_p/dd dcp = d2W_p/dd2
//     and the output is B^T (d2w/dz2 . lambda's 9-jet), not BC-masked.
//
// Design (what bounds it on the H100: memory; ~10^2 flops a qp). A block
// holds whole elements. Their basis rows (copied whole, coalesced) and
// control points of cp, d (and lambda) are staged in shared memory once,
// then its qps' jets of X, x = X + u (and lambda in mode 2), one (qp, basis
// table) a task.
//   Modes 0 and 2 take one thread a qp for dw/dz (or d2w/dz2 lambda_z),
//   then sum each element's B^T g over its qps in a fixed order in shared
//   memory: one f64 atomic per (element, local node, component), a Q-fold
//   cut of the per-qp scatter; W per element is summed in a fixed order.
//   Mode 1 computes each of the block's 81 Q (elements) outputs from the
//   shared x jets and c, the block's threads on consecutive addresses: the
//   block's part of (P,E,Q,9,9) is one contiguous range, stored coalesced;
//   a thread keeps one of the 81 entries, so its block, sign and jet
//   component are computed once.
#include "dual.cuh"

namespace gf {
namespace {

constexpr int NP = 9;      // jet components: (value, d/du, d/dv) x 3
constexpr int QPB = 64;    // qps a block at most (whole elements)
constexpr int GTH = 256;   // threads a block, modes 0 and 2
constexpr int HTH = 324;   // threads a block, mode 1: 4 qps' 81 outputs

struct Args {
  const double* R[3];  // R00, R10, R01: (P, E, Q, L)
  const int* conn;     // (P, E, L)
  const double* wq;    // (P, E, Q)
  const double* d;     // (P, C, 3)
  const double* cp;    // (P, C, 3)
  const double* pr;    // (P,) pressure per patch
  const double* lam;   // (P, C, 3), mode 2 only
  int P, Ne, Q, L, C;
};

__device__ inline double triple(const double* a) {
  double c[3];
  cross3(a + 3, a + 6, c);
  return dot3(a, c);
}

// g = dw/dz at the current jet x (9), scaled by c
__device__ inline void grad_w(const double* x, double c, double* g) {
  cross3(x + 3, x + 6, g);
  cross3(x + 6, x, g + 3);
  cross3(x, x + 3, g + 6);
#pragma unroll
  for (int i = 0; i < NP; ++i) g[i] *= c;
}

// out = (d2w/dz2) t at x: the derivative of grad_w along the jet t
__device__ inline void hess_w(const double* x, const double* t, double c,
                              double* out) {
  double a[3], b[3];
  cross3(t + 3, x + 6, a);  // d(x_u x x_v)
  cross3(x + 3, t + 6, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = c * (a[i] + b[i]);
  cross3(t + 6, x, a);      // d(x_v x x)
  cross3(x + 6, t, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[3 + i] = c * (a[i] + b[i]);
  cross3(t, x + 3, a);      // d(x x x_u)
  cross3(x, t + 3, b);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[6 + i] = c * (a[i] + b[i]);
}

// The block's elements [e0, e0 + ne) and their qps [q0, q0 + nq): first
// their basis rows (sR, (3, nq, L), one contiguous copy a table) and each
// element's L control points of cp, d (and lambda) (sN, (ne L, F, 3), one
// (element, local node, field) a task) into shared memory, then the
// reference jets X, the current jets x = X + z (and lambda's jets) of every
// qp, (nq, 9) each, one (qp, basis table) a task.
template <bool LAM>
__device__ void gather_block(const Args& a, int e0, int ne, double* sR,
                             double* sN, double* sX, double* sx, double* sL) {
  constexpr int F = LAM ? 3 : 2;
  const size_t q0 = size_t(e0) * a.Q;
  const int nr = ne * a.Q * a.L;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double* Rk = a.R[k] + q0 * a.L;
    for (int t = threadIdx.x; t < nr; t += blockDim.x) sR[k * nr + t] = Rk[t];
  }
  for (int task = threadIdx.x; task < ne * a.L * F; task += blockDim.x) {
    const int el = task / F, f = task % F;
    const int ei = e0 + el / a.L;
    const double* src = f == 0 ? a.cp : f == 1 ? a.d : a.lam;
    const size_t c =
        (size_t(ei / a.Ne) * a.C + a.conn[size_t(e0) * a.L + el]) * 3;
#pragma unroll
    for (int y = 0; y < 3; ++y) sN[(el * F + f) * 3 + y] = src[c + y];
  }
  __syncthreads();
  for (int task = threadIdx.x; task < 3 * ne * a.Q; task += blockDim.x) {
    const int qq = task / 3, k = task % 3;
    const double* Rk = sR + k * nr + qq * a.L;
    const double* nodes = sN + (qq / a.Q) * a.L * F * 3;
    double X[3] = {0.0, 0.0, 0.0}, z[3] = {0.0, 0.0, 0.0},
           l[3] = {0.0, 0.0, 0.0};
    for (int j = 0; j < a.L; ++j) {
      const double r = Rk[j];
      const double* nj = nodes + j * F * 3;
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        X[y] += r * nj[y];
        z[y] += r * nj[3 + y];
        if (LAM) l[y] += r * nj[6 + y];
      }
    }
#pragma unroll
    for (int y = 0; y < 3; ++y) {
      sX[qq * NP + 3 * k + y] = X[y];
      sx[qq * NP + 3 * k + y] = X[y] + z[y];
      if (LAM) sL[qq * NP + 3 * k + y] = l[y];
    }
  }
}

// doubles of shared memory: a block of nqb qps, ne elements of L nodes
inline size_t grad_smem(int mode, int nqb, int ne, int L) {
  return size_t(nqb) * (3 * NP + 1 + (mode == 2 ? NP : 0) + 3 * L) +
         size_t(ne) * L * 3 * (mode == 2 ? 3 : 2);
}

inline size_t hess_smem(int nqb, int ne, int L) {
  return size_t(nqb) * (2 * NP + 1 + 3 * L) + size_t(ne) * L * 3 * 2;
}

// modes 0 and 2: `epb` whole elements a block (see the file's note)
template <int MODE>
__global__ void __launch_bounds__(GTH)
pressure_grad_block(Args a, int epb, double* W, double* out_f) {
  extern __shared__ double sm[];
  const int nqb = epb * a.Q;
  double* sX = sm;                 // (nqb, 9)
  double* sx = sX + nqb * NP;      // (nqb, 9)
  double* sG = sx + nqb * NP;      // (nqb, 9)
  double* sV = sG + nqb * NP;      // (nqb,)
  double* sL = sV + nqb;           // (nqb, 9), mode 2
  double* sR = sL + (MODE == 2 ? nqb * NP : 0);   // (3, nq, L)
  double* sN = sR + 3 * nqb * a.L;                // (epb L, F, 3)
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, a.P * a.Ne - e0);
  const int nq = ne * a.Q;
  const size_t q0 = size_t(e0) * a.Q;
  gather_block<MODE == 2>(a, e0, ne, sR, sN, sX, sx, sL);
  __syncthreads();
  for (int qq = threadIdx.x; qq < nq; qq += blockDim.x) {
    const size_t qi = q0 + qq;
    const int p = int(qi / a.Q) / a.Ne;
    const double pr = a.pr[p], wq = a.wq[qi];
    const double* x = sx + qq * NP;
    if (MODE == 0) {
      sV[qq] = pr * ((triple(x) - triple(sX + qq * NP)) / 3.0) * wq;
      grad_w(x, pr / 3.0 * wq, sG + qq * NP);
    } else {
      hess_w(x, sL + qq * NP, pr / 3.0 * wq, sG + qq * NP);
    }
  }
  __syncthreads();
  for (int task = threadIdx.x; task < ne * a.L; task += blockDim.x) {
    const int e = task / a.L, l = task % a.L, ei = e0 + e;
    const size_t node =
        size_t(ei / a.Ne) * a.C + a.conn[size_t(ei) * a.L + l];
    double acc[3] = {0.0, 0.0, 0.0};
    for (int q = 0; q < a.Q; ++q) {
      const int qq = e * a.Q + q;
      const double* G = sG + qq * NP;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const double r = sR[(j * nq + qq) * a.L + l];
        acc[0] += r * G[3 * j];
        acc[1] += r * G[3 * j + 1];
        acc[2] += r * G[3 * j + 2];
      }
    }
#pragma unroll
    for (int y = 0; y < 3; ++y) atomicAdd(out_f + node * 3 + y, acc[y]);
  }
  if (MODE == 0) {
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      double s = 0.0;
      for (int q = 0; q < a.Q; ++q) s += sV[e * a.Q + q];
      W[e0 + e] = s;
    }
  }
}

// mode 1: `epb` whole elements a block; the block's 81 nq outputs are one
// contiguous range of H. Thread t owns entry t % 81 of qps t / 81, t / 81 +
// HQ, ... (HQ = HTH / 81 qps a pass), so each pass stores HTH consecutive
// doubles, and the entry's block, sign and jet component are the thread's
// constants.
__global__ void __launch_bounds__(HTH)
pressure_hess(Args a, int epb, double* H) {
  extern __shared__ double sm[];
  constexpr int HQ = HTH / (NP * NP);
  const int nqb = epb * a.Q;
  double* sX = sm;                 // (nqb, 9)
  double* sx = sX + nqb * NP;      // (nqb, 9)
  double* sc = sx + nqb * NP;      // (nqb,)
  double* sR = sc + nqb;           // (3, nq, L)
  double* sN = sR + 3 * nqb * a.L; // (epb L, 2, 3)
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, a.P * a.Ne - e0);
  const int nq = ne * a.Q;
  const size_t q0 = size_t(e0) * a.Q;
  gather_block<false>(a, e0, ne, sR, sN, sX, sx, nullptr);
  for (int qq = threadIdx.x; qq < nq; qq += blockDim.x) {
    const size_t qi = q0 + qq;
    sc[qq] = a.pr[int(qi / a.Q) / a.Ne] / 3.0 * a.wq[qi];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t >= HQ * NP * NP) return;   // after the block's last barrier
  const int rs = t % (NP * NP), r = rs / NP, s = rs % NP;
  const int rb = r / 3, sb = s / 3, i = r % 3, k = s % 3;
  // -d2w/dz2 block (rb, sb) = +-c [y]x, y the third jet; [y]x (i, k) =
  // eps_imk y_m; zero on the diagonal blocks and diagonals
  const bool zero = rb == sb || i == k;
  const int m = 3 - i - k;
  const int yi = zero ? 0 : 3 * (3 - rb - sb) + m;
  const bool cyc = sb == (rb + 1) % 3;    // (a, b), (b, e), (e, a)
  const bool eps = k == (i + 2) % 3;      // eps_imk = +1
  const bool pos = cyc == eps;
  double* out = H + q0 * (NP * NP) + rs;
  for (int qq = t / (NP * NP); qq < nq; qq += HQ) {
    const double cy = sc[qq] * sx[qq * NP + yi];
    out[size_t(qq) * (NP * NP)] = zero ? 0.0 : pos ? cy : -cy;
  }
}

// dynamic shared memory above the default 48 KB needs the attribute
template <class K>
int allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace
}  // namespace gf

extern "C" int gf_pressure_qp(int mode, const double* R00, const double* R10,
                              const double* R01, const int* conn,
                              const double* wq, const double* d,
                              const double* cp, const double* pr,
                              const double* lam, double* out_w, double* out_f,
                              int P, int Ne, int Q, int L, int C,
                              void* stream) {
  using namespace gf;
  Args a{{R00, R10, R01}, conn, wq, d, cp, pr, lam, P, Ne, Q, L, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t nqp = size_t(P) * Ne * Q;
  if (nqp == 0) return 0;
  // a shape whose block needs more shared memory than an SM has fails in
  // allow_smem (cudaErrorInvalidValue)
  const int epb = Q >= QPB ? 1 : QPB / Q;
  const unsigned nb = unsigned((size_t(P) * Ne + epb - 1) / epb);
  const size_t nqb = size_t(epb) * Q;
  if (mode == 0 || mode == 2) {
    void (*kernel)(Args, int, double*, double*) =
        mode == 0 ? pressure_grad_block<0> : pressure_grad_block<2>;
    const size_t smem = grad_smem(mode, int(nqb), epb, L) * sizeof(double);
    int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<nb, GTH, smem, s>>>(a, epb, out_w, out_f);
  } else if (mode == 1) {
    const size_t smem = hess_smem(int(nqb), epb, L) * sizeof(double);
    int e = allow_smem(pressure_hess, smem);
    if (e != 0) return e;
    pressure_hess<<<nb, HTH, smem, s>>>(a, epb, out_f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
