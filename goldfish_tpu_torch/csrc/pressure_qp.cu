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
// gathered through (R00, R10, R01). w is trilinear in (x, x_u, x_v), so with
// c = p wq / 3
//   dw/dz = c (x_u x x_v, x_v x x, x x x_u),
// and the Hessian applied to a jet t is the directional derivative of that
// gradient (cross products linear in x: no dual numbers needed).
//
// Modes:
//   0 value+grad: per-element W_p (deterministic in-block sum over the
//     element's qps, as K1) and dW_p/dd (P,C,3) by f64 atomics; the system
//     subtracts both (Pi = ... - W_ext);
//   1 hess: the per-qp 9x9 jet Hessian of the potential's pressure term,
//     -d2w/dz2, (P,E,Q,9,9), the third group of jet_assemble / jet_matvec;
//   2 adjoint: given lambda (P,C,3), -d/dcp of lambda^T r_p with r_p =
//     -dW_p/dd. W_p depends on the control points only through x = X + u
//     (the reference term has no d-derivative), so d2W_p/dd dcp = d2W_p/dd2
//     and the output is B^T (d2w/dz2 . lambda's 9-jet), not BC-masked.
//
// One thread per quadrature point in every mode. What bounds it on the H100:
// memory. Per qp the thread reads 3 L basis values (twice in modes 0 and 2)
// and L control points per field, does ~10^2 flops, and mode 1 writes 81
// doubles (18 MB at the 27,744 qps of the num_el=16 tube); the atomics of
// modes 0 and 2 are 3 L per qp.
#include "shell_jets.cuh"

namespace gf {
namespace {

constexpr int NP = 9;  // jet components: (value, d/du, d/dv) x 3 coordinates

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

// out_f[p, conn[ei, l], :] += sum_j R_j[qi, l] g[3 j : 3 j + 3] (the
// transpose of gather_rows<3>), f64 atomics
__device__ inline void scatter_rows(const Args& a, int p, int ei, int qi,
                                    const double* g, double* out_f) {
  for (int l = 0; l < a.L; ++l) {
    size_t node = size_t(p) * a.C + a.conn[size_t(ei) * a.L + l];
    double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      double r = a.R[j][size_t(qi) * a.L + l];
      acc[0] += r * g[3 * j];
      acc[1] += r * g[3 * j + 1];
      acc[2] += r * g[3 * j + 2];
    }
    atomicAdd(out_f + node * 3, acc[0]);
    atomicAdd(out_f + node * 3 + 1, acc[1]);
    atomicAdd(out_f + node * 3 + 2, acc[2]);
  }
}

// reference jet X and current jet x = X + z at qp qi
__device__ inline void qp_jets(const Args& a, int p, int ei, int qi, double* X,
                               double* x) {
  double z[NP];
  gather_rows<3>(a.R, a.conn, a.cp, p, ei, qi, a.L, a.C, X);
  gather_rows<3>(a.R, a.conn, a.d, p, ei, qi, a.L, a.C, z);
#pragma unroll
  for (int i = 0; i < NP; ++i) x[i] = X[i] + z[i];
}

// mode 0: one thread per qp; blockDim = Q * (elements per block)
__global__ void pressure_value_grad(Args a, double* W, double* f) {
  extern __shared__ double sm[];
  int epb = blockDim.x / a.Q;
  int ei = blockIdx.x * epb + threadIdx.x / a.Q;
  int q = threadIdx.x % a.Q;
  bool active = threadIdx.x < epb * a.Q && ei < a.P * a.Ne;
  double val = 0.0;
  if (active) {
    int p = ei / a.Ne;
    int qi = ei * a.Q + q;
    double X[NP], x[NP], g[NP];
    qp_jets(a, p, ei, qi, X, x);
    double pr = a.pr[p], wq = a.wq[qi];
    val = pr * ((triple(x) - triple(X)) / 3.0) * wq;
    grad_w(x, pr / 3.0 * wq, g);
    scatter_rows(a, p, ei, qi, g, f);
  }
  sm[threadIdx.x] = val;
  __syncthreads();
  if (active && q == 0) {
    double s = 0.0;
    for (int k = 0; k < a.Q; ++k) s += sm[threadIdx.x + k];
    W[ei] = s;
  }
}

// mode 1: one thread per qp, the 81 entries of -d2w/dz2 (symmetric)
__global__ void pressure_hess(Args a, double* H) {
  size_t qi = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (qi >= size_t(a.P) * a.Ne * a.Q) return;
  int ei = int(qi / a.Q);
  int p = ei / a.Ne;
  double X[NP], x[NP];
  qp_jets(a, p, ei, int(qi), X, x);
  double c = a.pr[p] / 3.0 * a.wq[qi];
  double* Hq = H + qi * NP * NP;
  for (int k = 0; k < NP; ++k) {
    double e[NP], col[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) e[i] = (i == k) ? 1.0 : 0.0;
    hess_w(x, e, c, col);
#pragma unroll
    for (int i = 0; i < NP; ++i) Hq[i * NP + k] = -col[i];
  }
}

// mode 2: one thread per qp
__global__ void pressure_adjoint(Args a, double* dcp) {
  size_t qi = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (qi >= size_t(a.P) * a.Ne * a.Q) return;
  int ei = int(qi / a.Q);
  int p = ei / a.Ne;
  double X[NP], x[NP], lz[NP], g[NP];
  qp_jets(a, p, ei, int(qi), X, x);
  gather_rows<3>(a.R, a.conn, a.lam, p, ei, int(qi), a.L, a.C, lz);
  hess_w(x, lz, a.pr[p] / 3.0 * a.wq[qi], g);
  scatter_rows(a, p, ei, int(qi), g, dcp);
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
  if (Q > 1024) return static_cast<int>(cudaErrorInvalidValue);
  unsigned blocks = unsigned((nqp + 127) / 128);
  if (mode == 0) {
    int epb = Q >= 128 ? 1 : 128 / Q;
    int threads = epb * Q;
    int nb = (P * Ne + epb - 1) / epb;
    pressure_value_grad<<<nb, threads, threads * sizeof(double), s>>>(
        a, out_w, out_f);
  } else if (mode == 1) {
    pressure_hess<<<blocks, 128, 0, s>>>(a, out_f);
  } else if (mode == 2) {
    pressure_adjoint<<<blocks, 128, 0, s>>>(a, out_f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
