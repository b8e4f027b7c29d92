// K1 shell_qp: Kirchhoff-Love shell (St. Venant-Kirchhoff) energy at every
// shell quadrature point, with its derivatives by dual numbers.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/kl_shell.py: internal_energy, qp_energy_density,
//     surface_fields (value; gradient = system.residual's shell part),
//     element_hessians (the per-qp 15x15 jet Hessian H_q),
//   goldfish_tpu/solver/implicit.py: _jit_entry/_jit_res_pot/_jit_trial
//     (energy + residual), _jit_residual_vjp (shell part of the adjoint
//     design gradient).
//
// One thread per quadrature point (one per (qp, Hessian column) in mode 1).
// The thread gathers its element's control points, displacements and
// thickness through the six basis rows into the midsurface jets
//   X, z = (d/du, d/dv, d2/du2, d2/dudv, d2/dv2) of the geometry and of the
//   displacement (15 numbers each), h_q = R00 . h_e,
// evaluates psi * J * w with a dual-number scalar type, and scatters
// B^T (d psi/d z) back to the control points with f64 atomics.
//
// Modes:
//   0 value+grad: per-element energy (deterministic in-block sum over the
//     element's qps), r_shell = dW/dd (P,C,3) and dW/dh (P,C);
//   1 hess: H_q = d2(psi J w)/dz2, (P,E,Q,15,15), column k by thread k;
//   2 adjoint: given lambda (P,C,3), -d/d(cp,h) of lambda^T r_shell into
//     (P,C,3) and (P,C);
//   3 geometry gradient: dW/dcp (P,C,3), the energy's direct dependence on
//     the control points (shape optimization; kl_shell.internal_energy's
//     gradient w.r.t. cp in the JAX package).
//
// What bounds it on the H100: register pressure. A Dual<Dual<double,15>,1>
// scalar is 32 doubles, so the density's temporaries spill to local memory
// (ptxas counts are in PERF.md); the arithmetic (~10^5 flops per qp in mode
// 1) and the 17,920 qps of the wing20 model keep it well below both the f64
// and the memory roofline. The design accepts the spills for now: it keeps
// one source of truth for every derivative. The structured Hessian of the
// JAX package (6 forward-over-reverse passes plus an analytic bending block)
// and splitting the dual directions across a warp are the later fixes.
#include "shell_jets.cuh"

namespace gf {
namespace {

constexpr int NJ = 15;  // jet components: 5 derivatives x 3 coordinates

// (a11, a12, a22) symmetric 2x2 contravariant metric times a symmetric
// tensor s, contracted: the SVK quadratic form E/(1-nu^2)[nu tr^2 + (1-nu)
// Aup s Aup : s].
template <class S>
__device__ S quad_form(const S* A, const S* s, double c, double nu) {
  S tr = A[0] * s[0] + 2.0 * (A[1] * s[1]) + A[2] * s[2];
  S m11 = A[0] * s[0] + A[1] * s[1];
  S m12 = A[0] * s[1] + A[1] * s[2];
  S m21 = A[1] * s[0] + A[2] * s[1];
  S m22 = A[1] * s[1] + A[2] * s[2];
  S u11 = m11 * A[0] + m12 * A[1];
  S u12 = m11 * A[1] + m12 * A[2];
  S u21 = m21 * A[0] + m22 * A[1];
  S u22 = m21 * A[1] + m22 * A[2];
  S full = u11 * s[0] + (u12 + u21) * s[1] + u22 * s[2];
  return c * (nu * (tr * tr) + (1.0 - nu) * full);
}

// psi * J_ref * w at one qp. X: reference jets (15), z: displacement jets
// (15), h: thickness at the qp.
template <class S>
__device__ S shell_density(const S* X, const S* z, S h, double E, double nu,
                           double wq) {
  const S* A1 = X;
  const S* A2 = X + 3;
  S A3[3];
  cross3(A1, A2, A3);
  S J = dsqrt(dot3(A3, A3));
  A3[0] = A3[0] / J;
  A3[1] = A3[1] / J;
  A3[2] = A3[2] / J;
  S a[3] = {dot3(A1, A1), dot3(A1, A2), dot3(A2, A2)};
  S b[3] = {dot3(X + 6, A3), dot3(X + 9, A3), dot3(X + 12, A3)};

  S x[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) x[i] = X[i] + z[i];
  S a3[3];
  cross3(x, x + 3, a3);
  unit3(a3);
  S ac[3] = {dot3(x, x), dot3(x, x + 3), dot3(x + 3, x + 3)};
  S bc[3] = {dot3(x + 6, a3), dot3(x + 9, a3), dot3(x + 12, a3)};

  S eps[3], kap[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    eps[i] = 0.5 * (ac[i] - a[i]);
    kap[i] = b[i] - bc[i];
  }
  S det = a[0] * a[2] - a[1] * a[1];
  S Aup[3] = {a[2] / det, -a[1] / det, a[0] / det};
  double c = E / (1.0 - nu * nu);
  S psi = (0.5 * h) * quad_form(Aup, eps, c, nu) +
          ((h * h * h) / 24.0) * quad_form(Aup, kap, c, nu);
  return psi * J * wq;
}

struct Args {
  const double* R[6];  // R00, R10, R01, R20, R11, R02: (P, E, Q, L)
  const int* conn;     // (P, E, L)
  const double* wq;    // (P, E, Q)
  const double* d;     // (P, C, 3)
  const double* cp;    // (P, C, 3)
  const double* h;     // (P, C)
  const double* E;     // (P,)
  const double* nu;    // (P,)
  const double* lam;   // (P, C, 3), mode 2 only
  int P, Ne, Q, L, C;
};

// jets of a (P, C, 3) field at qp `qi` = (p*Ne + e)*Q + q
__device__ void gather_jets(const Args& a, const double* f, int p, int ei,
                            int qi, double* out) {
  gather_rows<5>(a.R + 1, a.conn, f, p, ei, qi, a.L, a.C, out);
}

__device__ double gather_h(const Args& a, int p, int ei, int qi) {
  double s = 0.0;
  for (int l = 0; l < a.L; ++l)
    s += a.R[0][size_t(qi) * a.L + l] *
         a.h[size_t(p) * a.C + a.conn[size_t(ei) * a.L + l]];
  return s;
}

// out_f[node] += sign * B^T gz ; out_h[node] += sign * R00 gh (if out_h)
__device__ void scatter(const Args& a, int p, int ei, int qi, const double* gz,
                        double gh, double sign, double* out_f, double* out_h) {
  for (int l = 0; l < a.L; ++l) {
    size_t node = size_t(p) * a.C + a.conn[size_t(ei) * a.L + l];
    double acc[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      double r = a.R[j + 1][size_t(qi) * a.L + l];
      acc[0] += r * gz[3 * j];
      acc[1] += r * gz[3 * j + 1];
      acc[2] += r * gz[3 * j + 2];
    }
    atomicAdd(out_f + node * 3, sign * acc[0]);
    atomicAdd(out_f + node * 3 + 1, sign * acc[1]);
    atomicAdd(out_f + node * 3 + 2, sign * acc[2]);
    if (out_h) atomicAdd(out_h + node, sign * a.R[0][size_t(qi) * a.L + l] * gh);
  }
}

// mode 0: one thread per qp; blockDim = Q * (elements per block)
__global__ void shell_value_grad(Args a, double* W, double* r, double* dh) {
  extern __shared__ double sm[];
  int epb = blockDim.x / a.Q;
  int ei = blockIdx.x * epb + threadIdx.x / a.Q;
  int q = threadIdx.x % a.Q;
  bool active = threadIdx.x < epb * a.Q && ei < a.P * a.Ne;
  double val = 0.0;
  if (active) {
    typedef Dual<double, NJ + 1> S;
    int p = ei / a.Ne;
    int qi = ei * a.Q + q;
    double X[NJ], z[NJ];
    gather_jets(a, a.cp, p, ei, qi, X);
    gather_jets(a, a.d, p, ei, qi, z);
    double hq = gather_h(a, p, ei, qi);
    S Xs[NJ], zs[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      Xs[i] = S(X[i]);
      zs[i] = S(z[i]);
      zs[i].g[i] = 1.0;
    }
    S hs(hq);
    hs.g[NJ] = 1.0;
    S f = shell_density(Xs, zs, hs, a.E[p], a.nu[p], a.wq[qi]);
    val = f.v;
    scatter(a, p, ei, qi, f.g, f.g[NJ], 1.0, r, dh);
  }
  sm[threadIdx.x] = val;
  __syncthreads();
  if (active && q == 0) {
    double s = 0.0;
    for (int k = 0; k < a.Q; ++k) s += sm[threadIdx.x + k];
    W[ei] = s;
  }
}

// mode 1: one thread per (qp, column k)
__global__ void shell_hess(Args a, double* H) {
  size_t t = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  size_t nqp = size_t(a.P) * a.Ne * a.Q;
  if (t >= nqp * NJ) return;
  int qi = int(t / NJ);
  int k = int(t % NJ);
  int ei = qi / a.Q;
  int p = ei / a.Ne;
  typedef Dual<double, NJ> In;
  typedef Dual<In, 1> S;
  double X[NJ], z[NJ];
  gather_jets(a, a.cp, p, ei, qi, X);
  gather_jets(a, a.d, p, ei, qi, z);
  double hq = gather_h(a, p, ei, qi);
  S Xs[NJ], zs[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    Xs[i] = S(X[i]);
    zs[i] = S(z[i]);
    zs[i].v.g[i] = 1.0;
  }
  zs[k].g[0].v = 1.0;
  S f = shell_density(Xs, zs, S(hq), a.E[p], a.nu[p], a.wq[qi]);
  double* row = H + (size_t(qi) * NJ + k) * NJ;
#pragma unroll
  for (int j = 0; j < NJ; ++j) row[j] = f.g[0].g[j];
}

// mode 2: one thread per qp
__global__ void shell_adjoint(Args a, double* dcp, double* dh) {
  size_t qi = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (qi >= size_t(a.P) * a.Ne * a.Q) return;
  int ei = int(qi / a.Q);
  int p = ei / a.Ne;
  typedef Dual<double, 1> In;
  typedef Dual<In, NJ + 1> S;
  double X[NJ], z[NJ], lz[NJ];
  gather_jets(a, a.cp, p, ei, int(qi), X);
  gather_jets(a, a.d, p, ei, int(qi), z);
  gather_jets(a, a.lam, p, ei, int(qi), lz);
  double hq = gather_h(a, p, ei, int(qi));
  S Xs[NJ], zs[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    Xs[i] = S(X[i]);
    Xs[i].g[i].v = 1.0;
    zs[i] = S(z[i]);
    zs[i].v.g[0] = lz[i];
  }
  S hs(hq);
  hs.g[NJ].v = 1.0;
  S f = shell_density(Xs, zs, hs, a.E[p], a.nu[p], a.wq[qi]);
  double gX[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) gX[i] = f.g[i].g[0];
  scatter(a, p, ei, int(qi), gX, f.g[NJ].g[0], -1.0, dcp, dh);
}

// mode 3: one thread per qp
__global__ void shell_geom_grad(Args a, double* dcp) {
  size_t qi = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (qi >= size_t(a.P) * a.Ne * a.Q) return;
  int ei = int(qi / a.Q);
  int p = ei / a.Ne;
  typedef Dual<double, NJ> S;
  double X[NJ], z[NJ];
  gather_jets(a, a.cp, p, ei, int(qi), X);
  gather_jets(a, a.d, p, ei, int(qi), z);
  double hq = gather_h(a, p, ei, int(qi));
  S Xs[NJ], zs[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    Xs[i] = S(X[i]);
    Xs[i].g[i] = 1.0;
    zs[i] = S(z[i]);
  }
  S f = shell_density(Xs, zs, S(hq), a.E[p], a.nu[p], a.wq[qi]);
  scatter(a, p, ei, int(qi), f.g, 0.0, 1.0, dcp, nullptr);
}

}  // namespace
}  // namespace gf

extern "C" int gf_shell_qp(int mode, const double* R00, const double* R10,
                           const double* R01, const double* R20,
                           const double* R11, const double* R02,
                           const int* conn, const double* wq, const double* d,
                           const double* cp, const double* h, const double* E,
                           const double* nu, const double* lam, double* out_w,
                           double* out_f, double* out_h, int P, int Ne, int Q,
                           int L, int C, void* stream) {
  using namespace gf;
  Args a{{R00, R10, R01, R20, R11, R02}, conn, wq, d, cp, h, E, nu, lam,
         P, Ne, Q, L, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t nqp = size_t(P) * Ne * Q;
  if (nqp == 0) return 0;
  if (Q > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0) {
    int epb = Q >= 128 ? 1 : 128 / Q;
    int threads = epb * Q;
    int blocks = (P * Ne + epb - 1) / epb;
    shell_value_grad<<<blocks, threads, threads * sizeof(double), s>>>(
        a, out_w, out_f, out_h);
  } else if (mode == 1) {
    size_t n = nqp * NJ;
    shell_hess<<<unsigned((n + 127) / 128), 128, 0, s>>>(a, out_f);
  } else if (mode == 2) {
    shell_adjoint<<<unsigned((nqp + 127) / 128), 128, 0, s>>>(a, out_f, out_h);
  } else if (mode == 3) {
    shell_geom_grad<<<unsigned((nqp + 127) / 128), 128, 0, s>>>(a, out_f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
