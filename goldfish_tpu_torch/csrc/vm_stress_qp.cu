// K9 vm_stress_qp: von Mises stress of the Kirchhoff-Love shell (St.
// Venant-Kirchhoff, plane stress) at every shell quadrature point, and its
// pullback to the control points by dual numbers.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/kl_shell.py: qp_stress_vm (value),
//   goldfish_tpu/physics/objectives.py: max_vm_stress's jax.grad through
//     qp_stress_vm (the per-qp VJP; operations/exops.py MaxvMStressExOperation
//     takes it for every constraint gradient).
//
// At a qp, from the geometry and displacement jets X, z = (d/du, d/dv,
// d2/du2, d2/dudv, d2/dv2) x 3 (x = X + z) and h = R00 . h_e:
//   eps = (a - A)/2 + zeta h (B - b), zeta = +1/2 (top), 0 (mid), -1/2 (bottom),
//   S^ab = E/(1-nu^2) [nu tr(A^-1 eps) A^ab + (1-nu) (A^-1 eps A^-1)^ab],
//   s_ij = S^ab T_ai T_bj with T_ai = A_a . e_i (e1 = A1/|A1|, e2 by
//   Gram-Schmidt), sigma = sqrt(max(s11^2 + s22^2 - s11 s22 + 3 s12^2, 0)).
//
// Modes (one thread per qp in both):
//   0 value: sigma (P,E,Q);
//   1 VJP: given gbar (P,E,Q), gbar . dsigma/d(d, cp, h) into (P,C,3),
//     (P,C,3), (P,C) by f64 atomics (B^T of the jet cotangents, as K1 mode 0
//     scatters dpsi/dz). The 31 directions (15 of z, 15 of X, h) are taken in
//     two forward passes of 16 and 15 dual components, each evaluating the
//     same `vm_stress` template, so that no thread carries a 31-wide dual.
//
// sigma = 0 at a qp (a strain-free point) has no derivative; mode 1 gives
// that qp a zero pullback. No real qp of a loaded model reaches it
// (chip_smoke.py prints the smallest sigma of its plate state).
//
// What bounds it on the H100: like K1 mode 0, the gathers (2 x 5 basis rows
// over L locals for X and z) and the dual arithmetic of a few hundred flops
// per component; a Dual<double, 16> temporary is 17 doubles, so register
// pressure decides the occupancy (ptxas counts in PERF.md).
#include "shell_jets.cuh"

namespace gf {
namespace {

constexpr int NJ = 15;    // jet components: 5 derivatives x 3 coordinates
constexpr int NDIR = 31;  // z (15), X (15), h (1)

template <class S>
__device__ inline S vm_of(const S& v) {
  if (value_of(v) > 0.0) return dsqrt(v);
  return S(0.0);
}

// sigma_vM at one qp. X: reference jets (15), z: displacement jets (15),
// h: thickness at the qp; zeta: fiber position in thickness units.
template <class S>
__device__ S vm_stress(const S* X, const S* z, S h, double E, double nu,
                       double zeta) {
  const S* A1 = X;
  const S* A2 = X + 3;
  S A3[3];
  cross3(A1, A2, A3);
  unit3(A3);
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

  S zh = zeta * h;
  S s[3];  // strain (11, 12, 22)
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = 0.5 * (ac[i] - a[i]) + zh * (b[i] - bc[i]);
  S det = a[0] * a[2] - a[1] * a[1];
  S Au[3] = {a[2] / det, -a[1] / det, a[0] / det};  // A^-1 (11, 12, 22)

  double c = E / (1.0 - nu * nu);
  S tr = Au[0] * s[0] + Au[1] * s[1] + Au[1] * s[1] + Au[2] * s[2];
  // (A^-1 eps A^-1)^ab, as the reference's einsum over (a g, g d, d b)
  S m11 = Au[0] * s[0] + Au[1] * s[1];
  S m12 = Au[0] * s[1] + Au[1] * s[2];
  S m21 = Au[1] * s[0] + Au[2] * s[1];
  S m22 = Au[1] * s[1] + Au[2] * s[2];
  S S11 = c * (nu * tr * Au[0] + (1.0 - nu) * (m11 * Au[0] + m12 * Au[1]));
  S S12 = c * (nu * tr * Au[1] + (1.0 - nu) * (m11 * Au[1] + m12 * Au[2]));
  S S21 = c * (nu * tr * Au[1] + (1.0 - nu) * (m21 * Au[0] + m22 * Au[1]));
  S S22 = c * (nu * tr * Au[2] + (1.0 - nu) * (m21 * Au[1] + m22 * Au[2]));

  // local Cartesian frame: e1 along A1, e2 = A2 - (A2.e1) e1 normalized
  S e1[3] = {A1[0], A1[1], A1[2]};
  unit3(e1);
  S p = dot3(A2, e1);
  S e2[3] = {A2[0] - p * e1[0], A2[1] - p * e1[1], A2[2] - p * e1[2]};
  unit3(e2);
  S T11 = dot3(A1, e1), T12 = dot3(A1, e2);
  S T21 = dot3(A2, e1), T22 = dot3(A2, e2);
  // s_ij = S^ab T_ai T_bj
  S s11 = (S11 * T11 + S21 * T21) * T11 + (S12 * T11 + S22 * T21) * T21;
  S s22 = (S11 * T12 + S21 * T22) * T12 + (S12 * T12 + S22 * T22) * T22;
  S s12 = (S11 * T11 + S21 * T21) * T12 + (S12 * T11 + S22 * T21) * T22;
  return vm_of(s11 * s11 + s22 * s22 - s11 * s22 + 3.0 * (s12 * s12));
}

struct Args {
  const double* R[6];  // R00, R10, R01, R20, R11, R02: (P, E, Q, L)
  const int* conn;     // (P, E, L)
  const double* d;     // (P, C, 3)
  const double* cp;    // (P, C, 3)
  const double* h;     // (P, C)
  const double* E;     // (P,)
  const double* nu;    // (P,)
  const double* gbar;  // (P, E, Q), mode 1 only
  double zeta;
  int P, Ne, Q, L, C;
};

struct QP {
  double X[NJ], z[NJ], h;
  int p, ei, qi;
};

__device__ inline void load_qp(const Args& a, int qi, QP& s) {
  s.qi = qi;
  s.ei = qi / a.Q;
  s.p = s.ei / a.Ne;
  gather_rows<5>(a.R + 1, a.conn, a.cp, s.p, s.ei, qi, a.L, a.C, s.X);
  gather_rows<5>(a.R + 1, a.conn, a.d, s.p, s.ei, qi, a.L, a.C, s.z);
  double hq = 0.0;
  for (int l = 0; l < a.L; ++l)
    hq += a.R[0][size_t(qi) * a.L + l] *
          a.h[size_t(s.p) * a.C + a.conn[size_t(s.ei) * a.L + l]];
  s.h = hq;
}

// sigma with the directions off, off+1, ... (of the NDIR ordered z, X, h)
// seeded: out[k] = dsigma / d(direction off + k)
template <int N>
__device__ inline double dual_pass(const Args& a, const QP& s, int off,
                                   double* out) {
  typedef Dual<double, N> S;
  S Xs[NJ], zs[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) {
    zs[i] = S(s.z[i]);
    Xs[i] = S(s.X[i]);
    int kz = i - off, kx = NJ + i - off;
    if (kz >= 0 && kz < N) zs[i].g[kz] = 1.0;
    if (kx >= 0 && kx < N) Xs[i].g[kx] = 1.0;
  }
  S hs(s.h);
  int kh = 2 * NJ - off;
  if (kh >= 0 && kh < N) hs.g[kh] = 1.0;
  S f = vm_stress(Xs, zs, hs, a.E[s.p], a.nu[s.p], a.zeta);
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = f.g[k];
  return f.v;
}

__global__ void vm_value(Args a, double* sig) {
  size_t qi = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (qi >= size_t(a.P) * a.Ne * a.Q) return;
  QP s;
  load_qp(a, int(qi), s);
  sig[qi] = vm_stress(s.X, s.z, s.h, a.E[s.p], a.nu[s.p], a.zeta);
}

__global__ void vm_vjp(Args a, double* dd, double* dcp, double* dh) {
  size_t qi = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (qi >= size_t(a.P) * a.Ne * a.Q) return;
  double gb = a.gbar[qi];
  if (gb == 0.0) return;
  QP s;
  load_qp(a, int(qi), s);
  double g[NDIR];
  dual_pass<16>(a, s, 0, g);
  dual_pass<NDIR - 16>(a, s, 16, g + 16);
  for (int l = 0; l < a.L; ++l) {
    size_t node = size_t(s.p) * a.C + a.conn[size_t(s.ei) * a.L + l];
    double ad[3] = {0.0, 0.0, 0.0}, ax[3] = {0.0, 0.0, 0.0};
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      double r = a.R[j + 1][qi * a.L + l];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        ad[c] += r * g[3 * j + c];
        ax[c] += r * g[NJ + 3 * j + c];
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      atomicAdd(dd + node * 3 + c, gb * ad[c]);
      atomicAdd(dcp + node * 3 + c, gb * ax[c]);
    }
    atomicAdd(dh + node, gb * a.R[0][qi * a.L + l] * g[2 * NJ]);
  }
}

}  // namespace
}  // namespace gf

extern "C" int gf_vm_stress_qp(int mode, const double* R00, const double* R10,
                               const double* R01, const double* R20,
                               const double* R11, const double* R02,
                               const int* conn, const double* d,
                               const double* cp, const double* h,
                               const double* E, const double* nu,
                               const double* gbar, double* out_s,
                               double* out_dd, double* out_dcp, double* out_dh,
                               double zeta, int P, int Ne, int Q, int L, int C,
                               void* stream) {
  using namespace gf;
  Args a{{R00, R10, R01, R20, R11, R02}, conn, d, cp, h, E, nu, gbar, zeta,
         P, Ne, Q, L, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t nqp = size_t(P) * Ne * Q;
  if (nqp == 0) return 0;
  unsigned blocks = unsigned((nqp + 127) / 128);
  if (mode == 0) {
    vm_value<<<blocks, 128, 0, s>>>(a, out_s);
  } else if (mode == 1) {
    vm_vjp<<<blocks, 128, 0, s>>>(a, out_dd, out_dcp, out_dh);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
