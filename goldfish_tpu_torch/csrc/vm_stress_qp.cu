// K9 vm_stress_qp: von Mises stress of the Kirchhoff-Love shell (St.
// Venant-Kirchhoff, plane stress) at every shell quadrature point, and its
// pullback to the control points by a hand-written reverse sweep.
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
// Layout: a block holds EB whole elements (EB = 64 / Q, blockDim EB Q). It
// stages the elements' six basis tables (6 x Q x L rows each, contiguous,
// copied coalesced by cp.async, all in flight at once) and their L nodes'
// cp, d and h (once an element, not once a qp) in shared memory; then one
// thread takes one qp and gathers its jets from there.
//   mode 0 value: sigma (P,E,Q) in plain doubles, stored coalesced;
//   mode 1 VJP: given gbar (P,E,Q), gbar . dsigma/d(d, cp, h) into (P,C,3),
//     (P,C,3), (P,C). Each thread runs the forward pass in plain doubles and
//     a hand-written reverse sweep (`vm_sweep`: sigma -> s_ij -> the frame
//     e1, e2 and S^ab -> A^-1 and the strains -> A3, a3 -> the 15 z-jets,
//     the 15 X-jets and h); the block then sums B^T of each element's jet
//     cotangents over its Q qps, in qp order, into per-element partials
//     (P,E,L,7); a second kernel (`vm_gather`) sums each node's partials
//     over its incident (element, local) pairs in a fixed order (a CSR
//     built once per stack by the wrapper). No atomics: the same bits on
//     every launch.
//   mode 2 rows: every qp's own Jacobian row, the dense field Jacobian's
//     building block. Each thread runs mode 1's forward pass and sweep
//     with a cotangent of 1 at its qp (replacing the JAX device program
//     jax.jacrev of qp_stress_vm in goldfish_tpu/operations/exops.py:
//     VMStressExOperation); the block then writes B^T of each qp's jet
//     cotangents, (L, 7) = (d xyz, cp xyz, h) a local node, into
//     (P, E, Q, L, 7): no sum over the element, no gather. Consecutive
//     threads write consecutive (qp, local) rows of 7. Every entry is
//     written once: the same bits on every launch.
//
// sigma = 0 at a qp (a strain-free point) has no derivative; mode 1 gives
// that qp a zero pullback, as it does a qp with gbar = 0 (no sweep). No
// real qp of a loaded model reaches sigma = 0 (chip_smoke.py prints the
// smallest sigma of its plate state).
//
// What bounds it on the H100: the value mode reads the six tables (8 MB at
// the num_el=32 plate), so bytes, then a qp's ~300 dependent operations;
// the VJP adds its sweep, ~800 dependent f64 operations a qp at one thread
// a qp, and the gather's dependent loads, batched GCH pairs at a time. The
// rows mode writes 7/6 of the tables' bytes again (L 7 doubles a qp
// against 6 L read), so bytes bound it.
#include <cuda_pipeline.h>

#include "dual.cuh"

namespace gf {
namespace {

constexpr int NJ = 15;           // jet components: 5 derivatives x 3
constexpr int NG = 2 * NJ + 1;   // cotangents a qp: z (15), X (15), h
constexpr int NP = 7;            // partials a (element, local): d, cp, h
constexpr int NT = 6;            // basis tables R00, R10, R01, R20, R11, R02
constexpr int GCH = 8;           // pairs a gather thread loads at once

__device__ __forceinline__ void scale3(double* a, double r) {
  a[0] *= r;
  a[1] *= r;
  a[2] *= r;
}

// y = v r (r = 1 / |v|) backwards: vb = (yb - (yb . y) y) r
__device__ __forceinline__ void unit_rev(const double* y, double r,
                                         const double* yb, double* vb) {
  const double pr = dot3(yb, y);
#pragma unroll
  for (int i = 0; i < 3; ++i) vb[i] = (yb[i] - pr * y[i]) * r;
}

// sigma_vM at one qp. X: reference jets (15), z: displacement jets (15),
// h: thickness at the qp; zeta: fiber position in thickness units. The
// norms and det enter as reciprocals (one division each).
__device__ double vm_stress(const double* X, const double* z, double h,
                            double E, double nu, double zeta) {
  const double* A1 = X;
  const double* A2 = X + 3;
  double A3[3];
  cross3(A1, A2, A3);
  scale3(A3, 1.0 / sqrt(dot3(A3, A3)));
  double a[3] = {dot3(A1, A1), dot3(A1, A2), dot3(A2, A2)};
  double b[3] = {dot3(X + 6, A3), dot3(X + 9, A3), dot3(X + 12, A3)};

  double x[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) x[i] = X[i] + z[i];
  double a3[3];
  cross3(x, x + 3, a3);
  scale3(a3, 1.0 / sqrt(dot3(a3, a3)));
  double ac[3] = {dot3(x, x), dot3(x, x + 3), dot3(x + 3, x + 3)};
  double bc[3] = {dot3(x + 6, a3), dot3(x + 9, a3), dot3(x + 12, a3)};

  double zh = zeta * h;
  double s[3];  // strain (11, 12, 22)
#pragma unroll
  for (int i = 0; i < 3; ++i) s[i] = 0.5 * (ac[i] - a[i]) + zh * (b[i] - bc[i]);
  double rdet = 1.0 / (a[0] * a[2] - a[1] * a[1]);
  double Au[3] = {a[2] * rdet, -a[1] * rdet, a[0] * rdet};  // A^-1 (11, 12, 22)

  double c = E / (1.0 - nu * nu);
  double tr = Au[0] * s[0] + Au[1] * s[1] + Au[1] * s[1] + Au[2] * s[2];
  // (A^-1 eps A^-1)^ab, as the reference's einsum over (a g, g d, d b)
  double m11 = Au[0] * s[0] + Au[1] * s[1];
  double m12 = Au[0] * s[1] + Au[1] * s[2];
  double m21 = Au[1] * s[0] + Au[2] * s[1];
  double m22 = Au[1] * s[1] + Au[2] * s[2];
  double S11 = c * (nu * tr * Au[0] + (1.0 - nu) * (m11 * Au[0] + m12 * Au[1]));
  double S12 = c * (nu * tr * Au[1] + (1.0 - nu) * (m11 * Au[1] + m12 * Au[2]));
  double S21 = c * (nu * tr * Au[1] + (1.0 - nu) * (m21 * Au[0] + m22 * Au[1]));
  double S22 = c * (nu * tr * Au[2] + (1.0 - nu) * (m21 * Au[1] + m22 * Au[2]));

  // local Cartesian frame: e1 along A1, e2 = A2 - (A2.e1) e1 normalized
  double e1[3] = {A1[0], A1[1], A1[2]};
  scale3(e1, 1.0 / sqrt(dot3(e1, e1)));
  double p = dot3(A2, e1);
  double e2[3] = {A2[0] - p * e1[0], A2[1] - p * e1[1], A2[2] - p * e1[2]};
  scale3(e2, 1.0 / sqrt(dot3(e2, e2)));
  double T11 = dot3(A1, e1), T12 = dot3(A1, e2);
  double T21 = dot3(A2, e1), T22 = dot3(A2, e2);
  // s_ij = S^ab T_ai T_bj
  double s11 = (S11 * T11 + S21 * T21) * T11 + (S12 * T11 + S22 * T21) * T21;
  double s22 = (S11 * T12 + S21 * T22) * T12 + (S12 * T12 + S22 * T22) * T22;
  double s12 = (S11 * T11 + S21 * T21) * T12 + (S12 * T11 + S22 * T21) * T22;
  double v = s11 * s11 + s22 * s22 - s11 * s22 + 3.0 * (s12 * s12);
  return v > 0.0 ? sqrt(v) : 0.0;
}

// gb . dsigma/d(z, X, h) at one qp: the forward pass of vm_stress in plain
// doubles, then its reverse sweep by hand. g (NG) = (z (15), X (15), h);
// zeros where sigma = 0.
__device__ void vm_sweep(const double* X, const double* z, double h,
                         double E, double nu, double zeta, double gb,
                         double* g) {
  const double* A1 = X;
  const double* A2 = X + 3;
  double A3[3];
  cross3(A1, A2, A3);
  const double rA3 = 1.0 / sqrt(dot3(A3, A3));
  scale3(A3, rA3);
  const double a[3] = {dot3(A1, A1), dot3(A1, A2), dot3(A2, A2)};
  const double b[3] = {dot3(X + 6, A3), dot3(X + 9, A3), dot3(X + 12, A3)};
  double x[NJ];
#pragma unroll
  for (int i = 0; i < NJ; ++i) x[i] = X[i] + z[i];
  double a3[3];
  cross3(x, x + 3, a3);
  const double ra3 = 1.0 / sqrt(dot3(a3, a3));
  scale3(a3, ra3);
  const double bc[3] = {dot3(x + 6, a3), dot3(x + 9, a3), dot3(x + 12, a3)};
  const double zh = zeta * h;
  double s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const double aci = i == 0 ? dot3(x, x)
                     : i == 1 ? dot3(x, x + 3) : dot3(x + 3, x + 3);
    s[i] = 0.5 * (aci - a[i]) + zh * (b[i] - bc[i]);
  }
  const double rdet = 1.0 / (a[0] * a[2] - a[1] * a[1]);
  const double Au[3] = {a[2] * rdet, -a[1] * rdet, a[0] * rdet};
  const double c = E / (1.0 - nu * nu);
  const double tr = Au[0] * s[0] + Au[1] * s[1] + Au[1] * s[1] + Au[2] * s[2];
  const double m11 = Au[0] * s[0] + Au[1] * s[1];
  const double m12 = Au[0] * s[1] + Au[1] * s[2];
  const double m21 = Au[1] * s[0] + Au[2] * s[1];
  const double m22 = Au[1] * s[1] + Au[2] * s[2];
  const double S11 = c * (nu * tr * Au[0] + (1.0 - nu) * (m11 * Au[0] + m12 * Au[1]));
  const double S12 = c * (nu * tr * Au[1] + (1.0 - nu) * (m11 * Au[1] + m12 * Au[2]));
  const double S21 = c * (nu * tr * Au[1] + (1.0 - nu) * (m21 * Au[0] + m22 * Au[1]));
  const double S22 = c * (nu * tr * Au[2] + (1.0 - nu) * (m21 * Au[1] + m22 * Au[2]));
  const double re1 = 1.0 / sqrt(dot3(A1, A1));
  const double e1[3] = {A1[0] * re1, A1[1] * re1, A1[2] * re1};
  const double p = dot3(A2, e1);
  double e2[3] = {A2[0] - p * e1[0], A2[1] - p * e1[1], A2[2] - p * e1[2]};
  const double re2 = 1.0 / sqrt(dot3(e2, e2));
  scale3(e2, re2);
  const double T11 = dot3(A1, e1), T12 = dot3(A1, e2);
  const double T21 = dot3(A2, e1), T22 = dot3(A2, e2);
  const double u1 = S11 * T11 + S21 * T21, u2 = S12 * T11 + S22 * T21;
  const double w1 = S11 * T12 + S21 * T22, w2 = S12 * T12 + S22 * T22;
  const double s11 = u1 * T11 + u2 * T21;
  const double s22 = w1 * T12 + w2 * T22;
  const double s12 = u1 * T12 + u2 * T22;
  const double v = s11 * s11 + s22 * s22 - s11 * s22 + 3.0 * (s12 * s12);
  if (!(v > 0.0)) {
#pragma unroll
    for (int k = 0; k < NG; ++k) g[k] = 0.0;
    return;
  }
  // back: sigma = sqrt(v)
  const double vb = gb / (2.0 * sqrt(v));
  const double s11b = vb * (2.0 * s11 - s22);
  const double s22b = vb * (2.0 * s22 - s11);
  const double s12b = vb * (6.0 * s12);
  // s11 = u1 T11 + u2 T21, s12 = u1 T12 + u2 T22, s22 = w1 T12 + w2 T22
  const double u1b = s11b * T11 + s12b * T12;
  const double u2b = s11b * T21 + s12b * T22;
  const double w1b = s22b * T12, w2b = s22b * T22;
  // u1 = S11 T11 + S21 T21, u2 = S12 T11 + S22 T21, w1 = S11 T12 + S21 T22,
  // w2 = S12 T12 + S22 T22
  const double T11b = s11b * u1 + u1b * S11 + u2b * S12;
  const double T21b = s11b * u2 + u1b * S21 + u2b * S22;
  const double T12b = s12b * u1 + s22b * w1 + w1b * S11 + w2b * S12;
  const double T22b = s12b * u2 + s22b * w2 + w1b * S21 + w2b * S22;
  const double S11b = u1b * T11 + w1b * T12, S21b = u1b * T21 + w1b * T22;
  const double S12b = u2b * T11 + w2b * T12, S22b = u2b * T21 + w2b * T22;
  // S^ab = k1 tr A^ab + k2 (m A^-1)^ab
  const double k1 = c * nu, k2 = c * (1.0 - nu);
  const double trb =
      k1 * (S11b * Au[0] + (S12b + S21b) * Au[1] + S22b * Au[2]);
  const double m11b = k2 * (S11b * Au[0] + S12b * Au[1]);
  const double m12b = k2 * (S11b * Au[1] + S12b * Au[2]);
  const double m21b = k2 * (S21b * Au[0] + S22b * Au[1]);
  const double m22b = k2 * (S21b * Au[1] + S22b * Au[2]);
  // A^-1: from S^ab, then from m and tr
  double Aub[3];
  Aub[0] = k1 * (S11b * tr) + k2 * (S11b * m11 + S21b * m21) +
           (m11b * s[0] + m12b * s[1] + trb * s[0]);
  Aub[1] = k1 * ((S12b + S21b) * tr) +
           k2 * (S11b * m12 + S12b * m11 + S21b * m22 + S22b * m21) +
           (m11b * s[1] + m12b * s[2] + m21b * s[0] + m22b * s[1] +
            2.0 * (trb * s[1]));
  Aub[2] = k1 * (S22b * tr) + k2 * (S12b * m12 + S22b * m22) +
           (m21b * s[1] + m22b * s[2] + trb * s[2]);
  // the strains
  const double sb[3] = {
      m11b * Au[0] + m21b * Au[1] + trb * Au[0],
      m11b * Au[1] + m12b * Au[0] + m21b * Au[2] + m22b * Au[1] +
          2.0 * (trb * Au[1]),
      m12b * Au[1] + m22b * Au[2] + trb * Au[2]};
  // Au = (a2, -a1, a0) / det, det = a0 a2 - a1^2
  const double detb =
      -(Aub[0] * Au[0] + Aub[1] * Au[1] + Aub[2] * Au[2]) * rdet;
  double ab[3] = {Aub[2] * rdet + detb * a[2],
                  -Aub[1] * rdet - 2.0 * (detb * a[1]),
                  Aub[0] * rdet + detb * a[0]};
  // s_i = (ac_i - a_i) / 2 + zh (b_i - bc_i)
  double zhb = 0.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    ab[i] = ab[i] - 0.5 * sb[i];
    zhb += sb[i] * (b[i] - bc[i]);
  }
  g[2 * NJ] = zeta * zhb;
  // current configuration: ac = (x0.x0, x0.x1, x1.x1), bc_i = x_{2+i} . a3
  double* xb = g;  // z's cotangents = x's
  double a3b[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const double acb0 = 0.5 * sb[0], acb1 = 0.5 * sb[1], acb2 = 0.5 * sb[2];
    xb[k] = 2.0 * (acb0 * x[k]) + acb1 * x[3 + k];
    xb[3 + k] = acb1 * x[k] + 2.0 * (acb2 * x[3 + k]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double bcb = -zh * sb[i];
      xb[6 + 3 * i + k] = bcb * a3[k];
      a3b[k] += bcb * x[6 + 3 * i + k];
    }
  }
  double nb[3];
  unit_rev(a3, ra3, a3b, nb);
  cross3_rev(x, x + 3, nb, xb, xb + 3);
  // reference configuration: a = (A1.A1, A1.A2, A2.A2), b_i = X_{2+i} . A3
  double* Xb = g + NJ;
  double A3b[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Xb[k] = xb[k] + 2.0 * (ab[0] * A1[k]) + ab[1] * A2[k];
    Xb[3 + k] = xb[3 + k] + ab[1] * A1[k] + 2.0 * (ab[2] * A2[k]);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double bb = zh * sb[i];
      Xb[6 + 3 * i + k] = xb[6 + 3 * i + k] + bb * A3[k];
      A3b[k] += bb * X[6 + 3 * i + k];
    }
  }
  unit_rev(A3, rA3, A3b, nb);
  cross3_rev(A1, A2, nb, Xb, Xb + 3);
  // the frame: T_ai = A_a . e_i, e2 = unit(A2 - p e1), p = A2 . e1,
  // e1 = unit(A1)
  double e1b[3], e2b[3], e2rb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Xb[k] = Xb[k] + (T11b * e1[k] + T12b * e2[k]);
    Xb[3 + k] = Xb[3 + k] + (T21b * e1[k] + T22b * e2[k]);
    e1b[k] = T11b * A1[k] + T21b * A2[k];
    e2b[k] = T12b * A1[k] + T22b * A2[k];
  }
  unit_rev(e2, re2, e2b, e2rb);
  const double pb = -dot3(e2rb, e1);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    Xb[3 + k] = Xb[3 + k] + (e2rb[k] + pb * e1[k]);
    e1b[k] = e1b[k] - p * e2rb[k] + pb * A2[k];
  }
  unit_rev(e1, re1, e1b, nb);
#pragma unroll
  for (int k = 0; k < 3; ++k) Xb[k] = Xb[k] + nb[k];
}

struct Args {
  const double* R[NT];  // R00, R10, R01, R20, R11, R02: (P, E, Q, L)
  const int* conn;      // (P, E, L)
  const double* d;      // (P, C, 3)
  const double* cp;     // (P, C, 3)
  const double* h;      // (P, C)
  const double* E;      // (P,)
  const double* nu;     // (P,)
  const double* gbar;   // (P, E, Q), mode 1 only
  double zeta;
  int P, Ne, Q, L, C;
};

// The block's elements [e0, e0 + nE) (flat over P x E) into shared memory:
// sR (NT, EB Q, L) the six tables' rows, sN (EB L, 7) each local node's
// cp, d and h, every copy in flight at once (cp.async). Then this thread's
// qp's jets X, z (15 each) and h.
__device__ void stage_and_jets(const Args& a, int e0, int nE, double* sR,
                               double* sN, double* X, double* z, double& h) {
  const int EB = blockDim.x / a.Q;
  const int QL = a.Q * a.L, TB = EB * QL;
  const int n = nE * QL;
  const size_t base = size_t(e0) * QL;
#pragma unroll
  for (int j = 0; j < NT; ++j)
    for (int k = threadIdx.x; k < n; k += blockDim.x)
      __pipeline_memcpy_async(sR + j * TB + k, a.R[j] + base + k, 8);
  for (int k = threadIdx.x; k < nE * a.L; k += blockDim.x) {
    const int p = (e0 + k / a.L) / a.Ne;
    const size_t node = size_t(p) * a.C + a.conn[size_t(e0) * a.L + k];
    double* s = sN + k * NP;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      __pipeline_memcpy_async(s + c, a.cp + node * 3 + c, 8);
      __pipeline_memcpy_async(s + 3 + c, a.d + node * 3 + c, 8);
    }
    __pipeline_memcpy_async(s + 6, a.h + node, 8);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int el = threadIdx.x / a.Q;
  if (el >= nE) return;
  const double* r = sR + threadIdx.x * a.L;  // this qp's rows
#pragma unroll
  for (int i = 0; i < NJ; ++i) X[i] = z[i] = 0.0;
  h = 0.0;
  for (int l = 0; l < a.L; ++l) {
    const double* s = sN + (el * a.L + l) * NP;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const double rj = r[(j + 1) * TB + l];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        X[3 * j + c] += rj * s[c];
        z[3 * j + c] += rj * s[3 + c];
      }
    }
    h += r[l] * s[6];
  }
}

__device__ inline int block_elements(const Args& a, int& e0) {
  const int EB = blockDim.x / a.Q;
  const int ne = a.P * a.Ne;
  e0 = blockIdx.x * EB;
  return ne - e0 < EB ? ne - e0 : EB;
}

__global__ void vm_value(Args a, double* sig) {
  extern __shared__ double sm[];
  int e0;
  const int nE = block_elements(a, e0);
  const int TB = blockDim.x * a.L;
  double X[NJ], z[NJ], h;
  stage_and_jets(a, e0, nE, sm, sm + NT * TB, X, z, h);
  if (int(threadIdx.x) >= nE * a.Q) return;
  const int p = (e0 + int(threadIdx.x) / a.Q) / a.Ne;
  sig[size_t(e0) * a.Q + threadIdx.x] =
      vm_stress(X, z, h, a.E[p], a.nu[p], a.zeta);
}

// the sweep at every qp of the block's elements, then B^T of each
// element's cotangents summed over its qps in order: part (P, E, L, 7)
__global__ void vm_vjp_elements(Args a, double* part) {
  extern __shared__ double sm[];
  int e0;
  const int nE = block_elements(a, e0);
  const int TB = blockDim.x * a.L;
  double* sR = sm;
  double* sN = sR + NT * TB;
  double* sG = sN + (blockDim.x / a.Q) * a.L * NP;  // (EB Q, NG)
  double X[NJ], z[NJ], h;
  stage_and_jets(a, e0, nE, sR, sN, X, z, h);
  if (int(threadIdx.x) < nE * a.Q) {
    const size_t qi = size_t(e0) * a.Q + threadIdx.x;
    const int p = (e0 + int(threadIdx.x) / a.Q) / a.Ne;
    const double gb = a.gbar[qi];
    double* g = sG + threadIdx.x * NG;
    if (gb == 0.0) {
#pragma unroll
      for (int k = 0; k < NG; ++k) g[k] = 0.0;
    } else {
      vm_sweep(X, z, h, a.E[p], a.nu[p], a.zeta, gb, g);
    }
  }
  __syncthreads();
  // one (element, local) a task: its 7 partials, summed over the qps in
  // order
  for (int task = threadIdx.x; task < nE * a.L; task += blockDim.x) {
    const int el = task / a.L, l = task - el * a.L;
    const double* r = sR + el * a.Q * a.L + l;
    const double* g = sG + el * a.Q * NG;
    double acc[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[c] = 0.0;
    for (int q = 0; q < a.Q; ++q) {
      const double* gq = g + q * NG;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const double rj = r[(j + 1) * TB + q * a.L];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          acc[c] += rj * gq[3 * j + c];
          acc[3 + c] += rj * gq[NJ + 3 * j + c];
        }
      }
      acc[6] += r[q * a.L] * gq[2 * NJ];
    }
    double* out = part + (size_t(e0) * a.L + task) * NP;
#pragma unroll
    for (int c = 0; c < NP; ++c) out[c] = acc[c];
  }
}

// the sweep at every qp of the block's elements with a cotangent of 1,
// then each qp's B^T of its own cotangents: rows (P, E, Q, L, 7)
__global__ void vm_rows(Args a, double* rows) {
  extern __shared__ double sm[];
  int e0;
  const int nE = block_elements(a, e0);
  const int TB = blockDim.x * a.L;
  double* sR = sm;
  double* sN = sR + NT * TB;
  double* sG = sN + (blockDim.x / a.Q) * a.L * NP;  // (EB Q, NG)
  double X[NJ], z[NJ], h;
  stage_and_jets(a, e0, nE, sR, sN, X, z, h);
  if (int(threadIdx.x) < nE * a.Q) {
    const int p = (e0 + int(threadIdx.x) / a.Q) / a.Ne;
    vm_sweep(X, z, h, a.E[p], a.nu[p], a.zeta, 1.0, sG + threadIdx.x * NG);
  }
  __syncthreads();
  // one (qp, local) a task: its 7 entries
  for (int task = threadIdx.x; task < nE * a.Q * a.L; task += blockDim.x) {
    const int qp = task / a.L, l = task - qp * a.L;
    const double* r = sR + qp * a.L + l;
    const double* gq = sG + qp * NG;
    double acc[NP];
#pragma unroll
    for (int c = 0; c < NP; ++c) acc[c] = 0.0;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const double rj = r[(j + 1) * TB];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        acc[c] += rj * gq[3 * j + c];
        acc[3 + c] += rj * gq[NJ + 3 * j + c];
      }
    }
    acc[6] = r[0] * gq[2 * NJ];
    double* out = rows + (size_t(e0) * a.Q * a.L + task) * NP;
#pragma unroll
    for (int c = 0; c < NP; ++c) out[c] = acc[c];
  }
}

// every node's partials over its incident (element, local) pairs, in the
// CSR's order: dd, dcp (P, C, 3), dh (P, C)
__global__ void vm_gather(const int* ptr, const int* idx, const double* part,
                          int nodes, double* dd, double* dcp, double* dh) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= nodes) return;
  double acc[NP];
#pragma unroll
  for (int c = 0; c < NP; ++c) acc[c] = 0.0;
  const int k1 = ptr[n + 1];
  for (int k0 = ptr[n]; k0 < k1; k0 += GCH) {
    // a chunk's loads all in flight, then its sums in order
    double v[GCH][NP];
#pragma unroll
    for (int j = 0; j < GCH; ++j) {
      const double* pp = part + size_t(k0 + j < k1 ? idx[k0 + j] : 0) * NP;
#pragma unroll
      for (int c = 0; c < NP; ++c) v[j][c] = k0 + j < k1 ? pp[c] : 0.0;
    }
#pragma unroll
    for (int j = 0; j < GCH; ++j)
      if (k0 + j < k1) {
#pragma unroll
        for (int c = 0; c < NP; ++c) acc[c] += v[j][c];
      }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    dd[size_t(n) * 3 + c] = acc[c];
    dcp[size_t(n) * 3 + c] = acc[3 + c];
  }
  dh[n] = acc[6];
}

// shared memory of a block of EB elements: the tables, the nodes and, in
// the VJP, the qps' cotangents
size_t smem_bytes(int mode, int EB, int Q, int L) {
  size_t n = size_t(NT) * EB * Q * L + size_t(EB) * L * NP;
  if (mode != 0) n += size_t(EB) * Q * NG;
  return n * sizeof(double);
}

template <class K>
int opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace
}  // namespace gf

extern "C" int gf_vm_stress_qp(
    int mode, const double* R00, const double* R10, const double* R01,
    const double* R20, const double* R11, const double* R02, const int* conn,
    const double* d, const double* cp, const double* h, const double* E,
    const double* nu, const double* gbar, const int* inc_ptr,
    const int* inc_idx, double* part, double* out_s, double* out_dd,
    double* out_dcp, double* out_dh, double zeta, int P, int Ne, int Q, int L,
    int C, void* stream) {
  using namespace gf;
  Args a{{R00, R10, R01, R20, R11, R02}, conn, d, cp, h, E, nu, gbar, zeta,
         P, Ne, Q, L, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ne = P * Ne;
  if (Q < 1 || Q > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (ne == 0) return 0;
  const int EB = 64 / Q;
  const unsigned blocks = unsigned((ne + EB - 1) / EB);
  const size_t smem = smem_bytes(mode, EB, Q, L);
  int rc = 0;
  if (mode == 0) {
    if ((rc = opt_in(vm_value, smem))) return rc;
    vm_value<<<blocks, EB * Q, smem, s>>>(a, out_s);
  } else if (mode == 1) {
    if ((rc = opt_in(vm_vjp_elements, smem))) return rc;
    vm_vjp_elements<<<blocks, EB * Q, smem, s>>>(a, part);
    if ((rc = launch_status())) return rc;
    const int nodes = P * C;
    vm_gather<<<unsigned((nodes + 127) / 128), 128, 0, s>>>(
        inc_ptr, inc_idx, part, nodes, out_dd, out_dcp, out_dh);
  } else if (mode == 2) {
    if ((rc = opt_in(vm_rows, smem))) return rc;
    vm_rows<<<blocks, EB * Q, smem, s>>>(a, part);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
