// K1 shell_qp: Kirchhoff-Love shell (St. Venant-Kirchhoff) energy at every
// shell quadrature point, with its derivatives by dual numbers.
//
// Replaces the JAX device programs
//   goldfish_tpu/physics/kl_shell.py: internal_energy, qp_energy_density,
//     surface_fields (value; gradient = system.residual's shell part),
//     element_hessians (the per-qp 15x15 jet Hessian H_q, in its
//     structured form at :251-303),
//   goldfish_tpu/solver/implicit.py: _jit_entry/_jit_res_pot/_jit_trial
//     (energy + residual), _jit_residual_vjp (shell part of the adjoint
//     design gradient).
//
// Modes 0, 2, 3: one thread per quadrature point. The thread gathers its
// element's control points, displacements and thickness through the six
// basis rows into the midsurface jets
//   X, z = (d/du, d/dv, d2/du2, d2/dudv, d2/dv2) of the geometry and of the
//   displacement (15 numbers each), h_q = R00 . h_e,
// evaluates psi * J * w with a dual-number scalar type, and scatters
// B^T (d psi/d z) back to the control points with f64 atomics.
//
// Modes:
//   0 value+grad: per-element energy (deterministic in-block sum over the
//     element's qps), r_shell = dW/dd (P,C,3) and dW/dh (P,C);
//   1 hess: H_q = d2(psi J w)/dz2, (P,E,Q,15,15), structured (below);
//   2 adjoint: given lambda (P,C,3), -d/d(cp,h) of lambda^T r_shell into
//     (P,C,3) and (P,C);
//   3 geometry gradient: dW/dcp (P,C,3), the energy's direct dependence on
//     the control points (shape optimization; kl_shell.internal_energy's
//     gradient w.r.t. cp in the JAX package).
//
// Mode 1, the structured jet Hessian. Split z = (m, s): m = (x_u, x_v) the
// 6 first-jet components, s = (x_uu, x_uv, x_vv) the 9 second-jet ones.
// s enters psi only through bc_i = (X_i + s_i) . a3, linearly, and a3 and
// the metric depend on m alone, so the s-s block is closed form,
//   H_ss = Hc (x) a3 a3^T,  Hc = J w h^3/12 M  (psi's bending part is
//   h^3/24 kap^T M kap with M the SVK form's 3x3 matrix),
// and only the 6 columns d(grad psi)/dm_k take derivatives: each is one
// forward tangent (Dual<double, 1>) through `density_grad`, a hand-written
// reverse sweep of shell_density; H_ms = H_sm^T. One block holds whole
// elements, 6 threads a qp (one a column). The block gathers each qp's X,
// z and h once into shared memory (thread k of a qp: the jet through
// R_(k+1), thread 5: h), and stages the 225 outputs of every qp there, so
// the store of the block's contiguous H rows is coalesced.
//
// What bounds it on the H100: bytes. Mode 1 writes 1800 B a qp (32 MB at
// wing20) and reads the five R rows and R00 (6 L doubles a qp): 46.4 MB at
// wing20, 0.0138 ms at 3.35 TB/s; its arithmetic (~8,400 f64 operations a
// qp) is a third of that at the f64 rate. The earlier one-thread-per-column
// Dual<Dual<double,15>,1> form spilled ~4.5 KB a thread to local memory
// and took 1.08 ms at wing20; a column thread now takes 128 registers and
// spills nothing, and the kernel takes 0.035 ms, 2.5x its byte bound (NVIDIA
// H100 80GB HBM3, 700 W; scripts/torch_port_kernel_ab.py, PERF.md).
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

// ---------------------------------------------------------------- mode 1
constexpr int NM = 6;          // first-jet components m = (x_u, x_v)
constexpr int HQ = NJ * NJ;    // outputs per qp
// doubles of shared memory per qp: X, z, h and the staged H_q
constexpr int HESS_SM = 2 * NJ + 1 + HQ;

// Reference-state quantities of one qp (independent of d): the metric a,
// the curvature b, the SVK form's matrix M (quad_form(Aup, s) = s^T M s,
// stored 00, 01, 02, 11, 12, 22) and J w.
struct RefQp {
  double a[3], b[3], M[6], Jw;
};

__device__ void ref_qp(const double* X, double E, double nu, double wq,
                       RefQp& r) {
  const double* A1 = X;
  const double* A2 = X + 3;
  double A3[3];
  cross3(A1, A2, A3);
  double J = dsqrt(dot3(A3, A3));
  A3[0] = A3[0] / J;
  A3[1] = A3[1] / J;
  A3[2] = A3[2] / J;
  r.a[0] = dot3(A1, A1);
  r.a[1] = dot3(A1, A2);
  r.a[2] = dot3(A2, A2);
  r.b[0] = dot3(X + 6, A3);
  r.b[1] = dot3(X + 9, A3);
  r.b[2] = dot3(X + 12, A3);
  double det = r.a[0] * r.a[2] - r.a[1] * r.a[1];
  double A[3] = {r.a[2] / det, -r.a[1] / det, r.a[0] / det};
  double c = E / (1.0 - nu * nu);
  // quad_form = c [nu (t.s)^2 + (1 - nu) s^T F s], t = (A0, 2 A1, A2)
  double t[3] = {A[0], 2.0 * A[1], A[2]};
  double F[6] = {A[0] * A[0], 2.0 * A[0] * A[1], A[1] * A[1],
                 2.0 * (A[1] * A[1] + A[0] * A[2]), 2.0 * A[1] * A[2],
                 A[2] * A[2]};
  r.M[0] = c * (nu * (t[0] * t[0]) + (1.0 - nu) * F[0]);
  r.M[1] = c * (nu * (t[0] * t[1]) + (1.0 - nu) * F[1]);
  r.M[2] = c * (nu * (t[0] * t[2]) + (1.0 - nu) * F[2]);
  r.M[3] = c * (nu * (t[1] * t[1]) + (1.0 - nu) * F[3]);
  r.M[4] = c * (nu * (t[1] * t[2]) + (1.0 - nu) * F[4]);
  r.M[5] = c * (nu * (t[2] * t[2]) + (1.0 - nu) * F[5]);
  r.Jw = J * wq;
}

// y = M s for the symmetric M of RefQp
template <class S>
__device__ void sym3_apply(const double* M, const S* s, S* y) {
  y[0] = M[0] * s[0] + M[1] * s[1] + M[2] * s[2];
  y[1] = M[1] * s[0] + M[3] * s[1] + M[4] * s[2];
  y[2] = M[2] * s[0] + M[4] * s[1] + M[5] * s[2];
}

// g = d(psi J w)/dz by a hand-written reverse sweep of shell_density, at
// the current first jets xm = X[0:6] + z[0:6] (scalar type S: a tangent
// in m is carried through) and second jets xs = X[6:15] + z[6:15] (plain
// doubles: psi is linear in them through bc). Also returns a3.
template <class S>
__device__ void density_grad(const S* xm, const double* xs, double h,
                             const RefQp& r, S* g, S* a3) {
  S n[3];
  cross3(xm, xm + 3, n);
  S ln = dsqrt(dot3(n, n));
  a3[0] = n[0] / ln;
  a3[1] = n[1] / ln;
  a3[2] = n[2] / ln;
  S eps[3] = {0.5 * (dot3(xm, xm) - r.a[0]),
              0.5 * (dot3(xm, xm + 3) - r.a[1]),
              0.5 * (dot3(xm + 3, xm + 3) - r.a[2])};
  S kap[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    kap[i] = r.b[i] - (a3[0] * xs[3 * i] + a3[1] * xs[3 * i + 1] +
                       a3[2] * xs[3 * i + 2]);
  // adjoints: psi = h/2 eps^T M eps + h^3/24 kap^T M kap, times J w
  S acb[3], bcb[3];
  sym3_apply(r.M, eps, acb);
  sym3_apply(r.M, kap, bcb);
  double ce = 0.5 * r.Jw * h, ck = -r.Jw * (h * h * h) / 12.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acb[i] = ce * acb[i];   // d/d(ac_i)
    bcb[i] = ck * bcb[i];   // d/d(bc_i)
  }
  // bc_i = xs_i . a3
  S a3b[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g[6 + 3 * i + x] = bcb[i] * a3[x];
    a3b[x] = bcb[0] * xs[x] + bcb[1] * xs[3 + x] + bcb[2] * xs[6 + x];
  }
  // a3 = n / |n|: nb = (a3b - (a3b . a3) a3) / |n|
  S pr = dot3(a3b, a3);
  S nb[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) nb[x] = (a3b[x] - pr * a3[x]) / ln;
  // n = x_u x x_v; ac = (x_u.x_u, x_u.x_v, x_v.x_v)
  S cu[3], cv[3];
  cross3(xm + 3, nb, cu);
  cross3(nb, xm, cv);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g[x] = 2.0 * (acb[0] * xm[x]) + acb[1] * xm[3 + x] + cu[x];
    g[3 + x] = acb[1] * xm[x] + 2.0 * (acb[2] * xm[3 + x]) + cv[x];
  }
}

// one block holds `epb` whole elements: blockDim = 6 Q epb, thread
// 6 qq + k is column k of the block's qp qq
__global__ void shell_hess(Args a, double* H, int epb) {
  extern __shared__ double sm[];
  const int nqb = epb * a.Q;
  double* sX = sm;               // (nqb, 15)
  double* sZ = sX + nqb * NJ;    // (nqb, 15)
  double* sH = sZ + nqb * NJ;    // (nqb, 225): the block's output rows
  double* sh = sH + nqb * HQ;    // (nqb,)
  const size_t nqp = size_t(a.P) * a.Ne * a.Q;
  const size_t q0 = size_t(blockIdx.x) * nqb;
  const int nact = int(nqp - q0 < size_t(nqb) ? nqp - q0 : nqb);
  const int qq = threadIdx.x / NM, k = threadIdx.x % NM;
  const bool active = qq < nact;
  const int qi = int(q0) + qq;
  const int ei = qi / a.Q, p = ei / a.Ne;
  if (active) {
    if (k < 5) {
      // the jet through R_(k+1) of the geometry and the displacement
      const double* Rk = k == 0 ? a.R[1] : k == 1 ? a.R[2]
                       : k == 2 ? a.R[3] : k == 3 ? a.R[4] : a.R[5];
      double x0 = 0.0, x1 = 0.0, x2 = 0.0, z0 = 0.0, z1 = 0.0, z2 = 0.0;
      for (int l = 0; l < a.L; ++l) {
        double r = Rk[size_t(qi) * a.L + l];
        size_t c = (size_t(p) * a.C + a.conn[size_t(ei) * a.L + l]) * 3;
        x0 += r * a.cp[c];
        x1 += r * a.cp[c + 1];
        x2 += r * a.cp[c + 2];
        z0 += r * a.d[c];
        z1 += r * a.d[c + 1];
        z2 += r * a.d[c + 2];
      }
      double* X = sX + qq * NJ + 3 * k;
      double* Z = sZ + qq * NJ + 3 * k;
      X[0] = x0; X[1] = x1; X[2] = x2;
      Z[0] = z0; Z[1] = z1; Z[2] = z2;
    } else {
      sh[qq] = gather_h(a, p, ei, qi);
    }
  }
  __syncthreads();
  if (active) {
    typedef Dual<double, 1> T;
    const double* X = sX + qq * NJ;
    const double* Z = sZ + qq * NJ;
    RefQp r;
    ref_qp(X, a.E[p], a.nu[p], a.wq[qi], r);
    T xm[NM];
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      xm[i] = T(X[i] + Z[i]);
      xm[i].g[0] = i == k ? 1.0 : 0.0;
    }
    double xs[NJ - NM];
#pragma unroll
    for (int i = 0; i < NJ - NM; ++i) xs[i] = X[NM + i] + Z[NM + i];
    const double hq = sh[qq];
    T g[NJ], a3[3];
    density_grad(xm, xs, hq, r, g, a3);
    // row k (H_mm, H_ms) and, below the first 6 rows, column k (H_sm)
    double* Hq = sH + qq * HQ;
#pragma unroll
    for (int b = 0; b < NJ; ++b) Hq[k * NJ + b] = g[b].g[0];
#pragma unroll
    for (int b = NM; b < NJ; ++b) Hq[b * NJ + k] = g[b].g[0];
    // H_ss = Hc (x) a3 a3^T, Hc = J w h^3/12 M; 81 entries over 6 threads
    // (unrolled, so that M and a3 are indexed by constants: registers)
    const double ck = r.Jw * (hq * hq * hq) / 12.0;
#pragma unroll
    for (int e = 0; e < 81; ++e) {
      if (e % NM != k) continue;
      const int rr = e / 9, ss = e % 9;
      const int i = rr / 3, x = rr % 3, j = ss / 3, y = ss % 3;
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      const int m = lo == 0 ? hi : lo == 1 ? hi + 2 : 5;
      Hq[(NM + rr) * NJ + NM + ss] = ck * r.M[m] * a3[x].v * a3[y].v;
    }
  }
  __syncthreads();
  double* out = H + q0 * HQ;
  for (int e = threadIdx.x; e < nact * HQ; e += blockDim.x) out[e] = sH[e];
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
    // whole elements a block, ~128 threads: 6 per qp
    if (NM * Q > 1024) return static_cast<int>(cudaErrorInvalidValue);
    int epb = NM * Q >= 128 ? 1 : 128 / (NM * Q);
    size_t smem = size_t(epb) * Q * HESS_SM * sizeof(double);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(
          shell_hess, cudaFuncAttributeMaxDynamicSharedMemorySize,
          int(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    size_t nb = (size_t(P) * Ne + epb - 1) / epb;
    shell_hess<<<unsigned(nb), NM * Q * epb, smem, s>>>(a, out_f, epb);
  } else if (mode == 2) {
    shell_adjoint<<<unsigned((nqp + 127) / 128), 128, 0, s>>>(a, out_f, out_h);
  } else if (mode == 3) {
    shell_geom_grad<<<unsigned((nqp + 127) / 128), 128, 0, s>>>(a, out_f);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
