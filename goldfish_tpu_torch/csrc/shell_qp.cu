// K1 shell_qp: Kirchhoff-Love shell (St. Venant-Kirchhoff) energy at every
// shell quadrature point, with its derivatives by hand-written reverse
// sweeps.
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
// Every mode gathers an element's control points, displacements and
// thickness through the six basis rows into the midsurface jets
//   X, z = (d/du, d/dv, d2/du2, d2/dudv, d2/dv2) of the geometry and of the
//   displacement (15 numbers each), h_q = R00 . h_e,
// and differentiates psi * J * w by a hand-written reverse sweep of the
// density (`density_grad`, `shell_sweep`), carrying at most a
// Dual<double, 1> tangent.
//
// Modes:
//   0 value+grad: per-element energy (deterministic in-block sum over the
//     element's qps), r_shell = dW/dd (P,C,3) and dW/dh (P,C);
//   1 hess: H_q = d2(psi J w)/dz2, (P,E,Q,15,15), structured (below);
//   2 adjoint: given lambda (P,C,3), -d/d(cp,h) of lambda^T r_shell into
//     (P,C,3) and (P,C);
//   3 geometry gradient: dW/dcp (P,C,3), the energy's direct dependence on
//     the control points (shape optimization; kl_shell.internal_energy's
//     gradient w.r.t. cp in the JAX package);
//   4 design tangent: given tcp (P,C,3) and th (P,C), d/de of r_shell(cp +
//     e tcp, h + e th) into (P,C,3) (the forward design product of the
//     residual; jax.jvp of the residual in (cp, h) in the JAX package's
//     operations/disp_imop.py).
//
// Mode 1, the structured jet Hessian. Split z = (m, s): m = (x_u, x_v) the
// 6 first-jet components, s = (x_uu, x_uv, x_vv) the 9 second-jet ones.
// s enters psi only through bc_i = (X_i + s_i) . a3, linearly, and a3 and
// the metric depend on m alone, so the s-s block is closed form,
//   H_ss = Hc (x) a3 a3^T,  Hc = J w h^3/12 M  (psi's bending part is
//   h^3/24 kap^T M kap with M the SVK form's 3x3 matrix),
// and only the 6 columns d(grad psi)/dm_k take derivatives: each is one
// forward tangent (Dual<double, 1>) through `density_grad`, a hand-written
// reverse sweep of the density (kl_shell.shell_density is its plain
// version); H_ms = H_sm^T. One block holds whole
// elements, 6 threads a qp (one a column). The block gathers each qp's X,
// z and h once into shared memory (thread k of a qp: the jet through
// R_(k+1), thread 5: h), and stages the 225 outputs of every qp there, so
// the store of the block's contiguous H rows is coalesced.
//
// Modes 0, 2, 3, 4 (`shell_sweep`): mode 0 sweeps back in plain doubles
// with dpsi/dh in closed form; mode 3 carries the sweep on through the
// reference quantities (a, b, Aup in M, J, A3) to X; mode 2 does the same
// with lambda's jets as the tangent of z (Dual<double, 1>), so the tangent
// of the X-gradient is (d^2 F / dX dz) lambda, about 7 density evaluations
// a qp in place of the 34 of the Dual<Dual<double, 1>, 16> pass it
// replaced; mode 4 runs mode 0's sweep with X's jets and h in
// Dual<double, 1>, seeded with tcp's jets and th (z carries no tangent),
// so the tangent of the z-gradient is (d^2 F / dz dX) tX + (d^2 F / dz dh)
// th, scattered as mode 0 scatters the gradient.
// A block holds whole elements (at most 64 qps); its 128 threads gather the
// jets into shared memory (one (qp, basis row) a task), sweep one qp each,
// then sum B^T g over each element's qps in a fixed order and add it with
// one f64 atomic per (element, local node, component), Q times fewer than
// a per-qp scatter.
//
// What bounds it on the H100: bytes. Mode 1 writes 1800 B a qp (32 MB at
// wing20) and reads the five R rows and R00 (6 L doubles a qp): 46.4 MB at
// wing20, 0.0138 ms at 3.35 TB/s; its arithmetic (~8,400 f64 operations a
// qp) is a third of that at the f64 rate. The earlier one-thread-per-column
// Dual<Dual<double,15>,1> form spilled ~4.5 KB a thread to local memory
// and took 1.08 ms at wing20; a column thread now takes 128 registers and
// spills nothing, and the kernel takes 0.035 ms, 2.5x its byte bound (NVIDIA
// H100 80GB HBM3, 700 W; scripts/torch_port_kernel_ab.py, PERF.md).
#include <type_traits>

#include "dual.cuh"

namespace gf {
namespace {

constexpr int NJ = 15;  // jet components: 5 derivatives x 3 coordinates

struct Args {
  const double* R[6];  // R00, R10, R01, R20, R11, R02: (P, E, Q, L)
  const int* conn;     // (P, E, L)
  const double* wq;    // (P, E, Q)
  const double* d;     // (P, C, 3)
  const double* cp;    // (P, C, 3)
  const double* h;     // (P, C)
  const double* E;     // (P,)
  const double* nu;    // (P,)
  const double* lam;   // (P, C, 3): lambda (mode 2), tcp (mode 4)
  const double* th;    // (P, C), mode 4 only
  int P, Ne, Q, L, C;
};

// R00 . c_e at qp qi of element ei of patch p for a (P, C) field c
__device__ double gather_h(const Args& a, int p, int ei, int qi,
                           const double* c) {
  double s = 0.0;
  for (int l = 0; l < a.L; ++l)
    s += a.R[0][size_t(qi) * a.L + l] *
         c[size_t(p) * a.C + a.conn[size_t(ei) * a.L + l]];
  return s;
}

// ---------------------------------------------------------------- mode 1
constexpr int NM = 6;          // first-jet components m = (x_u, x_v)
constexpr int HQ = NJ * NJ;    // outputs per qp
// doubles of shared memory per qp: X, z, h and the staged H_q
constexpr int HESS_SM = 2 * NJ + 1 + HQ;

// Reference-state quantities of one qp (independent of d): the metric a,
// the curvature b, the SVK form's matrix M (quad_form(Aup, s) = s^T M s,
// stored 00, 01, 02, 11, 12, 22) and J w; R = double, or Dual<double, 1>
// carrying a design tangent (mode 4).
template <class R>
struct RefQpT {
  R a[3], b[3], M[6], Jw;
};
typedef RefQpT<double> RefQp;

template <class R>
__device__ void ref_qp(const R* X, double E, double nu, double wq,
                       RefQpT<R>& r) {
  const R* A1 = X;
  const R* A2 = X + 3;
  R A3[3];
  cross3(A1, A2, A3);
  R J = dsqrt(dot3(A3, A3));
  A3[0] = A3[0] / J;
  A3[1] = A3[1] / J;
  A3[2] = A3[2] / J;
  r.a[0] = dot3(A1, A1);
  r.a[1] = dot3(A1, A2);
  r.a[2] = dot3(A2, A2);
  r.b[0] = dot3(X + 6, A3);
  r.b[1] = dot3(X + 9, A3);
  r.b[2] = dot3(X + 12, A3);
  R det = r.a[0] * r.a[2] - r.a[1] * r.a[1];
  R A[3] = {r.a[2] / det, -r.a[1] / det, r.a[0] / det};
  double c = E / (1.0 - nu * nu);
  // quad_form = c [nu (t.s)^2 + (1 - nu) s^T F s], t = (A0, 2 A1, A2)
  R t[3] = {A[0], 2.0 * A[1], A[2]};
  R F[6] = {A[0] * A[0], 2.0 * A[0] * A[1], A[1] * A[1],
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
template <class R, class S>
__device__ void sym3_apply(const R* M, const S* s, S* y) {
  y[0] = M[0] * s[0] + M[1] * s[1] + M[2] * s[2];
  y[1] = M[1] * s[0] + M[3] * s[1] + M[4] * s[2];
  y[2] = M[2] * s[0] + M[4] * s[1] + M[5] * s[2];
}

// g = d(psi J w)/dz by a hand-written reverse sweep of the density, at
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
      sh[qq] = gather_h(a, p, ei, qi, a.h);
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

// ------------------------------------------------------- modes 0, 2, 3
// psi J w at one qp and its derivatives by a hand-written reverse sweep:
// X the reference jets, z the displacement jets (scalar type S; mode 2
// carries lambda's jets as their tangent), h the thickness. Out: val = psi
// J w, gh = its h-derivative, J w (1/2 eps^T M eps + h^2/8 kap^T M kap),
// and g (15) = its z-gradient, the same sweep as `density_grad`; with GEO
// g is instead its X-gradient: the z-gradient (x = X + z) plus the sweep
// back through the reference quantities a, b, Aup (in M), J and A3. X and
// h are of type R: double, or (mode 4, with S = R = Dual<double, 1> and
// not GEO) carrying a design tangent.
template <class S, bool GEO, class R = double>
__device__ void shell_sweep(const R* X, const S* z, R h, double E,
                            double nu, double wq, S& val, S* g, S& gh) {
  static_assert(!GEO || std::is_same<R, double>::value,
                "the geometry sweep takes plain reference jets");
  RefQpT<R> r;
  ref_qp(X, E, nu, wq, r);
  S xm[NM], xs[NJ - NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) xm[i] = z[i] + X[i];
#pragma unroll
  for (int i = 0; i < NJ - NM; ++i) xs[i] = z[NM + i] + X[NM + i];
  S n[3], a3[3];
  cross3(xm, xm + 3, n);
  S ln = dsqrt(dot3(n, n));
#pragma unroll
  for (int x = 0; x < 3; ++x) a3[x] = n[x] / ln;
  // the strains in the plain version's form: eps = (x . x - A . A) / 2
  S eps[3] = {0.5 * (dot3(xm, xm) - r.a[0]),
              0.5 * (dot3(xm, xm + 3) - r.a[1]),
              0.5 * (dot3(xm + 3, xm + 3) - r.a[2])};
  S kap[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    kap[i] = r.b[i] - (a3[0] * xs[3 * i] + a3[1] * xs[3 * i + 1] +
                       a3[2] * xs[3 * i + 2]);
  S acb[3], bcb[3];
  sym3_apply(r.M, eps, acb);
  sym3_apply(r.M, kap, bcb);
  const S qe = dot3(eps, acb), qk = dot3(kap, bcb);
  const R h3 = h * h * h;
  const S psi = (0.5 * h) * qe + (h3 / 24.0) * qk;
  val = psi * r.Jw;
  gh = r.Jw * (0.5 * qe + ((h * h) / 8.0) * qk);
  const R ce = 0.5 * r.Jw * h, ck = -r.Jw * h3 / 12.0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acb[i] = ce * acb[i];   // d/d(ac_i)
    bcb[i] = ck * bcb[i];   // d/d(bc_i)
  }
  // bc_i = xs_i . a3; a3 = n / |n|; n = x_u x x_v; ac = (x_u.x_u, ...)
  S a3b[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g[6 + 3 * i + x] = bcb[i] * a3[x];
    a3b[x] = bcb[0] * xs[x] + bcb[1] * xs[3 + x] + bcb[2] * xs[6 + x];
  }
  S nb[3], cu[3], cv[3];
  unit3_rev(a3, ln, a3b, nb);
  cross3(xm + 3, nb, cu);
  cross3(nb, xm, cv);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g[x] = 2.0 * (acb[0] * xm[x]) + acb[1] * xm[3 + x] + cu[x];
    g[3 + x] = acb[1] * xm[x] + 2.0 * (acb[2] * xm[3 + x]) + cv[x];
  }
  if constexpr (GEO) {
  // The reference quantities. F = J w [h/2 eps^T M eps + h^3/24 kap^T M
  // kap], eps = (ac - a)/2, kap = b - bc: dF/da = -dF/dac, dF/db = -dF/dbc,
  // dF/dJ = psi w, and dF/dM (M stored 00 01 02 11 12 22, an off-diagonal
  // entry counted twice in s^T M s).
  const double* A1 = X;
  const double* A2 = X + 3;
  double A3[3];
  cross3(A1, A2, A3);
  const double J = sqrt(dot3(A3, A3));
#pragma unroll
  for (int x = 0; x < 3; ++x) A3[x] = A3[x] / J;
  const double det = r.a[0] * r.a[2] - r.a[1] * r.a[1];
  const double A[3] = {r.a[2] / det, -r.a[1] / det, r.a[0] / det};
  const double c = E / (1.0 - nu * nu);
  const double t[3] = {A[0], 2.0 * A[1], A[2]};
  const double he = r.Jw * 0.5 * h, hk = r.Jw * h3 / 24.0;
  S Mb[6] = {he * (eps[0] * eps[0]) + hk * (kap[0] * kap[0]),
             2.0 * (he * (eps[0] * eps[1]) + hk * (kap[0] * kap[1])),
             2.0 * (he * (eps[0] * eps[2]) + hk * (kap[0] * kap[2])),
             he * (eps[1] * eps[1]) + hk * (kap[1] * kap[1]),
             2.0 * (he * (eps[1] * eps[2]) + hk * (kap[1] * kap[2])),
             he * (eps[2] * eps[2]) + hk * (kap[2] * kap[2])};
  // M = c [nu t t^T + (1 - nu) F(A)] (ref_qp): back to A
  const double cn = c * nu, cf = c * (1.0 - nu);
  S tb0 = cn * (2.0 * t[0] * Mb[0] + t[1] * Mb[1] + t[2] * Mb[2]);
  S tb1 = cn * (t[0] * Mb[1] + 2.0 * t[1] * Mb[3] + t[2] * Mb[4]);
  S tb2 = cn * (t[0] * Mb[2] + t[1] * Mb[4] + 2.0 * t[2] * Mb[5]);
  S Ab[3];
  Ab[0] = tb0 + cf * (2.0 * A[0] * Mb[0] + 2.0 * A[1] * Mb[1] +
                      2.0 * A[2] * Mb[3]);
  Ab[1] = 2.0 * tb1 + cf * (2.0 * A[0] * Mb[1] + 2.0 * A[1] * Mb[2] +
                            4.0 * A[1] * Mb[3] + 2.0 * A[2] * Mb[4]);
  Ab[2] = tb2 + cf * (2.0 * A[0] * Mb[3] + 2.0 * A[1] * Mb[4] +
                      2.0 * A[2] * Mb[5]);
  // A = (a2, -a1, a0) / det, det = a0 a2 - a1^2; and a's part in eps
  S detb = -(Ab[0] * A[0] + Ab[1] * A[1] + Ab[2] * A[2]) / det;
  S ab0 = Ab[2] / det + detb * r.a[2] - acb[0];
  S ab1 = -(Ab[1] / det) - 2.0 * (detb * r.a[1]) - acb[1];
  S ab2 = Ab[0] / det + detb * r.a[0] - acb[2];
  // b_i = X_s,i . A3 (dF/db_i = -bcb_i); A3 = n0 / J, J = |n0|
  S A3b[3], n0b[3];
#pragma unroll
  for (int x = 0; x < 3; ++x) {
#pragma unroll
    for (int i = 0; i < 3; ++i) g[6 + 3 * i + x] = g[6 + 3 * i + x] - bcb[i] * A3[x];
    A3b[x] = -(bcb[0] * X[6 + x] + bcb[1] * X[9 + x] + bcb[2] * X[12 + x]);
  }
  const S Jb = psi * wq;
  unit3_rev(A3, J, A3b, n0b);
#pragma unroll
  for (int x = 0; x < 3; ++x) n0b[x] = n0b[x] + Jb * A3[x];
  // n0 = A1 x A2: A1 += A2 x n0b, A2 -= A1 x n0b; a = (A1.A1, A1.A2, A2.A2)
  cross3_mixed(A2, n0b, cu);
  cross3_mixed(A1, n0b, cv);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    g[x] = g[x] + 2.0 * (ab0 * A1[x]) + ab1 * A2[x] + cu[x];
    g[3 + x] = g[3 + x] + ab1 * A1[x] + 2.0 * (ab2 * A2[x]) - cv[x];
  }
  }
}

constexpr int GQB = 64;    // qps a block at most (whole elements), modes 0/2/3
constexpr int GTH = 128;   // threads a block: with the sweep's 100-240
                           // registers a thread, 2-4 blocks an SM

// doubles of shared memory a qp: X, z, g, h, gh, value (and in mode 2
// lambda's z; in mode 4 tcp's jets and th)
constexpr int GRAD_SM = 3 * NJ + 3;

// Modes 0, 2, 3, 4: `epb` whole elements a block. The block gathers its qps'
// jets into shared memory (one (qp, basis row) a task), sweeps each qp
// (one a thread), then sums B^T g over each element's qps in a fixed order
// and adds it with one f64 atomic per (element, local node, component).
template <int MODE>
__device__ void grad_block(const Args& a, int epb, double* W, double* out_f,
                           double* out_h) {
  extern __shared__ double sm[];
  const int nqb = epb * a.Q;
  double* sX = sm;                                  // (nqb, 15)
  double* sZ = sX + nqb * NJ;                       // (nqb, 15)
  double* sG = sZ + nqb * NJ;                       // (nqb, 15)
  double* sh = sG + nqb * NJ;                       // (nqb,)
  double* sGh = sh + nqb;                           // (nqb,)
  double* sV = sGh + nqb;                           // (nqb,)
  double* sL = sV + nqb;                            // (nqb, 15), modes 2, 4
  double* sTh = sL + nqb * NJ;                      // (nqb,), mode 4
  const int e0 = blockIdx.x * epb;
  const int ne = min(epb, a.P * a.Ne - e0);
  const int nq = ne * a.Q;
  const size_t q0 = size_t(e0) * a.Q;
  for (int task = threadIdx.x; task < 6 * nq; task += blockDim.x) {
    const int qq = task / 6, k = task % 6;
    const int qi = int(q0) + qq, ei = qi / a.Q, p = ei / a.Ne;
    if (k == 5) {
      sh[qq] = gather_h(a, p, ei, qi, a.h);
      if (MODE == 4) sTh[qq] = gather_h(a, p, ei, qi, a.th);
      continue;
    }
    // the jet through R_(k+1) of the geometry, the displacement and lambda
    const double* Rk = (k == 0 ? a.R[1] : k == 1 ? a.R[2] : k == 2 ? a.R[3]
                        : k == 3 ? a.R[4] : a.R[5]) + size_t(qi) * a.L;
    const int* conn = a.conn + size_t(ei) * a.L;
    double x[3] = {0.0, 0.0, 0.0}, z[3] = {0.0, 0.0, 0.0},
           l[3] = {0.0, 0.0, 0.0};
#pragma unroll 4
    for (int j = 0; j < a.L; ++j) {
      const double r = Rk[j];
      const size_t c = (size_t(p) * a.C + conn[j]) * 3;
#pragma unroll
      for (int y = 0; y < 3; ++y) {
        x[y] += r * a.cp[c + y];
        z[y] += r * a.d[c + y];
        if (MODE == 2 || MODE == 4) l[y] += r * a.lam[c + y];
      }
    }
#pragma unroll
    for (int y = 0; y < 3; ++y) {
      sX[qq * NJ + 3 * k + y] = x[y];
      sZ[qq * NJ + 3 * k + y] = z[y];
      if (MODE == 2 || MODE == 4) sL[qq * NJ + 3 * k + y] = l[y];
    }
  }
  __syncthreads();
  for (int qq = threadIdx.x; qq < nq; qq += blockDim.x) {
    const int qi = int(q0) + qq, p = qi / a.Q / a.Ne;
    const double* X = sX + qq * NJ;
    double* G = sG + qq * NJ;
    if (MODE == 2) {
      typedef Dual<double, 1> T;
      T z[NJ], g[NJ], val, gh;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        z[i] = T(sZ[qq * NJ + i]);
        z[i].g[0] = sL[qq * NJ + i];
      }
      shell_sweep<T, true>(X, z, sh[qq], a.E[p], a.nu[p], a.wq[qi], val, g,
                           gh);
#pragma unroll
      for (int i = 0; i < NJ; ++i) G[i] = g[i].g[0];
      sGh[qq] = gh.g[0];
    } else if (MODE == 4) {
      // X and h carry the design tangent (tcp's jets, th), z none
      typedef Dual<double, 1> T;
      T Xt[NJ], z[NJ], g[NJ], val, gh;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        Xt[i] = T(X[i]);
        Xt[i].g[0] = sL[qq * NJ + i];
        z[i] = T(sZ[qq * NJ + i]);
      }
      T hq(sh[qq]);
      hq.g[0] = sTh[qq];
      shell_sweep<T, false, T>(Xt, z, hq, a.E[p], a.nu[p], a.wq[qi], val, g,
                               gh);
#pragma unroll
      for (int i = 0; i < NJ; ++i) G[i] = g[i].g[0];
    } else {
      double val, gh;
      shell_sweep<double, MODE == 3>(X, sZ + qq * NJ, sh[qq], a.E[p],
                                     a.nu[p], a.wq[qi], val, G, gh);
      sGh[qq] = gh;
      sV[qq] = val;
    }
  }
  __syncthreads();
  const double sign = MODE == 2 ? -1.0 : 1.0;
  for (int task = threadIdx.x; task < ne * a.L; task += blockDim.x) {
    const int e = task / a.L, l = task % a.L, ei = e0 + e;
    const size_t node =
        size_t(ei / a.Ne) * a.C + a.conn[size_t(ei) * a.L + l];
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
    for (int q = 0; q < a.Q; ++q) {
      const int qq = e * a.Q + q;
      const size_t o = (q0 + qq) * a.L + l;
      const double* G = sG + qq * NJ;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        const double r = a.R[j + 1][o];
        acc[0] += r * G[3 * j];
        acc[1] += r * G[3 * j + 1];
        acc[2] += r * G[3 * j + 2];
      }
      if (MODE == 0 || MODE == 2) acc[3] += a.R[0][o] * sGh[qq];
    }
#pragma unroll
    for (int y = 0; y < 3; ++y) atomicAdd(out_f + node * 3 + y, sign * acc[y]);
    if (MODE == 0 || MODE == 2) atomicAdd(out_h + node, sign * acc[3]);
  }
  if (MODE == 0) {
    for (int e = threadIdx.x; e < ne; e += blockDim.x) {
      double s = 0.0;
      for (int q = 0; q < a.Q; ++q) s += sV[e * a.Q + q];
      W[e0 + e] = s;
    }
  }
}

// one signature for the three modes: (W, out_f, out_h) as each needs them
__global__ void shell_value_grad(Args a, int epb, double* W, double* r,
                                 double* dh) {
  grad_block<0>(a, epb, W, r, dh);
}

__global__ void shell_adjoint(Args a, int epb, double*, double* dcp,
                              double* dh) {
  grad_block<2>(a, epb, nullptr, dcp, dh);
}

__global__ void shell_geom_grad(Args a, int epb, double*, double* dcp,
                                double*) {
  grad_block<3>(a, epb, nullptr, dcp, nullptr);
}

__global__ void shell_design_jvp(Args a, int epb, double*, double* dr,
                                 double*) {
  grad_block<4>(a, epb, nullptr, dr, nullptr);
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

extern "C" int gf_shell_qp(int mode, const double* R00, const double* R10,
                           const double* R01, const double* R20,
                           const double* R11, const double* R02,
                           const int* conn, const double* wq, const double* d,
                           const double* cp, const double* h, const double* E,
                           const double* nu, const double* lam,
                           const double* th, double* out_w,
                           double* out_f, double* out_h, int P, int Ne, int Q,
                           int L, int C, void* stream) {
  using namespace gf;
  Args a{{R00, R10, R01, R20, R11, R02}, conn, wq, d, cp, h, E, nu, lam, th,
         P, Ne, Q, L, C};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  size_t nqp = size_t(P) * Ne * Q;
  if (nqp == 0) return 0;
  if (Q > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (mode == 0 || mode == 2 || mode == 3 || mode == 4) {
    void (*kernel)(Args, int, double*, double*, double*) =
        mode == 0 ? shell_value_grad : mode == 2 ? shell_adjoint
                    : mode == 3 ? shell_geom_grad : shell_design_jvp;
    const int epb = Q >= GQB ? 1 : GQB / Q;
    const int extra = mode == 2 ? NJ : mode == 4 ? NJ + 1 : 0;
    const size_t smem = size_t(epb) * Q * (GRAD_SM + extra) * sizeof(double);
    int e = allow_smem(kernel, smem);
    if (e != 0) return e;
    const unsigned nb = unsigned((size_t(P) * Ne + epb - 1) / epb);
    kernel<<<nb, GTH, smem, s>>>(a, epb, out_w, out_f, out_h);
  } else if (mode == 1) {
    // whole elements a block, ~128 threads: 6 per qp
    if (NM * Q > 1024) return static_cast<int>(cudaErrorInvalidValue);
    int epb = NM * Q >= 128 ? 1 : 128 / (NM * Q);
    size_t smem = size_t(epb) * Q * HESS_SM * sizeof(double);
    int e = allow_smem(shell_hess, smem);
    if (e != 0) return e;
    size_t nb = (size_t(P) * Ne + epb - 1) / epb;
    shell_hess<<<unsigned(nb), NM * Q * epb, smem, s>>>(a, out_f, epb);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}
