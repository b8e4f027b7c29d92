// A hand-written reverse sweep of the penalty density at one interface
// point, for K2 penalty_qp and K6 mi_penalty_xi.
//
//   F = w dl [1/2 alpha_d |uA - uB|^2 + 1/2 alpha_r (dphi^2 + dbeta^2)],
//   alpha_d = ad E h, alpha_r = ar E h^3 / 12, h = (hA + hB) / 2,
//   dphi = a3A . a3B - A3A . A3B,  dbeta = a3A . anB - A3A . AnB,
//   dl = |XAu dxA0 + XAv dxA1|, TB = unit(XBu dxB0 + XBv dxB1),
//   tB = unit(xBu dxB0 + xBv dxB1), AnB = A3B x TB, anB = a3B x tB
// (the same formula as physics/coupling.py:penalty_density).
//
// dl, A3A, A3B, TB and AnB depend on the geometry jets X only;
// dphi and dbeta depend on the displacement only through the 12 first-jet
// components m = (uA_u, uA_v, uB_u, uB_v), never on uA or uB. So the
// sweep runs the current-configuration part (a3A, a3B, tB, anB) forward
// and back in the scalar type S of the displacement jets z, and the
// geometry part in plain doubles. With GEO it also sweeps the geometry
// back to X (the adjoint mode): the gradient in X is then the current
// part's m-gradient plus the geometry's. With ALL (K6) one sweep returns
// every cotangent together: z's in g, X's in gX, h's in gh and the curve
// tangents' (dxA, dxB) in gdx.
//
// S = double gives the value and the gradient (mode 0). S = Dual<double,
// 1> with a tangent on z gives the tangent of the gradient: seeded with
// e_k it is column k of the Hessian (mode 1), seeded with lambda's jets
// and GEO it is (d^2 F / dX dz) lambda (mode 2); seeded with lambda's jets
// and ALL, the tangent of every cotangent y is d/dy (lambda . dF/dz) and
// the value part of g is dF/dz (K6's forward-over-reverse sweep).
//
// The geometry's inputs (X, hA, hB, dxA, dxB) are of type R: double, or,
// for the forward design tangents (K2 mode 3, K6 mode 1: S = R =
// Dual<double, 1>, not GEO), carrying the tangents of cp, h and the curve
// tangents; the tangent part of g is then the forward product
// d(dF/dz)/d(X, h, dx) applied to them (plus d2F/dz2 dz where z carries
// one).
//
// Every output carries the factor w (the adjoints start from w dl), so a
// padded point (w = 0, real geometry) gives exact zeros.
#pragma once

#include <type_traits>

#include "dual.cuh"

namespace gf {

constexpr int PEN_NZ = 18;  // (uA, uAu, uAv, uB, uBu, uBv) x 3
constexpr int PEN_NX = 12;  // (XAu, XAv, XBu, XBv) x 3

// X (12): (XAu, XAv, XBu, XBv); z (18): (uA, uAu, uAv, uB, uBu, uBv).
// Out: val = F; g (18) = dF/dz, or with GEO (12) = dF/dX in X's layout;
// gh = dF/dhA = dF/dhB. With ALL (and GEO): g (18) = dF/dz, gX (12) =
// dF/dX, gdx (4) = dF/d(dxA, dxB).
template <class S, bool GEO, bool ALL = false, class R = double>
__device__ void penalty_sweep(const R* X, const S* z, R hA, R hB,
                              const R* dxA, const R* dxB, double E, double ad,
                              double ar, double w, S& val, S* g, S& gh,
                              S* gX = nullptr, S* gdx = nullptr) {
  static_assert(GEO || !ALL, "ALL sweeps the geometry too");
  static_assert(!GEO || std::is_same<R, double>::value,
                "the geometry sweep takes plain geometry");
  const R h = 0.5 * (hA + hB);
  const R ald = (ad * E) * h;
  const R alr = (ar * E) * (h * h * h) / 12.0;
  // geometry: dl, A3A, A3B, TB, AnB
  R dX[3], A3A[3], A3B[3], TB[3], AnB[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dX[i] = X[i] * dxA[0] + X[3 + i] * dxA[1];
  const R dl = dsqrt(dot3(dX, dX));
  cross3(X, X + 3, A3A);
  const R lNA = dsqrt(dot3(A3A, A3A));
  cross3(X + 6, X + 9, A3B);
  const R lNB = dsqrt(dot3(A3B, A3B));
#pragma unroll
  for (int i = 0; i < 3; ++i) TB[i] = X[6 + i] * dxB[0] + X[9 + i] * dxB[1];
  const R lTB = dsqrt(dot3(TB, TB));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    A3A[i] = A3A[i] / lNA;
    A3B[i] = A3B[i] / lNB;
    TB[i] = TB[i] / lTB;
  }
  cross3(A3B, TB, AnB);
  // current configuration
  S xAu[3], xAv[3], xBu[3], xBv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xAu[i] = z[3 + i] + X[i];
    xAv[i] = z[6 + i] + X[3 + i];
    xBu[i] = z[12 + i] + X[6 + i];
    xBv[i] = z[15 + i] + X[9 + i];
  }
  S a3A[3], a3B[3], tB[3], anB[3];
  cross3(xAu, xAv, a3A);
  S lA = dsqrt(dot3(a3A, a3A));
  cross3(xBu, xBv, a3B);
  S lB = dsqrt(dot3(a3B, a3B));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a3A[i] = a3A[i] / lA;
    a3B[i] = a3B[i] / lB;
    tB[i] = xBu[i] * dxB[0] + xBv[i] * dxB[1];
  }
  S lT = dsqrt(dot3(tB, tB));
#pragma unroll
  for (int i = 0; i < 3; ++i) tB[i] = tB[i] / lT;
  cross3(a3B, tB, anB);
  S dphi = dot3(a3A, a3B) - dot3(A3A, A3B);
  S dbeta = dot3(a3A, anB) - dot3(A3A, AnB);
  S du[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) du[i] = z[i] - z[9 + i];
  S du2 = dot3(du, du);
  S rot = dphi * dphi + dbeta * dbeta;
  S dens = 0.5 * (ald * du2) + 0.5 * (alr * rot);
  val = w * (dens * dl);
  gh = 0.5 * ((w * dl) * (0.5 * ((ad * E) * du2) +
                          ((ar * E) * (h * h) / 8.0) * rot));
  // back: dF/ddu, dF/ddphi, dF/ddbeta
  const R K = w * dl;
  S pb = (K * alr) * dphi, bb = (K * alr) * dbeta;
  if (!GEO || ALL) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      g[i] = (K * ald) * du[i];
      g[9 + i] = -g[i];
    }
  }
  // dphi = a3A . a3B - ..., dbeta = a3A . anB - ..., anB = a3B x tB
  S a3Ab[3], a3Bb[3], anBb[3], tBb[3], vb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    a3Ab[i] = pb * a3B[i] + bb * anB[i];
    a3Bb[i] = pb * a3A[i];
    anBb[i] = bb * a3A[i];
    tBb[i] = S(0.0);
  }
  cross3_rev(a3B, tB, anBb, a3Bb, tBb);
  // the m-gradient: into g[3:9], g[12:18] (z layout) or g[0:12] (X)
  constexpr bool XL = GEO && !ALL;
  S* gAu = XL ? g : g + 3;
  S* gAv = XL ? g + 3 : g + 6;
  S* gBu = XL ? g + 6 : g + 12;
  S* gBv = XL ? g + 9 : g + 15;
  // tB = unit(xBu dxB0 + xBv dxB1)
  unit3_rev(tB, lT, tBb, vb);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gBu[i] = dxB[0] * vb[i];
    gBv[i] = dxB[1] * vb[i];
  }
  if (ALL) {
    gdx[2] = dot3(xBu, vb);
    gdx[3] = dot3(xBv, vb);
  }
  // a3B = unit(xBu x xBv)
  unit3_rev(a3B, lB, a3Bb, vb);
  cross3_rev(xBu, xBv, vb, gBu, gBv);
  // a3A = unit(xAu x xAv)
  unit3_rev(a3A, lA, a3Ab, vb);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    gAu[i] = S(0.0);
    gAv[i] = S(0.0);
  }
  cross3_rev(xAu, xAv, vb, gAu, gAv);
  if constexpr (GEO) {
    // the X-layout gradient: the m-gradient itself, or (ALL) a copy of it
    S* hAu = gAu;
    S* hAv = gAv;
    S* hBu = gBu;
    S* hBv = gBv;
    if (ALL) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        gX[i] = gAu[i];
        gX[3 + i] = gAv[i];
        gX[6 + i] = gBu[i];
        gX[9 + i] = gBv[i];
      }
      hAu = gX;
      hAv = gX + 3;
      hBu = gX + 6;
      hBv = gX + 9;
    }
    // the geometry: dphi, dbeta through A3A, A3B, AnB = A3B x TB; F
    // through dl = |XAu dxA0 + XAv dxA1|
    S A3Ab[3], A3Bb[3], AnBb[3], TBb[3], t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      A3Ab[i] = -(pb * A3B[i] + bb * AnB[i]);
      A3Bb[i] = -(pb * A3A[i]);
      AnBb[i] = -(bb * A3A[i]);
    }
    // AnB = A3B x TB: A3Bb += TB x AnBb, TBb = AnBb x A3B
    cross3_mixed(TB, AnBb, t);
    cross3_mixed(A3B, AnBb, TBb);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      A3Bb[i] = A3Bb[i] + t[i];
      TBb[i] = -TBb[i];
    }
    unit3_rev(TB, lTB, TBb, vb);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      hBu[i] = hBu[i] + dxB[0] * vb[i];
      hBv[i] = hBv[i] + dxB[1] * vb[i];
    }
    if (ALL) {
      gdx[2] = gdx[2] + (vb[0] * X[6] + vb[1] * X[7] + vb[2] * X[8]);
      gdx[3] = gdx[3] + (vb[0] * X[9] + vb[1] * X[10] + vb[2] * X[11]);
    }
    // A3B = unit(XBu x XBv): hBu += XBv x vb, hBv -= XBu x vb
    unit3_rev(A3B, lNB, A3Bb, vb);
    cross3_mixed(X + 9, vb, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) hBu[i] = hBu[i] + t[i];
    cross3_mixed(X + 6, vb, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) hBv[i] = hBv[i] - t[i];
    unit3_rev(A3A, lNA, A3Ab, vb);
    cross3_mixed(X + 3, vb, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) hAu[i] = hAu[i] + t[i];
    cross3_mixed(X, vb, t);
#pragma unroll
    for (int i = 0; i < 3; ++i) hAv[i] = hAv[i] - t[i];
    // dl: dF/ddl = w dens
    S dlb = w * dens;
    if (ALL) gdx[0] = gdx[1] = S(0.0);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      S dXb = dlb * (dX[i] / dl);
      hAu[i] = hAu[i] + dxA[0] * dXb;
      hAv[i] = hAv[i] + dxA[1] * dXb;
      if (ALL) {
        gdx[0] = gdx[0] + dXb * X[i];
        gdx[1] = gdx[1] + dXb * X[3 + i];
      }
    }
  }
}

}  // namespace gf
