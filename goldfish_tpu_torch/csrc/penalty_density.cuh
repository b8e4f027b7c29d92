// The Herrema-style penalty density of non-matching patch coupling at one
// interface point, shared by K2 penalty_qp (fixed intersections) and K6
// mi_penalty_xi (moving intersections).
//
// Written once as a template over the scalar type S of the geometry jets,
// displacement jets and thickness, and over the scalar type V of the curve
// tangents dxi/ds: K2 takes V = double (the tangents are constants of a
// fixed intersection), K6 takes V = S to differentiate through the tangents
// of a moving one. The same formula as physics/coupling.py:penalty_density.
#pragma once

#include "dual.cuh"

namespace gf {

constexpr int PEN_NZ = 18;  // (uA, uAu, uAv, uB, uBu, uBv) x 3
constexpr int PEN_NX = 12;  // (XAu, XAv, XBu, XBv) x 3

// w * density * dl at one interface point
template <class S, class V>
__device__ S penalty_density(const S* X, const S* z, S hA, S hB, const V* dxA,
                             const V* dxB, double E, double ad, double ar,
                             double w) {
  const S* XAu = X;
  const S* XAv = X + 3;
  const S* XBu = X + 6;
  const S* XBv = X + 9;
  const S* uA = z;
  const S* uB = z + 9;
  S h = 0.5 * (hA + hB);

  S dX[3], A3A[3], A3B[3], a3A[3], a3B[3], TB[3], tB[3], xu[3], xv[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dX[i] = XAu[i] * dxA[0] + XAv[i] * dxA[1];
  S dl = dsqrt(dot3(dX, dX));

  cross3(XAu, XAv, A3A);
  unit3(A3A);
  cross3(XBu, XBv, A3B);
  unit3(A3B);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xu[i] = XAu[i] + z[3 + i];
    xv[i] = XAv[i] + z[6 + i];
  }
  cross3(xu, xv, a3A);
  unit3(a3A);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    xu[i] = XBu[i] + z[12 + i];
    xv[i] = XBv[i] + z[15 + i];
  }
  cross3(xu, xv, a3B);
  unit3(a3B);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    TB[i] = XBu[i] * dxB[0] + XBv[i] * dxB[1];
    tB[i] = xu[i] * dxB[0] + xv[i] * dxB[1];
  }
  unit3(TB);
  unit3(tB);
  S AnB[3], anB[3];
  cross3(A3B, TB, AnB);
  cross3(a3B, tB, anB);

  S dphi = dot3(a3A, a3B) - dot3(A3A, A3B);
  S dbeta = dot3(a3A, anB) - dot3(A3A, AnB);
  S du[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) du[i] = uA[i] - uB[i];
  S du2 = dot3(du, du);

  S alpha_d = (ad * E) * h;
  S alpha_r = (ar * E) * (h * h * h) / 12.0;
  S dens = 0.5 * (alpha_d * du2) + 0.5 * (alpha_r * (dphi * dphi + dbeta * dbeta));
  return w * (dens * dl);
}

}  // namespace gf
