// Traced NURBS surface bases at a Dual xi (K6), and the padded SurfSet.
//
// Device counterpart of goldfish_tpu/ops/bspline_jax.py and of the port's
// ops/bspline_traced.py: knot-span search over the valid-span starts of a
// padded SurfSet, the Cox-de Boor value recursion (Piegl & Tiller A2.2) and
// the rational basis R = w N / sum(w N), all templated on the scalar type.
// Evaluated at a Dual xi they give exact xi-derivatives of any order the
// nesting asks for, as jax.jacfwd does through bspline_jax.
//
// Span rule: bit for bit `_find_span` of bspline_jax.py, i.e.
// searchsorted(span_starts, u, side="right") - 1, clipped to the valid
// spans. A point exactly on an interior knot takes the span that starts
// there, a point at the domain's end the last valid span. The T-beam seam
// lies on the flange's knot xi_u = 0.5, so another tie rule would change
// conn (and the Woodbury seam subspace built from it).
#pragma once

#include "dual.cuh"

namespace gf {

constexpr int PMAX = 3;                        // largest degree taken
constexpr int LMAX = (PMAX + 1) * (PMAX + 1);  // largest local basis

// Padded per-patch NURBS data (SurfSet of ops/bspline_traced.py).
struct SurfSetArgs {
  const double* knots_u;  // (P, Ku)
  const double* knots_v;  // (P, Kv)
  const double* su_vals;  // (P, Su) start knot of each valid span, +inf pad
  const int* su_ids;      // (P, Su)
  const double* sv_vals;  // (P, Sv)
  const int* sv_ids;      // (P, Sv)
  const double* w;        // (P, C) weights (1.0 on padding)
  const int* n_v;         // (P,)
  int Ku, Kv, Su, Sv, C, p, q;
};

__device__ inline int find_span(const double* vals, const int* ids, int n,
                                double u) {
  int k = 0;
  for (int i = 0; i < n; ++i) k += vals[i] <= u ? 1 : 0;
  k -= 1;
  k = k < 0 ? 0 : (k > n - 1 ? n - 1 : k);
  return ids[k];
}

// the p + 1 nonzero B-spline values at u in knot span `span`
template <class S>
__device__ void basis_values(const double* knots, int p, int span, const S& u,
                             S* N) {
  S left[PMAX + 1], right[PMAX + 1];
  N[0] = S(1.0);
  for (int j = 1; j <= p; ++j) {
    left[j] = u - knots[span + 1 - j];
    right[j] = knots[span + j] - u;
    S saved(0.0);
    for (int r = 0; r < j; ++r) {
      S temp = N[r] / (right[r + 1] + left[j - r]);
      N[r] = saved + right[r + 1] * temp;
      saved = left[j - r] * temp;
    }
    N[j] = saved;
  }
}

// Rational basis at (u, v) on patch ip: conn[l] = flat CP index
// (i_u * n_v + i_v) and R[l] for l = i (q + 1) + j, L = (p + 1)(q + 1).
template <class S>
__device__ void rational_rows(const SurfSetArgs& s, int ip, const S& u,
                              const S& v, int* conn, S* R) {
  const int p = s.p, q = s.q;
  const int su = find_span(s.su_vals + size_t(ip) * s.Su,
                           s.su_ids + size_t(ip) * s.Su, s.Su, value_of(u));
  const int sv = find_span(s.sv_vals + size_t(ip) * s.Sv,
                           s.sv_ids + size_t(ip) * s.Sv, s.Sv, value_of(v));
  S Nu[PMAX + 1], Nv[PMAX + 1];
  basis_values(s.knots_u + size_t(ip) * s.Ku, p, su, u, Nu);
  basis_values(s.knots_v + size_t(ip) * s.Kv, q, sv, v, Nv);
  const int nv = s.n_v[ip];
  S W(0.0);
  for (int i = 0; i <= p; ++i) {
    for (int j = 0; j <= q; ++j) {
      int l = i * (q + 1) + j;
      int c = (su - p + i) * nv + (sv - q + j);
      conn[l] = c;
      R[l] = (Nu[i] * Nv[j]) * s.w[size_t(ip) * s.C + c];
      W = W + R[l];
    }
  }
  const int L = (p + 1) * (q + 1);
  for (int l = 0; l < L; ++l) R[l] = R[l] / W;
}

}  // namespace gf
