// The padded SurfSet of ops/bspline_traced.py on the device, for the
// closed-form basis rows of bspline_rows.cuh (K5, K6, K7).
//
// Span rule of those rows: bit for bit `_find_span` of bspline_jax.py,
// i.e. searchsorted(span_starts, u, side="right") - 1, clipped to the
// valid spans. A point exactly on an interior knot takes the span that
// starts there, a point at the domain's end the last valid span. The
// T-beam seam lies on the flange's knot xi_u = 0.5, so another tie rule
// would change conn (and the Woodbury seam subspace built from it).
#pragma once

#include "dual.cuh"

namespace gf {

constexpr int PMAX = 3;  // largest degree taken

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

}  // namespace gf
