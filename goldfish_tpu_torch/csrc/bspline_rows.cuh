// Rational NURBS basis rows in closed form, 16 lanes a point (K5, K6, K7).
//
// Device counterpart of goldfish_tpu/ops/bspline_jax.py (_find_span,
// _basis_values, surface_basis) and of the first and second
// xi-derivatives that goldfish_tpu/physics/coupling_mi.py takes of them
// with jax.jacfwd (the second ones through the moving intersection's
// residual VJP).
//
// Half a warp evaluates one point: lane l < L = (p + 1)(q + 1) owns the
// local basis function (i, j) = (l / (q + 1), l % (q + 1)), lanes l >= L
// carry zeros. Every lane of the warp must take part in `lane_row` (it
// ballots and shuffles over the whole warp); the two halves may evaluate
// different points of different patches.
//
// - Span: the count of valid-span starts <= u, minus 1, clipped to the
//   valid spans, gathered by ballots over the starts 16 at a time: that is
//   searchsorted(span_starts, u, side="right") - 1 of bspline_jax.py (the
//   starts are sorted and padded with +inf), bit for bit, so a point on an
//   interior knot takes the span that starts there and the domain's end
//   the last valid span. The T-beam seam lies on the knot xi_u = 0.5, where
//   another tie rule would change conn and the Woodbury seam subspace.
// - Values and first derivatives per direction: Piegl & Tiller A2.3 with
//   n = 1 in plain doubles (the value part is A2.2's recursion, operation
//   for operation), each lane evaluating all p + 1 functions of its
//   direction and keeping its own by a compare chain, so that no array is
//   indexed at run time (no stack frame).
// - The rational rows: W = sum wN, sum wN_u and sum wN_v by a 16-lane xor
//   butterfly (the same sum, bit for bit, in every lane, whatever the
//   launch), then R = wN / W and R_u = (wN_u - R W_u) / W, the quotient
//   rule of the port's plain version (ops/bspline_traced._rows_plain).
// - Second derivatives (K6, `lane_row2`): A2.3 with n = 2 (its first
//   derivatives the same operations as n = 1), the six weighted sums
//   W, W_u, W_v, W_uu, W_uv, W_vv by the same butterfly, and the quotient
//   rule's second-order terms, e.g. R_uv = (wN_uv - R_u W_v - R_v W_u -
//   R W_uv) / W. K5 and K7 keep `lane_row`.
#pragma once

#include "bspline.cuh"

namespace gf {

// one lane's share of a point: its local basis function's flat CP index
// (-1 on lanes l >= L), R, dR/du, dR/dv, and the point's knot spans
struct LaneRow {
  int conn;
  double R0, Ru, Rv;
  int su, sv;
};

__device__ __forceinline__ double half_sum(double x) {
  x += __shfl_xor_sync(0xffffffffu, x, 8, 16);
  x += __shfl_xor_sync(0xffffffffu, x, 4, 16);
  x += __shfl_xor_sync(0xffffffffu, x, 2, 16);
  x += __shfl_xor_sync(0xffffffffu, x, 1, 16);
  return x;
}

// ids[clip(#{s : vals[s] <= u} - 1)] over this lane's half-warp's point;
// CH chunks of 16 starts loaded before their ballots
template <int CH = 1>
__device__ __forceinline__ int span_ballot(const double* vals, const int* ids,
                                           int S, double u) {
  const int l = threadIdx.x & 15;
  const unsigned half = 0xffffu << (threadIdx.x & 16);
  int cnt = 0;
  for (int s0 = 0; s0 < S; s0 += 16 * CH) {
    bool le[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int k = s0 + 16 * c + l;
      le[c] = k < S && vals[k] <= u;
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
      cnt += __popc(__ballot_sync(0xffffffffu, le[c]) & half);
  }
  int k = cnt - 1;
  k = k < 0 ? 0 : (k > S - 1 ? S - 1 : k);
  return ids[k];
}

// the P + 1 nonzero B-splines of degree P at u in knot span `span` and
// their u-derivatives (Piegl & Tiller A2.3, n = 1), with D2 also the second
// ones (n = 2: the k = 2 pass of its a-array, written out)
template <int P, bool D2 = false>
__device__ __forceinline__ void basis_ders(const double* U, int span,
                                           double u, double* N, double* dN,
                                           double* d2N = nullptr) {
  double left[P + 1], right[P + 1], ndu[P + 1][P + 1];
  ndu[0][0] = 1.0;
#pragma unroll
  for (int j = 1; j <= P; ++j) {
    left[j] = u - U[span + 1 - j];
    right[j] = U[span + j] - u;
    double saved = 0.0;
#pragma unroll
    for (int r = 0; r < j; ++r) {
      ndu[j][r] = right[r + 1] + left[j - r];  // knot difference
      const double temp = ndu[r][j - 1] / ndu[j][r];
      ndu[r][j] = saved + right[r + 1] * temp;
      saved = left[j - r] * temp;
    }
    ndu[j][j] = saved;
  }
#pragma unroll
  for (int r = 0; r <= P; ++r) {
    N[r] = ndu[r][P];
    double d = 0.0;
    if (r >= 1) d += ndu[r - 1][P - 1] / ndu[P][r - 1];
    if (r <= P - 1) d -= ndu[r][P - 1] / ndu[P][r];
    dN[r] = P * d;
    if constexpr (D2) {
      double d2 = 0.0;
      if constexpr (P >= 2) {
        // the k = 1 pass: a = (1 / ndu[P][r-1], -1 / ndu[P][r])
        const double a0 = r >= 1 ? 1.0 / ndu[P][r - 1] : 0.0;
        const double a1 = r <= P - 1 ? -1.0 / ndu[P][r] : 0.0;
        if (r >= 2) d2 += (a0 / ndu[P - 1][r - 2]) * ndu[r - 2][P - 2];
        if (r >= 1 && r <= P - 1)
          d2 += ((a1 - a0) / ndu[P - 1][r - 1]) * ndu[r - 1][P - 2];
        if (r <= P - 2) d2 += (-a1 / ndu[P - 1][r]) * ndu[r][P - 2];
      }
      d2N[r] = (P * (P - 1)) * d2;
    }
  }
}

template <int P, int Q>
__device__ __forceinline__ LaneRow lane_row_pq(const SurfSetArgs& s, int ip,
                                               double u, double v) {
  constexpr int L = (P + 1) * (Q + 1);
  const int l = threadIdx.x & 15;
  LaneRow out;
  out.su = span_ballot(s.su_vals + size_t(ip) * s.Su,
                       s.su_ids + size_t(ip) * s.Su, s.Su, u);
  out.sv = span_ballot(s.sv_vals + size_t(ip) * s.Sv,
                       s.sv_ids + size_t(ip) * s.Sv, s.Sv, v);
  double Nu[P + 1], dNu[P + 1], Nv[Q + 1], dNv[Q + 1];
  basis_ders<P>(s.knots_u + size_t(ip) * s.Ku, out.su, u, Nu, dNu);
  basis_ders<Q>(s.knots_v + size_t(ip) * s.Kv, out.sv, v, Nv, dNv);
  const int i = l / (Q + 1), j = l - (l / (Q + 1)) * (Q + 1);
  double nu = 0.0, dnu = 0.0, nv = 0.0, dnv = 0.0;
#pragma unroll
  for (int t = 0; t <= P; ++t)
    if (t == i) {
      nu = Nu[t];
      dnu = dNu[t];
    }
#pragma unroll
  for (int t = 0; t <= Q; ++t)
    if (t == j) {
      nv = Nv[t];
      dnv = dNv[t];
    }
  const bool act = l < L;
  double wN0 = 0.0, wNu = 0.0, wNv = 0.0;
  out.conn = -1;
  if (act) {
    out.conn = (out.su - P + i) * s.n_v[ip] + (out.sv - Q + j);
    const double w = s.w[size_t(ip) * s.C + out.conn];
    wN0 = (nu * nv) * w;
    wNu = (dnu * nv) * w;
    wNv = (nu * dnv) * w;
  }
  const double W0 = half_sum(wN0), Wu = half_sum(wNu), Wv = half_sum(wNv);
  out.R0 = wN0 / W0;
  out.Ru = (wNu - out.R0 * Wu) / W0;
  out.Rv = (wNv - out.R0 * Wv) / W0;
  return out;
}

// the degree is uniform over a launch, so the switch does not diverge
__device__ __forceinline__ LaneRow lane_row(const SurfSetArgs& s, int ip,
                                            double u, double v) {
  switch (s.p * 4 + s.q) {
    case 5: return lane_row_pq<1, 1>(s, ip, u, v);
    case 6: return lane_row_pq<1, 2>(s, ip, u, v);
    case 7: return lane_row_pq<1, 3>(s, ip, u, v);
    case 9: return lane_row_pq<2, 1>(s, ip, u, v);
    case 10: return lane_row_pq<2, 2>(s, ip, u, v);
    case 11: return lane_row_pq<2, 3>(s, ip, u, v);
    case 13: return lane_row_pq<3, 1>(s, ip, u, v);
    case 14: return lane_row_pq<3, 2>(s, ip, u, v);
    default: return lane_row_pq<3, 3>(s, ip, u, v);
  }
}

// one lane's share of a point with the second derivatives (K6): its
// local basis function's flat CP index (-1 on lanes l >= L) and R, R_u,
// R_v, R_uu, R_uv, R_vv
struct LaneRow2 {
  int conn;
  double R0, Ru, Rv, Ruu, Ruv, Rvv;
};

template <int P, int Q>
__device__ __forceinline__ LaneRow2 lane_row2_pq(const SurfSetArgs& s,
                                                 int ip, double u,
                                                 double v) {
  constexpr int L = (P + 1) * (Q + 1);
  const int l = threadIdx.x & 15;
  const int su = span_ballot<4>(s.su_vals + size_t(ip) * s.Su,
                               s.su_ids + size_t(ip) * s.Su, s.Su, u);
  const int sv = span_ballot<4>(s.sv_vals + size_t(ip) * s.Sv,
                                s.sv_ids + size_t(ip) * s.Sv, s.Sv, v);
  double Nu[P + 1], dNu[P + 1], d2Nu[P + 1], Nv[Q + 1], dNv[Q + 1],
      d2Nv[Q + 1];
  basis_ders<P, true>(s.knots_u + size_t(ip) * s.Ku, su, u, Nu, dNu, d2Nu);
  basis_ders<Q, true>(s.knots_v + size_t(ip) * s.Kv, sv, v, Nv, dNv, d2Nv);
  const int i = l / (Q + 1), j = l - (l / (Q + 1)) * (Q + 1);
  double nu = 0.0, dnu = 0.0, d2nu = 0.0, nv = 0.0, dnv = 0.0, d2nv = 0.0;
#pragma unroll
  for (int t = 0; t <= P; ++t)
    if (t == i) {
      nu = Nu[t];
      dnu = dNu[t];
      d2nu = d2Nu[t];
    }
#pragma unroll
  for (int t = 0; t <= Q; ++t)
    if (t == j) {
      nv = Nv[t];
      dnv = dNv[t];
      d2nv = d2Nv[t];
    }
  double A0 = 0.0, Au = 0.0, Av = 0.0, Auu = 0.0, Auv = 0.0, Avv = 0.0;
  LaneRow2 out;
  out.conn = -1;
  if (l < L) {
    out.conn = (su - P + i) * s.n_v[ip] + (sv - Q + j);
    const double w = s.w[size_t(ip) * s.C + out.conn];
    A0 = (nu * nv) * w;
    Au = (dnu * nv) * w;
    Av = (nu * dnv) * w;
    Auu = (d2nu * nv) * w;
    Auv = (dnu * dnv) * w;
    Avv = (nu * d2nv) * w;
  }
  const double W0 = half_sum(A0), Wu = half_sum(Au), Wv = half_sum(Av);
  const double Wuu = half_sum(Auu), Wuv = half_sum(Auv),
               Wvv = half_sum(Avv);
  out.R0 = A0 / W0;
  out.Ru = (Au - out.R0 * Wu) / W0;
  out.Rv = (Av - out.R0 * Wv) / W0;
  out.Ruu = (Auu - 2.0 * (out.Ru * Wu) - out.R0 * Wuu) / W0;
  out.Ruv = (Auv - out.Ru * Wv - out.Rv * Wu - out.R0 * Wuv) / W0;
  out.Rvv = (Avv - 2.0 * (out.Rv * Wv) - out.R0 * Wvv) / W0;
  return out;
}

__device__ __forceinline__ LaneRow2 lane_row2(const SurfSetArgs& s, int ip,
                                              double u, double v) {
  switch (s.p * 4 + s.q) {
    case 5: return lane_row2_pq<1, 1>(s, ip, u, v);
    case 6: return lane_row2_pq<1, 2>(s, ip, u, v);
    case 7: return lane_row2_pq<1, 3>(s, ip, u, v);
    case 9: return lane_row2_pq<2, 1>(s, ip, u, v);
    case 10: return lane_row2_pq<2, 2>(s, ip, u, v);
    case 11: return lane_row2_pq<2, 3>(s, ip, u, v);
    case 13: return lane_row2_pq<3, 1>(s, ip, u, v);
    case 14: return lane_row2_pq<3, 2>(s, ip, u, v);
    default: return lane_row2_pq<3, 3>(s, ip, u, v);
  }
}

}  // namespace gf
