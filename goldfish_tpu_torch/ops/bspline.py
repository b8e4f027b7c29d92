"""Host-side (numpy) B-spline / NURBS basis machinery.

This is the precomputation layer: all basis values and derivatives are
evaluated ONCE on the host at fixed quadrature points and baked into
constant device arrays; the TPU never traces Cox-de-Boor recursions for
the fixed-intersection path. (A JAX-traceable evaluator for the
moving-intersection path lives in `bspline_jax.py`.)

Replaces: tIGAr `ExtractedSpline` basis extraction + FEniCS element
tabulation (reference: GOLDFISH/nonmatching_opt.py:1-5 imports;
GOLDFISH/cpiga2xi.py:351-363 uses tIGAr BSplines.getNodesAndEvals).
Algorithms are the standard ones from Piegl & Tiller, "The NURBS Book"
(A2.1 FindSpan, A2.3 DersBasisFuns), implemented independently.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "find_span",
    "ders_basis_funs",
    "basis_at_points",
    "greville",
    "open_uniform_knots",
    "unique_spans",
    "rational_basis_2d",
]


def find_span(knots: np.ndarray, p: int, u: float) -> int:
    """Knot span index i such that knots[i] <= u < knots[i+1].

    For u at the right end of the domain, returns the last non-empty span.
    """
    knots = np.asarray(knots, dtype=np.float64)
    n = len(knots) - p - 2  # highest basis index
    hi = knots[n + 1]
    if u >= hi:
        # last span with positive measure
        i = n
        while knots[i] == knots[i + 1]:
            i -= 1
        return i
    lo = knots[p]
    if u <= lo:
        i = p
        while knots[i] == knots[i + 1]:
            i += 1
        return i
    # binary search
    return int(np.searchsorted(knots, u, side="right") - 1)


def ders_basis_funs(knots: np.ndarray, p: int, u: float, nd: int) -> tuple[int, np.ndarray]:
    """Nonzero basis functions and derivatives at u.

    Returns (span, ders) with ders of shape (nd+1, p+1):
    ders[k, j] = d^k/du^k N_{span-p+j, p}(u).
    """
    knots = np.asarray(knots, dtype=np.float64)
    span = find_span(knots, p, u)
    ndu = np.zeros((p + 1, p + 1))
    left = np.zeros(p + 1)
    right = np.zeros(p + 1)
    ndu[0, 0] = 1.0
    for j in range(1, p + 1):
        left[j] = u - knots[span + 1 - j]
        right[j] = knots[span + j] - u
        saved = 0.0
        for r in range(j):
            ndu[j, r] = right[r + 1] + left[j - r]
            temp = ndu[r, j - 1] / ndu[j, r]
            ndu[r, j] = saved + right[r + 1] * temp
            saved = left[j - r] * temp
        ndu[j, j] = saved

    ders = np.zeros((nd + 1, p + 1))
    ders[0, :] = ndu[:, p]
    a = np.zeros((2, p + 1))
    for r in range(p + 1):
        s1, s2 = 0, 1
        a[0, 0] = 1.0
        for k in range(1, nd + 1):
            d = 0.0
            rk = r - k
            pk = p - k
            if r >= k:
                a[s2, 0] = a[s1, 0] / ndu[pk + 1, rk]
                d = a[s2, 0] * ndu[rk, pk]
            j1 = 1 if rk >= -1 else -rk
            j2 = k - 1 if r - 1 <= pk else p - r
            for j in range(j1, j2 + 1):
                a[s2, j] = (a[s1, j] - a[s1, j - 1]) / ndu[pk + 1, rk + j]
                d += a[s2, j] * ndu[rk + j, pk]
            if r <= pk:
                a[s2, k] = -a[s1, k - 1] / ndu[pk + 1, r]
                d += a[s2, k] * ndu[r, pk]
            ders[k, r] = d
            s1, s2 = s2, s1
    r = float(p)
    for k in range(1, nd + 1):
        ders[k, :] *= r
        r *= p - k
    return span, ders


def basis_at_points(knots: np.ndarray, p: int, us: np.ndarray, nd: int):
    """Dense local basis tables at many points.

    Returns (spans (m,), ders (m, nd+1, p+1)). Column j of point i is basis
    index spans[i] - p + j.
    """
    us = np.atleast_1d(np.asarray(us, dtype=np.float64))
    m = us.shape[0]
    spans = np.zeros(m, dtype=np.int64)
    ders = np.zeros((m, nd + 1, p + 1))
    for i, u in enumerate(us):
        s, d = ders_basis_funs(knots, p, float(u), nd)
        spans[i] = s
        ders[i] = d
    return spans, ders


def greville(knots: np.ndarray, p: int) -> np.ndarray:
    """Greville abscissae: xi_i = mean(knots[i+1 : i+p+1])."""
    knots = np.asarray(knots, dtype=np.float64)
    n = len(knots) - p - 1
    return np.array([knots[i + 1: i + p + 1].mean() for i in range(n)])


def open_uniform_knots(p: int, num_el: int, a: float = 0.0, b: float = 1.0) -> np.ndarray:
    """Open (clamped) knot vector with num_el uniform elements on [a, b]."""
    interior = np.linspace(a, b, num_el + 1)[1:-1]
    return np.concatenate([np.full(p + 1, a), interior, np.full(p + 1, b)])


def unique_spans(knots: np.ndarray, p: int):
    """Non-empty knot spans: list of (span_index, u_lo, u_hi)."""
    knots = np.asarray(knots, dtype=np.float64)
    out = []
    for i in range(p, len(knots) - p - 1):
        if knots[i + 1] > knots[i]:
            out.append((i, knots[i], knots[i + 1]))
    return out


def _tensor_local_ders(du, dv, nd):
    """Outer products of 1D derivative tables.

    du: (nd+1, p+1), dv: (nd+1, q+1) -> dict[(a,b)] = (p+1, q+1) with
    a+b <= nd, entry = d^a/du^a d^b/dv^b of the tensor-product basis.
    """
    out = {}
    for a in range(nd + 1):
        for b in range(nd + 1 - a):
            out[(a, b)] = np.outer(du[a], dv[b])
    return out


def rational_basis_2d(
    knots_u: np.ndarray,
    knots_v: np.ndarray,
    p: int,
    q: int,
    weights: np.ndarray,
    pts: np.ndarray,
    nd: int = 2,
):
    """Rational (NURBS) basis values/derivatives at arbitrary points.

    weights: (n_u, n_v). pts: (m, 2) parametric points.

    Returns (conn, tables) where
      conn: (m, (p+1)*(q+1)) int64 flat CP indices (i*n_v + j) supporting
            each point, and
      tables: dict[(a,b)] -> (m, (p+1)*(q+1)) float64 with a+b <= nd:
            the (a,b) parametric derivative of the rational basis R_k.

    Rationalization (weights are design-FIXED; only CP xyz move during
    shape optimization, so these tables are constants): R = wN/W with
    W = sum w N; quotient rule through second derivatives.
    """
    weights = np.asarray(weights, dtype=np.float64)
    n_u, n_v = weights.shape
    pts = np.asarray(pts, dtype=np.float64).reshape(-1, 2)
    m = pts.shape[0]
    nloc = (p + 1) * (q + 1)
    conn = np.zeros((m, nloc), dtype=np.int64)
    keys = [(a, b) for a in range(nd + 1) for b in range(nd + 1 - a)]
    tables = {k: np.zeros((m, nloc)) for k in keys}

    for ipt in range(m):
        u, v = pts[ipt]
        su, du = ders_basis_funs(knots_u, p, float(u), nd)
        sv, dv = ders_basis_funs(knots_v, q, float(v), nd)
        iu = np.arange(su - p, su + 1)
        iv = np.arange(sv - q, sv + 1)
        conn[ipt] = (iu[:, None] * n_v + iv[None, :]).ravel()
        wloc = weights[np.ix_(iu, iv)]  # (p+1, q+1)
        N = _tensor_local_ders(du, dv, nd)  # B-spline tensor basis derivs
        # weighted basis derivatives and weight-function derivatives
        wN = {k: wloc * N[k] for k in N}
        W = {k: wN[k].sum() for k in wN}
        W0 = W[(0, 0)]
        R = {}
        R[(0, 0)] = wN[(0, 0)] / W0
        if nd >= 1:
            for k in ((1, 0), (0, 1)):
                R[k] = (wN[k] - R[(0, 0)] * W[k]) / W0
        if nd >= 2:
            for k in ((2, 0), (0, 2), (1, 1)):
                a, b = k
                # split k into two first-order steps k = k1 + k2
                if k == (1, 1):
                    k1, k2 = (1, 0), (0, 1)
                else:
                    k1 = (1, 0) if a else (0, 1)
                    k2 = k1
                R[k] = (
                    wN[k]
                    - R[(0, 0)] * W[k]
                    - R[k1] * W[k2]
                    - R[k2] * W[k1]
                ) / W0
        for k in keys:
            tables[k][ipt] = R[k].ravel()
    return conn, tables
