"""NURBS surface evaluation at arbitrary, moving parametric points.

Port of goldfish_tpu/ops/bspline_jax.py. The moving-intersection path
needs basis rows at intersection coordinates xi that change with the
design, together with their xi-derivatives. The JAX package traces the
Cox-de Boor recursion and differentiates it with jax.jacfwd; here

- `traced_rows` evaluates the rows of many points at once: kernel K5
  (csrc/traced_rows.cu: half a warp a point, the span by ballots, Piegl &
  Tiller A2.3's values and first derivatives in closed form, of
  csrc/bspline_rows.cuh) on CUDA tensors, and on CPU tensors its plain
  PyTorch version, which runs the Cox-de Boor recursion on (value, d/du)
  pairs and the quotient rule of ops/bspline.rational_basis_2d, so its
  rows stay differentiable by autograd in xi (the plain versions of K6 and
  K7 differentiate them);
- `surface_basis`, `surface_point`, `field_at` are the reference's point
  evaluators, batched over points, on top of `traced_rows`.

Patches are packed into a `SurfSet` with knot vectors padded by end-knot
repeats and valid-span tables padded with +inf; the span of a point is
searchsorted(span starts, u, side="right") - 1, clipped (`_find_span`),
bit for bit the reference's rule. All packed surfaces share the degree.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor

__all__ = ["SurfSet", "make_surf_set", "traced_rows", "surface_basis",
           "surface_point", "field_at"]


class SurfSet(NamedTuple):
    """Padded per-patch NURBS data for traced evaluation. P patches,
    C max control points (matching the PatchStack layout i_u * n_v + i_v)."""

    knots_u: torch.Tensor      # (P, Ku)
    knots_v: torch.Tensor      # (P, Kv)
    span_u_vals: torch.Tensor  # (P, Su) start knot of each valid span; +inf pad
    span_u_ids: torch.Tensor   # (P, Su) int32
    span_v_vals: torch.Tensor  # (P, Sv)
    span_v_ids: torch.Tensor   # (P, Sv) int32
    w: torch.Tensor            # (P, C) weights (1.0 on padding)
    n_v: torch.Tensor          # (P,) int32


def make_surf_set(surfs, max_cp: int | None = None, device=None):
    """Pack NURBS patches (all of equal degree) into a SurfSet on `device`.

    Returns (surf_set, (p, q))."""
    device = as_device(device)
    degs = {s.degree for s in surfs}
    if len(degs) != 1:
        raise ValueError(f"mixed degrees not supported in SurfSet: {degs}")
    p, q = degs.pop()
    max_cp = max_cp or max(s.shape[0] * s.shape[1] for s in surfs)

    def pad_knots(ks):
        m = max(len(k) for k in ks)
        return np.stack([
            np.concatenate([k, np.full(m - len(k), k[-1])]) for k in ks])

    def spans(ks, deg):
        per_vals, per_ids = [], []
        for k in ks:
            ids = [i for i in range(deg, len(k) - deg - 1) if k[i + 1] > k[i]]
            per_ids.append(ids)
            per_vals.append([k[i] for i in ids])
        m = max(len(v) for v in per_vals)
        vals = np.full((len(ks), m), np.inf)
        idsa = np.zeros((len(ks), m), dtype=np.int32)
        for r, (v, i) in enumerate(zip(per_vals, per_ids)):
            vals[r, : len(v)] = v
            idsa[r, : len(i)] = i
            idsa[r, len(i):] = i[-1]
        return vals, idsa

    ku = [s.knots[0] for s in surfs]
    kv = [s.knots[1] for s in surfs]
    su_vals, su_ids = spans(ku, p)
    sv_vals, sv_ids = spans(kv, q)
    w = np.ones((len(surfs), max_cp))
    for i, s in enumerate(surfs):
        wi = s.weights.reshape(-1)
        w[i, : wi.size] = wi

    ss = SurfSet(
        knots_u=tensor(pad_knots(ku), device),
        knots_v=tensor(pad_knots(kv), device),
        span_u_vals=tensor(su_vals, device),
        span_u_ids=tensor(su_ids, device, INDEX_DTYPE),
        span_v_vals=tensor(sv_vals, device),
        span_v_ids=tensor(sv_ids, device, INDEX_DTYPE),
        w=tensor(w, device),
        n_v=tensor([s.shape[1] for s in surfs], device, INDEX_DTYPE),
    )
    return ss, (p, q)


# ------------------------------------------------------------ plain version
def _find_span(vals, ids, u):
    """Per point: searchsorted(vals[point], u, side="right") - 1, clipped;
    vals, ids: (M, S) rows of the point's patch; u: (M,)."""
    k = torch.searchsorted(vals, u.detach()[:, None].contiguous(),
                           right=True)[:, 0] - 1
    k = k.clamp(0, vals.shape[1] - 1)
    return ids.gather(1, k[:, None])[:, 0].long()


# Pairs (f, f') in one variable: the recursion below is the same as
# bspline_jax._basis_values, each operation carrying its first derivative.
def _jmul(a, b):
    return a[0] * b[0], a[1] * b[0] + a[0] * b[1]


def _jdiv(a, b):
    q0 = a[0] / b[0]
    return q0, (a[1] - q0 * b[1]) / b[0]


def _jadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _basis_jets(knots, p: int, span, u):
    """Nonzero B-spline values at u and their u-derivatives: two (M, p + 1)
    tensors. knots: (M, K) the point's patch's knot row; span: (M,)
    long."""
    one, zero = torch.ones_like(u), torch.zeros_like(u)
    N = [(one, zero)]
    left, right = [None], [None]
    for j in range(1, p + 1):
        kl = knots.gather(1, (span + 1 - j)[:, None])[:, 0]
        kr = knots.gather(1, (span + j)[:, None])[:, 0]
        left.append((u - kl, one))
        right.append((kr - u, -one))
        saved = (zero, zero)
        N_new = []
        for r in range(j):
            temp = _jdiv(N[r], _jadd(right[r + 1], left[j - r]))
            N_new.append(_jadd(saved, _jmul(right[r + 1], temp)))
            saved = _jmul(left[j - r], temp)
        N_new.append(saved)
        N = N_new
    return [torch.stack([n[i] for n in N], -1) for i in range(2)]


def _rows_plain(ss: SurfSet, p: int, q: int, ip, xi):
    """conn (M, L) int32 and the rational rows R (3, M, L) = R0, dR/du,
    dR/dv at points xi (M, 2) of patches ip (M,), by the quotient rule of
    ops/bspline.rational_basis_2d."""
    ipl = ip.long()
    u, v = xi[:, 0], xi[:, 1]
    su = _find_span(ss.span_u_vals[ipl], ss.span_u_ids[ipl], u)
    sv = _find_span(ss.span_v_vals[ipl], ss.span_v_ids[ipl], v)
    Nu = _basis_jets(ss.knots_u[ipl], p, su, u)
    Nv = _basis_jets(ss.knots_v[ipl], q, sv, v)
    iu = su[:, None] - p + torch.arange(p + 1, device=xi.device)
    iv = sv[:, None] - q + torch.arange(q + 1, device=xi.device)
    conn = (iu[:, :, None] * ss.n_v[ipl].long()[:, None, None]
            + iv[:, None, :]).reshape(len(ipl), -1)
    wloc = ss.w[ipl[:, None], conn]
    M = len(ipl)

    def wN(a, b):
        return (Nu[a][:, :, None] * Nv[b][:, None, :]).reshape(M, -1) * wloc

    wN0, wNu, wNv = wN(0, 0), wN(1, 0), wN(0, 1)
    W0 = wN0.sum(-1, keepdim=True)
    R0 = wN0 / W0
    Ru = (wNu - R0 * wNu.sum(-1, keepdim=True)) / W0
    Rv = (wNv - R0 * wNv.sum(-1, keepdim=True)) / W0
    return conn.to(INDEX_DTYPE), torch.stack([R0, Ru, Rv])


# ------------------------------------------------------------ K5 wrapper
def traced_rows(ss: SurfSet, p: int, q: int, ip, xi):
    """K5: basis rows at M points xi (M, 2) on patches ip (M,) int32.

    Returns (conn (M, L) int32, R (3, M, L) = R0, dR/du, dR/dv). On CPU
    tensors the plain version; its rows are differentiable in xi by
    autograd."""
    M = ip.shape[0]
    dev = xi.device
    _cuda.check(ip, "ip", INDEX_DTYPE, (M,), dev)
    _cuda.check(xi, "xi", DTYPE, (M, 2), dev)
    for name in ("knots_u", "knots_v", "span_u_vals", "span_v_vals", "w"):
        _cuda.check(getattr(ss, name), name, DTYPE, None, dev)
    for name in ("span_u_ids", "span_v_ids", "n_v"):
        _cuda.check(getattr(ss, name), name, INDEX_DTYPE, None, dev)
    if not _cuda.on_cuda(xi):
        return _rows_plain(ss, p, q, ip, xi)
    L = (p + 1) * (q + 1)
    conn = torch.empty(M, L, dtype=INDEX_DTYPE, device=dev)
    R = torch.empty(3, M, L, dtype=DTYPE, device=dev)
    P = _cuda.ptr
    _cuda.launch("traced_rows", "gf_traced_rows", *_surf_set_args(ss),
                 P(ip), P(xi), P(conn), P(R), *_surf_set_dims(ss, p, q), M)
    return conn, R


def _surf_set_args(ss: SurfSet):
    """Pointer arguments of a SurfSet in the kernels' SurfSetArgs order."""
    P = _cuda.ptr
    return (P(ss.knots_u), P(ss.knots_v), P(ss.span_u_vals),
            P(ss.span_u_ids), P(ss.span_v_vals), P(ss.span_v_ids), P(ss.w),
            P(ss.n_v))


def _surf_set_dims(ss: SurfSet, p: int, q: int):
    return (ss.knots_u.shape[1], ss.knots_v.shape[1],
            ss.span_u_vals.shape[1], ss.span_v_vals.shape[1],
            ss.w.shape[1], p, q)


# ------------------------------------------------------------ evaluators
def surface_basis(ss: SurfSet, p: int, q: int, ip, xi):
    """Local basis at points xi (M, 2) on patches ip (M,): (conn (M, L),
    wN / sum(wN) (M, L)). The reference returns wN itself; the rational
    value of a coefficient field c, (wN . c[conn]) / sum(wN), is the same
    from either."""
    conn, R = traced_rows(ss, p, q, ip, xi)
    return conn, R[0]


def field_at(ss: SurfSet, p: int, q: int, ip, coef, xi):
    """Rational interpolation of a (P, C, k) coefficient field at points
    xi (M, 2) on patches ip (M,): (M, k)."""
    conn, R = traced_rows(ss, p, q, ip, xi)
    c = coef[ip.long()[:, None], conn.long()]
    return torch.einsum("ml,mlk->mk", R[0], c)


def surface_point(ss: SurfSet, p: int, q: int, ip, cp, xi):
    """Physical points S(xi) (M, 3) on patches ip; cp: (P, C, 3)."""
    return field_at(ss, p, q, ip, cp, xi)
