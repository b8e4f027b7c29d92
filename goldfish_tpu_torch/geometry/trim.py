"""Trimmed-surface quadrature: finite-cell style weight masking.

Port of goldfish_tpu/geometry/trim.py, host NumPy, unchanged in what it
computes.

The reference delegates trimmed CAD faces to OpenCASCADE and analyzes
untrimmed B-spline patches only (its IGES corpus carries trivial
type-144 wrappers: `144,<de>,0,0,0;` — see
demos_om/thickness_opt/plate/geometry/plate_geometry.igs). Here trims
are honored natively: quadrature points outside the trimmed region get
ZERO weight (the repo-wide padding discipline — real geometry, zero
weight, so no 0/0 guards and AD stays clean), optionally on a
span-subdivided rule for sharper resolution of cut cells. This is the
classic finite-cell / immersed quadrature treatment: integration error
is O(cell size) along the trim band and is driven down by `subdiv`.

Loops are closed curves in the surface's PARAMETER space (u, v) — NURBS
curves whose x, y coordinates are u, v (IGES type-142 convention) or
plain (M, 2) polygon vertex arrays. Outer loop = material inside;
inner loops = holes.
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.ops.quadrature import gauss_points_1d

__all__ = [
    "sample_loop",
    "points_in_polygon",
    "trim_mask",
    "apply_trim",
    "compress_voided",
    "support_weights",
]


def sample_loop(loop, n_per_span: int = 8) -> np.ndarray:
    """Closed (M, 2) parameter-space polygon from a trim loop.

    `loop` is an (M, 2) array (returned as-is), a NURBS curve, or a
    list of NURBS curves forming a closed composite loop. Curves are
    sampled densely (n_per_span points per unique knot span) so the
    polygon chord error is negligible next to the quadrature-band
    error."""
    if isinstance(loop, np.ndarray):
        if loop.ndim != 2 or loop.shape[1] < 2:
            raise ValueError(f"a trim polygon is (M, 2), got {loop.shape}")
        return np.asarray(loop[:, :2], dtype=np.float64)
    curves = [loop] if isinstance(loop, NURBS) else list(loop)
    pts = []
    for c in curves:
        if c.dim != 1:
            raise ValueError("trim loop curves must be 1-parameter")
        k = c.knots[0]
        uniq = np.unique(k)
        us = np.concatenate(
            [np.linspace(a, b, n_per_span, endpoint=False)
             for a, b in zip(uniq[:-1], uniq[1:])]
            + [uniq[-1:]]
        )
        pts.append(c.evaluate(us)[:, :2])
    poly = np.concatenate(pts, axis=0)
    # drop consecutive duplicates (curve joints repeat the endpoint)
    keep = np.ones(len(poly), dtype=bool)
    keep[1:] = np.linalg.norm(np.diff(poly, axis=0), axis=1) > 1e-14
    return poly[keep]


def points_in_polygon(pts: np.ndarray, poly: np.ndarray) -> np.ndarray:
    """Even-odd rule point-in-polygon test, vectorized.

    pts: (N, 2); poly: (M, 2) closed implicitly (last connects to
    first). Returns bool (N,)."""
    pts = np.asarray(pts, dtype=np.float64)
    x, y = pts[:, 0], pts[:, 1]
    x0, y0 = poly[:, 0], poly[:, 1]
    x1, y1 = np.roll(x0, -1), np.roll(y0, -1)
    # edge straddles the horizontal ray through y
    cond = (y0[None, :] > y[:, None]) != (y1[None, :] > y[:, None])
    dy = y1 - y0
    dy = np.where(np.abs(dy) < 1e-300, 1e-300, dy)
    xi = x0[None, :] + (y[:, None] - y0[None, :]) / dy[None, :] * (
        x1 - x0)[None, :]
    crossings = np.sum(cond & (xi > x[:, None]), axis=1)
    return (crossings % 2) == 1


def trim_mask(qpts: np.ndarray, outer=None, inners=()) -> np.ndarray:
    """Float mask over parameter points: 1 inside the trimmed region.

    qpts: (..., 2). outer: loop or None (None = natural domain).
    inners: iterable of hole loops."""
    flat = np.asarray(qpts, dtype=np.float64).reshape(-1, 2)
    mask = np.ones(len(flat), dtype=bool)
    if outer is not None:
        mask &= points_in_polygon(flat, sample_loop(outer))
    for hole in inners or ():
        mask &= ~points_in_polygon(flat, sample_loop(hole))
    return mask.astype(np.float64).reshape(np.asarray(qpts).shape[:-1])


def apply_trim(quad, outer=None, inners=(), coverage: int = 8):
    """Return a copy of a PatchQuadrature with weights zeroed outside
    the trimmed region (finite-cell masking). Basis tables, conn and
    qpts are untouched — padded/voided points keep real geometry with
    zero weight, per the padding discipline.

    coverage (default on) additionally RESCALES each cut element's
    surviving weights so their parametric mass equals the element's
    EXACT inside area (Sutherland-Hodgman clip of the loop polygons
    against the cell rectangle + shoelace area): the per-cell area
    error drops from O(Gauss band) to the loop's polygon chord error,
    which tightens integrals of smooth densities by 1-2 orders at the
    same subdiv. Set coverage=0 for pure binary masking."""
    from dataclasses import replace

    m = trim_mask(quad.qpts, outer, inners)
    wq = quad.wq * m
    if not coverage or (outer is None and not inners):
        return replace(quad, wq=wq)

    o_poly = None if outer is None else sample_loop(outer)
    h_polys = [sample_loop(h) for h in (inners or ())]
    polys = ([] if o_poly is None else [o_poly]) + h_polys
    boxes = [(p[:, 0].min(), p[:, 0].max(), p[:, 1].min(),
              p[:, 1].max()) for p in polys]
    qp = np.asarray(quad.qpts)               # (n_el, n_qp, 2)
    partial = ~m.all(axis=1)                 # any cell not fully kept

    def cell_bounds(coords):
        """Exact cell interval from its affine-mapped Gauss abscissae
        (the Gauss span under-covers the cell by the rule's edge
        margin)."""
        u = np.unique(coords)
        if len(u) < 2:
            return u[0], u[0]
        g = gauss_points_1d(len(u))[0]
        # affine map u = c + 0.5*width*g  =>  width = 2*span/gspan
        h = 2.0 * (u[-1] - u[0]) / (g[-1] - g[0])
        c = 0.5 * (u[-1] + u[0])
        return c - 0.5 * h, c + 0.5 * h

    def touches(box, ua, ub, va, vb):
        return not (box[1] < ua or box[0] > ub
                    or box[3] < va or box[2] > vb)

    for e in np.flatnonzero(partial):
        ua, ub = cell_bounds(qp[e, :, 0])
        va, vb = cell_bounds(qp[e, :, 1])
        cell_area = (ub - ua) * (vb - va)
        if cell_area <= 0.0:
            continue
        # cells whose bbox touches no loop are uncut: the Gauss mask
        # already classified them fully in or out
        if not any(touches(b, ua, ub, va, vb) for b in boxes):
            continue
        center = np.array([[0.5 * (ua + ub), 0.5 * (va + vb)]])
        if o_poly is None:
            inside = cell_area
        else:
            inside = _clip_area(o_poly, ua, ub, va, vb)
            if inside == 0.0 and points_in_polygon(center, o_poly)[0]:
                inside = cell_area  # cell strictly interior to outer
        for hp in h_polys:
            a = _clip_area(hp, ua, ub, va, vb)
            if a == 0.0 and points_in_polygon(center, hp)[0]:
                a = cell_area
            inside -= a
        frac = min(max(inside / cell_area, 0.0), 1.0)
        if frac < 1e-9:  # clipping roundoff -> genuinely void
            frac = 0.0
        mass = float(wq[e].sum())
        full = float(quad.wq[e].sum())
        if full <= 0.0:
            continue
        if frac == 0.0:
            # the exact clip overrules stray Gauss survivors
            wq[e] = np.zeros_like(wq[e])
        elif mass > 0.0:
            wq[e] *= frac * full / mass
        else:
            # sliver cell: no Gauss point survived but material remains
            # — integrate it with the smooth (fictitious) extension of
            # the integrand at the cell's own Gauss points
            wq[e] = quad.wq[e] * frac
    return replace(quad, wq=wq)


def _clip_area(poly: np.ndarray, ua, ub, va, vb) -> float:
    """|polygon ∩ [ua,ub]x[va,vb]| via Sutherland-Hodgman + shoelace
    (sign-insensitive: loops may wind either way)."""
    pts = poly
    for axis, bound, keep_ge in ((0, ua, True), (0, ub, False),
                                 (1, va, True), (1, vb, False)):
        if len(pts) == 0:
            return 0.0
        out = []
        n = len(pts)
        for i in range(n):
            p, q = pts[i], pts[(i + 1) % n]
            pin = (p[axis] >= bound) if keep_ge else (p[axis] <= bound)
            qin = (q[axis] >= bound) if keep_ge else (q[axis] <= bound)
            if pin:
                out.append(p)
            if pin != qin:
                t = (bound - p[axis]) / (q[axis] - p[axis])
                out.append(p + t * (q - p))
        pts = np.asarray(out)
    if len(pts) < 3:
        return 0.0
    x, y = pts[:, 0], pts[:, 1]
    return abs(0.5 * float(np.sum(x * np.roll(y, -1)
                                  - np.roll(x, -1) * y)))


def compress_voided(quad):
    """Drop elements whose every quadrature weight was trimmed to zero
    (they contribute nothing), so a subdivided trimmed patch does not
    inflate the stack's max_el padding — and with it every OTHER
    patch's batched tables — by the void fraction."""
    from dataclasses import replace

    keep = np.asarray(quad.wq).any(axis=1)
    if keep.all():
        return quad
    keep[np.argmax(keep)] |= True  # never drop to zero elements
    return replace(
        quad,
        n_el=int(keep.sum()),
        conn=quad.conn[keep],
        wq=quad.wq[keep],
        R={k: v[keep] for k, v in quad.R.items()},
        qpts=quad.qpts[keep],
    )


def support_weights(stack) -> np.ndarray:
    """Total quadrature mass seen by each control point: (P, C) sums
    of |R00| * wq scattered through conn. A ZERO entry means the CP's
    entire basis support was trimmed away — its stiffness row is
    exactly zero and the dof MUST be pinned or the tangent is
    singular (solver/system.py pins them automatically)."""
    R00 = np.abs(stack.R00.cpu().numpy())        # (P, E, Q, L)
    wq = stack.wq.cpu().numpy()                  # (P, E, Q)
    conn = stack.conn.cpu().numpy()              # (P, E, L)
    mass = np.einsum("peql,peq->pel", R00, wq)
    P, C = conn.shape[0], stack.cp_mask.shape[1]
    out = np.zeros((P, C))
    for p in range(P):
        np.add.at(out[p], conn[p].ravel(), mass[p].ravel())
    return out
