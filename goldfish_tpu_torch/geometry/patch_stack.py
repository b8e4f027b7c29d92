"""Padded, stacked per-patch quadrature data as tensors.

Port of goldfish_tpu/geometry/patch_stack.py. Every patch's basis
tables are padded to common (max_el, n_qp, max_loc, max_cp) sizes and
stacked along a leading patch axis, so all physics runs batched over
(patch, element, qp, local basis).

Padding discipline (unchanged from the reference): padded elements
replicate element 0 of the same patch with zero quadrature weight, and
padded local columns have zero basis values. Every intermediate quantity
at a padded point is the real geometry's, so it stays finite, and its
contribution vanishes exactly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.geometry.trim import apply_trim, compress_voided
from goldfish_tpu_torch.ops.quadrature import (
    PatchQuadrature,
    build_patch_quadrature,
)

__all__ = ["PatchStack", "PatchMeta", "build_patch_stack", "side_dofs",
           "stack_control_points"]


class PatchStack(NamedTuple):
    """P = patches, E = max elements, Q = qps/element, L = max local
    basis size, C = max CPs/patch."""

    R00: torch.Tensor  # (P, E, Q, L)
    R10: torch.Tensor
    R01: torch.Tensor
    R20: torch.Tensor
    R11: torch.Tensor
    R02: torch.Tensor
    conn: torch.Tensor     # (P, E, L) int32
    wq: torch.Tensor       # (P, E, Q) parametric weights, 0 on padding
    cp_mask: torch.Tensor  # (P, C) 1.0 for real control points

    @property
    def n_patches(self):
        return self.R00.shape[0]

    @property
    def max_cp(self):
        return self.cp_mask.shape[1]


class PatchMeta:
    """Host-side static metadata for one patch."""

    def __init__(self, surf: NURBS, quad: PatchQuadrature):
        self.surf = surf
        self.quad = quad
        self.n_u, self.n_v = surf.shape
        self.n_cp = self.n_u * self.n_v
        self.degree = surf.degree


def side_dofs(n_u: int, n_v: int, direction: int, side: int,
              n_layers: int = 1) -> np.ndarray:
    """Flat CP indices of a parametric side, n_layers rows deep (tIGAr
    getSideDofs semantics; CP layout is i_u * n_v + i_v)."""
    iu = np.arange(n_u)
    iv = np.arange(n_v)
    if direction == 0:
        rows = iu[:n_layers] if side == 0 else iu[n_u - n_layers:]
        return (rows[:, None] * n_v + iv[None, :]).ravel()
    cols = iv[:n_layers] if side == 0 else iv[n_v - n_layers:]
    return (iu[:, None] * n_v + cols[None, :]).ravel()


def build_patch_stack(surfs: list[NURBS], nq: int | None = None,
                      device=None, trims=None, trim_subdiv: int = 3):
    """Build (PatchStack, [PatchMeta]) from NURBS surfaces.

    nq: Gauss points per direction (default degree+1 per patch).
    trims: optional per-patch trim spec (len P list; None entries =
    untrimmed): each entry is `(outer, inners)` with loops as accepted
    by geometry/trim.sample_loop (param-space NURBS curve(s) or (M, 2)
    polygons; outer may be None for the natural domain). Trimmed
    patches get a `trim_subdiv`-subdivided rule, cut-cell coverage
    weights (`trim.apply_trim`) and their void elements dropped
    (`trim.compress_voided`)."""
    device = as_device(device)
    metas = []
    quads = []
    for i, s in enumerate(surfs):
        p, q = s.degree
        tr = trims[i] if trims is not None else None
        quad = build_patch_quadrature(
            s.knots[0], s.knots[1], p, q, s.weights,
            nq_u=nq or (p + 1), nq_v=nq or (q + 1),
            subdiv=trim_subdiv if tr is not None else 1)
        if tr is not None:
            outer, inners = tr
            quad = compress_voided(apply_trim(quad, outer, inners))
        metas.append(PatchMeta(s, quad))
        quads.append(quad)

    max_el = max(q.n_el for q in quads)
    max_loc = max(q.n_loc for q in quads)
    max_cp = max(m.n_cp for m in metas)
    n_qp = quads[0].n_qp
    if any(q.n_qp != n_qp for q in quads):
        raise ValueError("mixed qp counts per element are not supported; "
                         "pass nq explicitly")

    def pad_R(a):  # (n_el, n_qp, n_loc) -> (max_el, n_qp, max_loc)
        a = np.pad(a, ((0, 0), (0, 0), (0, max_loc - a.shape[2])))
        if a.shape[0] < max_el:
            a = np.concatenate(
                [a, np.repeat(a[:1], max_el - a.shape[0], axis=0)], axis=0)
        return a

    keys = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))
    Rs = [[] for _ in keys]
    conns, wqs, masks = [], [], []
    for q, m in zip(quads, metas):
        for i, k in enumerate(keys):
            Rs[i].append(pad_R(q.R[k]))
        conn = np.pad(q.conn, ((0, 0), (0, max_loc - q.conn.shape[1])))
        if conn.shape[0] < max_el:
            conn = np.concatenate(
                [conn, np.repeat(conn[:1], max_el - conn.shape[0], axis=0)])
        conns.append(conn)
        wqs.append(np.pad(q.wq, ((0, max_el - q.wq.shape[0]), (0, 0))))
        mask = np.zeros(max_cp)
        mask[: m.n_cp] = 1.0
        masks.append(mask)

    stack = PatchStack(
        *(tensor(np.stack(r), device) for r in Rs),
        conn=tensor(np.stack(conns), device, INDEX_DTYPE),
        wq=tensor(np.stack(wqs), device),
        cp_mask=tensor(np.stack(masks), device),
    )
    return stack, metas


def stack_control_points(metas: list[PatchMeta], device=None):
    """Padded (P, C, 3) physical CP tensor from patch metadata."""
    device = as_device(device)
    max_cp = max(m.n_cp for m in metas)
    out = np.zeros((len(metas), max_cp, 3))
    for i, m in enumerate(metas):
        out[i, : m.n_cp] = m.surf.points.reshape(-1, 3)
    return tensor(out, device, DTYPE)
