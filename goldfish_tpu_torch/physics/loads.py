"""External loads (port of goldfish_tpu/physics/loads.py: dead and point
loads).

Both loads are linear in d, so their work is a contraction and a reduction
(plain PyTorch, no kernel) and their d-gradient is a constant force
vector. A point load F . u(xi) acts at a fixed parametric point: its basis
row is evaluated once on the host (`build_point_loads`, NumPy, the
reference's builder) and it depends neither on cp nor on h. Edge,
follower-pressure and field loads are not ported yet (ROADMAP Queue A7)
and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.geometry.patch_stack import PatchStack
from goldfish_tpu_torch.ops.bspline import rational_basis_2d
from goldfish_tpu_torch.physics.kl_shell import (
    dead_load_force,
    external_work_dead_load,
)

__all__ = ["PointLoads", "build_point_loads", "point_load_work",
           "external_work", "external_force"]


class PointLoads(NamedTuple):
    """Stacked point loads: F . u(xi) at fixed parametric points."""

    patch: torch.Tensor  # (n,) int32
    conn: torch.Tensor   # (n, L) int32
    R0: torch.Tensor     # (n, L)
    F: torch.Tensor      # (n, 3)


def build_point_loads(surfs: list[NURBS], entries, max_loc: int,
                      device=None) -> PointLoads | None:
    """entries: list of (patch_index, xi (2,), force (3,))."""
    device = as_device(device)
    if not entries:
        return None
    patch, conns, R0s, Fs = [], [], [], []
    for (ip, xi, F) in entries:
        s = surfs[ip]
        p, q = s.degree
        conn, tab = rational_basis_2d(
            s.knots[0], s.knots[1], p, q, s.weights,
            np.asarray(xi, dtype=np.float64)[None, :], nd=0)
        c = np.zeros(max_loc, dtype=np.int64)
        r = np.zeros(max_loc)
        c[: conn.shape[1]] = conn[0]
        r[: conn.shape[1]] = tab[(0, 0)][0]
        patch.append(ip)
        conns.append(c)
        R0s.append(r)
        Fs.append(np.asarray(F, dtype=np.float64))
    return PointLoads(
        patch=tensor(patch, device, INDEX_DTYPE),
        conn=tensor(np.stack(conns), device, INDEX_DTYPE),
        R0=tensor(np.stack(R0s), device, DTYPE),
        F=tensor(np.stack(Fs), device, DTYPE),
    )


def point_load_work(pl: PointLoads, d):
    """sum_i F_i . u(xi_i)."""
    de = d[pl.patch.long()[:, None], pl.conn.long()]   # (n, L, 3)
    u = torch.einsum("nl,nlk->nk", pl.R0, de)
    return (pl.F * u).sum()


def point_load_force(pl: PointLoads, P: int, C: int):
    """d/dd of `point_load_work`: (P, C, 3), constant in d."""
    node = (pl.patch.long()[:, None] * C + pl.conn.long()).reshape(-1)
    contrib = pl.R0[..., None] * pl.F[:, None, :]
    out = torch.zeros(P * C, 3, dtype=pl.F.dtype, device=pl.F.device)
    out.index_add_(0, node, contrib.reshape(-1, 3))
    return out.reshape(P, C, 3)


def _only_ported(pressure, edge_loads, f_field):
    for name, v in (("pressure", pressure), ("edge_loads", edge_loads),
                    ("f_field", f_field)):
        if v is not None:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP Queue A7)")


def external_work(stack: PatchStack, d, cp, f_areal=None, point_loads=None,
                  pressure=None, edge_loads=None, f_field=None):
    """W_ext (0-dim tensor)."""
    _only_ported(pressure, edge_loads, f_field)
    W = torch.zeros((), dtype=d.dtype, device=d.device)
    if f_areal is not None:
        W = W + external_work_dead_load(stack, d, cp, f_areal)
    if point_loads is not None:
        W = W + point_load_work(point_loads, d)
    return W


def external_force(stack: PatchStack, cp, f_areal=None, point_loads=None):
    """dW_ext/dd (P, C, 3), constant in d."""
    f = torch.zeros_like(cp)
    if f_areal is not None:
        f = f + dead_load_force(stack, cp, f_areal)
    if point_loads is not None:
        f = f + point_load_force(point_loads, cp.shape[0], cp.shape[1])
    return f
