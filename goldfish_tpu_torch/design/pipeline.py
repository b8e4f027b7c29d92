"""Design-variable pipelines: flat design vectors -> padded system tensors.

Port of goldfish_tpu/design/pipeline.py (`CPLayout`, `ThicknessFFD`,
`ShapeFFD`). The FFD basis evaluation is one
constant dense matrix F built on the host (design/ffd.py, NumPy); the maps
h_ffd -> F h_ffd -> padded (P, C) and p_ffd -> padded (P, C, 3) are
matrix-vector products and index gathers, differentiable by autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.config import as_device, tensor
from goldfish_tpu_torch.design.ffd import FFDBlock, create_3D_block
from goldfish_tpu_torch.geometry.patch_stack import PatchMeta

__all__ = ["CPLayout", "ThicknessFFD", "ShapeFFD"]


class CPLayout:
    """Index maps between flat stacked CP vectors (all patches
    concatenated, real CPs only) and padded (P, C) tensors."""

    def __init__(self, metas: list[PatchMeta], max_cp: int, device=None):
        device = as_device(device)
        self.n_per_patch = [m.n_cp for m in metas]
        self.offsets = np.cumsum([0] + self.n_per_patch)
        self.n_flat = int(self.offsets[-1])
        idx = np.full((len(metas), max_cp), self.n_flat, dtype=np.int64)
        for i, m in enumerate(metas):
            idx[i, : m.n_cp] = self.offsets[i] + np.arange(m.n_cp)
        self._idx = tensor(idx, device, torch.int64)
        keep = idx.ravel() < self.n_flat
        inv = np.empty(self.n_flat, dtype=np.int64)
        inv[idx.ravel()[keep]] = np.nonzero(keep)[0]
        self._inv = tensor(inv, device, torch.int64)

    def to_padded(self, flat):
        """(n_flat, ...) -> (P, C, ...); padding entries become 0."""
        ext = torch.cat([flat, flat.new_zeros((1,) + flat.shape[1:])], 0)
        return ext[self._idx]

    def to_flat(self, padded):
        """(P, C, ...) -> (n_flat, ...), dropping padding."""
        P, C = padded.shape[:2]
        return padded.reshape((P * C,) + padded.shape[2:])[self._inv]


class ThicknessFFD:
    """h_ffd (n_ffd,) -> padded thickness coefficients (P, C).

    The FFD block spans the surface CPs' bounding box; the initial h_ffd
    is the constant-thickness vector (partition of unity makes the map
    exact for constants)."""

    def __init__(self, system, num_els=(2, 1, 1), p=2, lims=None):
        device = system.device
        self.layout = CPLayout(system.metas, system.stack.max_cp, device)
        self.block, self.ffd = _block_around(system.metas, num_els, p, lims)
        self.F = tensor(self.ffd.F, device)
        self.n_ffd = self.ffd.n_ffd
        self.shape = self.ffd.shape

    def init_h_ffd(self, h0: float) -> np.ndarray:
        return np.full(self.n_ffd, float(h0))

    def __call__(self, h_ffd):
        return self.layout.to_padded(self.F @ h_ffd)


def _block_around(metas, num_els, p, lims):
    """FFDBlock around all surface CPs (bounding box padded by 1e-6 unless
    `lims` is given)."""
    pts = np.concatenate([m.surf.points.reshape(-1, 3) for m in metas],
                         axis=0)
    if lims is None:
        lo, hi = pts.min(0), pts.max(0)
        pad = 1e-6 * np.maximum(hi - lo, 1.0)
        lims = np.stack([lo - pad, hi + pad], axis=1)
    block = create_3D_block(num_els, p, lims)
    return block, FFDBlock(block, pts)


class ShapeFFD:
    """p_ffd (n_ffd * n_fields,) -> padded control points (P, C, 3).

    Surface CPs follow the FFD block coefficients linearly; fields not in
    `opt_fields` stay at their initial values. The design vector stacks
    the optimized fields' block coefficients (x-fastest within each)."""

    def __init__(self, system, num_els=(2, 2, 2), p=2, lims=None,
                 opt_fields=(0, 1, 2)):
        device = system.device
        self.layout = CPLayout(system.metas, system.stack.max_cp, device)
        self.block, self.ffd = _block_around(system.metas, num_els, p, lims)
        self.F = tensor(self.ffd.F, device)
        self.n_ffd = self.ffd.n_ffd
        self.shape = self.ffd.shape
        self.opt_fields = tuple(opt_fields)
        self.p0 = self.ffd.p0  # (n_ffd, 3) initial block coefficients
        self._cp0_padded = system.cp

    def init_p_ffd(self) -> np.ndarray:
        """Initial design: block coefficients of the optimized fields,
        stacked (n_ffd * n_fields,)."""
        return np.concatenate([self.p0[:, f] for f in self.opt_fields])

    def __call__(self, p_ffd_flat):
        n = self.n_ffd
        cols = [self._cp0_padded[..., f] for f in range(3)]
        for a, f in enumerate(self.opt_fields):
            cols[f] = self.layout.to_padded(
                self.F @ p_ffd_flat[a * n:(a + 1) * n])
        return torch.stack(cols, dim=-1)
