"""Design-variable pipelines: flat design vectors -> padded system tensors.

Port of goldfish_tpu/design/pipeline.py (`CPLayout`, `ThicknessFFD`,
`PatchConstantThickness`, `ShapeFFD`, `MultiThicknessFFD`,
`MultiShapeFFD`). The FFD basis evaluation is one constant dense matrix F
a block, built on the host (design/ffd.py, NumPy); the maps h_ffd -> F
h_ffd -> padded (P, C) and p_ffd -> padded (P, C, 3) are matrix-vector
products, index gathers and (multi-block) row scatters, differentiable by
autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.config import as_device, tensor
from goldfish_tpu_torch.design.ffd import FFDBlock, create_3D_block
from goldfish_tpu_torch.geometry.patch_stack import PatchMeta

__all__ = ["CPLayout", "ThicknessFFD", "PatchConstantThickness",
           "ShapeFFD", "MultiThicknessFFD", "MultiShapeFFD"]


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


class PatchConstantThickness:
    """h (n_patches,) -> padded thickness coefficients (P, C): one
    constant thickness per patch.

    The design map of the reference's const-thickness drivers, a block of
    ones per patch (GOLDFISH/om_comps/ffd_comps/hth_map_comp.py:48-56, used
    by demos_om/thickness_opt/pegasus/pegasus_const_th_opt_wint.py:46-56).
    Padded CP slots are 0, as `CPLayout.to_padded` makes them."""

    def __init__(self, system):
        metas = system.metas
        self.layout = CPLayout(metas, system.stack.max_cp, system.device)
        reps = np.concatenate(
            [np.full(m.n_cp, i) for i, m in enumerate(metas)])
        self._patch_of = tensor(reps, system.device, torch.int64)
        self.n = len(metas)

    def init_h(self, h0) -> np.ndarray:
        """Initial per-patch design vector (a scalar or one value per
        patch)."""
        return np.broadcast_to(np.asarray(h0, dtype=float),
                               (self.n,)).copy()

    def __call__(self, h):
        return self.layout.to_padded(h[self._patch_of])


def _block_around(metas, num_els, p, lims):
    """FFDBlock around all surface CPs of `metas` (bounding box padded by
    1e-6 unless `lims` is given)."""
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


class _MultiFFDBase:
    """Multi-block FFD: each block controls a subset of patches (the
    reference's `set_shopt_multiFFD` / `set_thopt_multiFFD`). The design
    vector concatenates the blocks' coefficient vectors; block k's
    evaluation matrix `Fs[k]` acts on its patches' rows `rows[k]` of the
    flat CP vector (`F @ x` on the system's device, a small dense
    product)."""

    def __init__(self, system, groups):
        """groups: list of dicts with keys 'patches' (indices), 'num_els',
        'p' and optionally 'lims'."""
        device = system.device
        metas = system.metas
        self.layout = CPLayout(metas, system.stack.max_cp, device)
        off = self.layout.offsets
        self.blocks, self.Fs, self.rows = [], [], []
        self.sizes, self.shapes = [], []
        for g in groups:
            _, ffd = _block_around([metas[i] for i in g["patches"]],
                                   g["num_els"], g["p"], g.get("lims"))
            rows = np.concatenate([np.arange(off[i], off[i + 1])
                                   for i in g["patches"]])
            self.blocks.append(ffd)
            self.Fs.append(tensor(ffd.F, device))
            self.rows.append(tensor(rows, device, torch.int64))
            self.sizes.append(ffd.n_ffd)
            self.shapes.append(ffd.shape)
        self.offsets = np.cumsum([0] + self.sizes)
        self.n_design = int(self.offsets[-1])

    def _block_field(self, k, xk, base):
        """`base` (n_flat,) with block k's rows set to F_k @ xk."""
        return base.index_copy(0, self.rows[k], self.Fs[k] @ xk)


class MultiThicknessFFD(_MultiFFDBase):
    """Concatenated per-block thickness coefficients -> padded (P, C)."""

    def init_h_ffd(self, h0) -> np.ndarray:
        return np.full(self.n_design, float(h0))

    def __call__(self, x):
        flat = x.new_zeros(self.layout.n_flat)
        for k in range(len(self.Fs)):
            flat = self._block_field(
                k, x[self.offsets[k]:self.offsets[k + 1]], flat)
        return self.layout.to_padded(flat)


class MultiShapeFFD(_MultiFFDBase):
    """Concatenated per-block, per-field coefficients -> (P, C, 3).

    Design layout: block by block, and field by field within a block
    ([block0_field_a, block0_field_b, ..., block1_...]). The CPs of the
    patches no block controls keep their initial values."""

    def __init__(self, system, groups, opt_fields=(0, 1, 2)):
        super().__init__(system, groups)
        self.opt_fields = tuple(opt_fields)
        self._cp0_flat = self.layout.to_flat(system.cp)
        self.n_design = self.n_design * len(self.opt_fields)

    def init_p_ffd(self) -> np.ndarray:
        return np.concatenate([ffd.p0[:, f] for ffd in self.blocks
                               for f in self.opt_fields])

    def __call__(self, x):
        cols = [self._cp0_flat[:, f] for f in range(3)]
        pos = 0
        for k, n in enumerate(self.sizes):
            for f in self.opt_fields:
                cols[f] = self._block_field(k, x[pos:pos + n], cols[f])
                pos += n
        return self.layout.to_padded(torch.stack(cols, dim=-1))
