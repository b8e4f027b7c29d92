"""Design -> analysis control-point pipeline (CPSurfDesign2Analysis).

Port of goldfish_tpu/design/cp_design.py, a NumPy copy on the port's own
ops/bspline and ops/refine: each optimized surface gets a coarse design
control grid; the map to the analysis grid is order elevation then knot
refinement, both exact linear operators, composed into one constant matrix
per surface. Design-level align / pin / regu / inter-surface-distance
constraint operators act on the coarse grid (the reference's
set_cp_align, set_cp_pin, set_cp_regu and set_cp_dist).
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.ops.bspline import open_uniform_knots
from goldfish_tpu_torch.ops.refine import (
    degree_elevation_operator,
    refine_knots_operator,
    surface_operator,
)

__all__ = ["CPSurfDesign2Analysis"]


def _sub_multiset(small, big, tol=1e-12):
    out = []
    j = 0
    big = sorted(big)
    for x in sorted(small):
        while j < len(big) and big[j] < x - tol:
            out.append(big[j])
            j += 1
        if j < len(big) and abs(big[j] - x) <= tol:
            j += 1
        else:
            return None  # not a sub-multiset
    out.extend(big[j:])
    return np.asarray(out)


class CPSurfDesign2Analysis:
    """Per-surface coarse-design parametrization of analysis CPs."""

    def __init__(self, surfs, design_nel=(2, 2), design_degree=None,
                 surf_inds=None):
        self.surfs = surfs
        self.surf_inds = list(range(len(surfs))) if surf_inds is None \
            else list(surf_inds)
        self.ops = {}          # surf index -> (n_analysis, n_design) matrix
        self.elev_ops = {}     # order-elevation stage (design -> elevated)
        self.refine_ops = {}   # knot-refinement stage (elevated -> analysis)
        self.design_shapes = {}
        for i in self.surf_inds:
            s = surfs[i]
            p_an = s.degree
            p_de = p_an if design_degree is None else tuple(
                np.broadcast_to(design_degree, (2,)))
            Es, Rs = [], []
            shape = []
            for ax in range(2):
                kd = open_uniform_knots(p_de[ax], int(
                    np.broadcast_to(design_nel, (2,))[ax]))
                E, ke = degree_elevation_operator(
                    kd, p_de[ax], p_an[ax] - p_de[ax])
                add = _sub_multiset(ke, s.knots[ax])
                assert add is not None, (
                    f"analysis knots of surface {i} axis {ax} do not "
                    "contain the elevated design knots; choose design_nel "
                    "dividing the analysis refinement")
                R, kr = refine_knots_operator(ke, p_an[ax], add)
                assert np.allclose(kr, s.knots[ax])
                Es.append(E)
                Rs.append(R)
                shape.append(len(kd) - p_de[ax] - 1)
            self.elev_ops[i] = surface_operator(Es[0], Es[1])
            self.refine_ops[i] = surface_operator(Rs[0], Rs[1])
            self.ops[i] = self.refine_ops[i] @ self.elev_ops[i]
            self.design_shapes[i] = tuple(shape)

    # ------------------------------------------------------------- maps
    def matrix(self, i) -> np.ndarray:
        return self.ops[i]

    def elevation_matrix(self, i) -> np.ndarray:
        """Order-elevation stage alone (reference
        surface_order_elevation_operator, bsp_utils.py:573-620 /
        CPSurfOrderElevationComp)."""
        return self.elev_ops[i]

    def refinement_matrix(self, i) -> np.ndarray:
        """Knot-refinement stage alone (reference
        surface_knot_refine_operator, bsp_utils.py:516-555 /
        CPSurfKnotRefienmentComp)."""
        return self.refine_ops[i]

    def n_design(self, i) -> int:
        return int(np.prod(self.design_shapes[i]))

    def init_design_cp(self, i, field) -> np.ndarray:
        """Least-squares fit of the current analysis CPs
        (reference `get_init_cp_coarse`, bsp_utils.py:1042-1053)."""
        A = self.ops[i]
        target = self.surfs[i].points.reshape(-1, 3)[:, field]
        x, *_ = np.linalg.lstsq(A, target, rcond=None)
        return x

    def apply(self, i, x_design):
        """Design grid -> flat analysis CPs (one field)."""
        return self.ops[i] @ x_design

    # ------------------------------------------------ constraint rows
    # Design grids are row-major: dof = i_u * n_v + i_v.
    def _dof(self, i, iu, iv):
        return iu * self.design_shapes[i][1] + iv

    def align_rows(self, i, axis) -> np.ndarray:
        """Equality along `axis` (0 = u, 1 = v): first-vs-rest rows
        (reference set_cp_align)."""
        nu, nv = self.design_shapes[i]
        n = nu * nv
        rows = []
        outer, inner = (nv, nu) if axis == 0 else (nu, nv)
        for a in range(outer):
            line = [self._dof(i, t, a) if axis == 0 else self._dof(i, a, t)
                    for t in range(inner)]
            for other in line[1:]:
                r = np.zeros(n)
                r[line[0]] = 1.0
                r[other] = -1.0
                rows.append(r)
        return np.stack(rows) if rows else np.zeros((0, n))

    def pin_rows(self, i, pinned) -> np.ndarray:
        """Selection rows for pinned design dofs; `pinned` is (iu, iv)
        pairs or flat dofs (reference set_cp_pin)."""
        n = self.n_design(i)
        rows = []
        for p in pinned:
            d = self._dof(i, *p) if np.ndim(p) else int(p)
            r = np.zeros(n)
            r[d] = 1.0
            rows.append(r)
        return np.stack(rows) if rows else np.zeros((0, n))

    def regu_rows(self, i, axis) -> np.ndarray:
        """Consecutive differences along `axis` (reference
        set_cp_regu): use as A @ x >= eps."""
        nu, nv = self.design_shapes[i]
        n = nu * nv
        rows = []
        rng_u, rng_v = range(nu), range(nv)
        for iu in rng_u:
            for iv in rng_v:
                if axis == 0 and iu + 1 < nu:
                    a, b = self._dof(i, iu, iv), self._dof(i, iu + 1, iv)
                elif axis == 1 and iv + 1 < nv:
                    a, b = self._dof(i, iu, iv), self._dof(i, iu, iv + 1)
                else:
                    continue
                r = np.zeros(n)
                r[b] = 1.0
                r[a] = -1.0
                rows.append(r)
        return np.stack(rows) if rows else np.zeros((0, n))

    def dist_rows(self, i, j) -> np.ndarray:
        """Pairwise difference rows between two surfaces' design grids
        of EQUAL shape: r = x_i - x_j over [x_i; x_j] (reference
        set_cp_dist)."""
        assert self.design_shapes[i] == self.design_shapes[j]
        n = self.n_design(i)
        return np.concatenate([np.eye(n), -np.eye(n)], axis=1)
