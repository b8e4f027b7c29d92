"""Free-form deformation design parametrization.

TPU-native equivalent of the reference's FFD layer (reference:
GOLDFISH/utils/ffd_utils.py `CP_FFD_matrix`/`create_3D_block`,
GOLDFISH/nonmatching_opt_ffd.py `set_shopt_FFD`/`set_thopt_FFD`): a
trivariate B-spline block encloses the shell control points; the design
variables are the block's control coefficients, and surface CPs follow
by evaluating the volume basis at each surface CP's (frozen) parametric
location inside the block. That evaluation is one constant dense matrix
F with

    cp_surf = F @ p_ffd          (per spatial field, or thickness)

built once on the host. Because the block from `create_3D_block` has
control points at Greville positions, B-spline linear precision gives
F @ p_ffd_init == cp_surf_init exactly (no least-squares init needed
for shape; thickness uses the same identity).

DoF ordering inside a block is x-fastest: dof = i + j*nx + k*nx*ny,
matching the reference's `ijk2dof` (GOLDFISH/nonmatching_opt_ffd.py:6-7).
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.ops.bspline import basis_at_points, greville

__all__ = ["create_3D_block", "ffd_eval_matrix", "FFDBlock"]


def _uniform_open_knots(n_el: int, p: int) -> np.ndarray:
    interior = np.linspace(0.0, 1.0, n_el + 1)[1:-1]
    return np.concatenate([np.zeros(p + 1), interior, np.ones(p + 1)])


def create_3D_block(num_els, p, lims) -> NURBS:
    """Trivariate B-spline block spanning an axis-aligned box.

    num_els: (3,) elements per direction; p: degree (scalar or (3,));
    lims: (3, 2) [min, max] per axis. Control points sit at Greville
    abscissae scaled into the box, so the block parametrizes the
    identity map (linear precision). Mirrors the role of
    `create_3D_block` (reference: GOLDFISH/utils/ffd_utils.py:69-124)
    without igakit's line/extrude/elevate chain.
    """
    num_els = np.broadcast_to(np.asarray(num_els, dtype=np.int64), (3,))
    degs = np.broadcast_to(np.asarray(p, dtype=np.int64), (3,))
    lims = np.asarray(lims, dtype=np.float64).reshape(3, 2)

    knots = [_uniform_open_knots(int(num_els[a]), int(degs[a]))
             for a in range(3)]
    grevs = [greville(knots[a], int(degs[a])) for a in range(3)]
    coords = [lims[a, 0] + (lims[a, 1] - lims[a, 0]) * grevs[a]
              for a in range(3)]
    X, Y, Z = np.meshgrid(coords[0], coords[1], coords[2], indexing="ij")
    ctrl = np.stack([X, Y, Z], axis=-1)
    return NURBS(knots, ctrl)


def _basis_matrix_1d(knots: np.ndarray, p: int, us: np.ndarray) -> np.ndarray:
    """(n_pts, n_basis) dense univariate basis evaluation."""
    n = len(knots) - p - 1
    spans, ders = basis_at_points(knots, p, us, 0)
    B = np.zeros((len(us), n))
    for i, s in enumerate(spans):
        B[i, s - p: s + 1] = ders[i, 0]
    return B


def ffd_eval_matrix(block: NURBS, points: np.ndarray) -> np.ndarray:
    """Dense (n_pts, n_ffd) trivariate basis evaluation matrix.

    points: (n, 3) physical locations inside the block's bounding box;
    they are normalized per-axis into the block's [0, 1]^3 parameter
    space (the reference's `scale_knots` + `CP_FFD_matrix` combination,
    GOLDFISH/utils/ffd_utils.py:10-67). dof order is x-fastest.
    """
    assert block.dim == 3
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    lo, hi = block.bounds()
    span = np.where(hi - lo > 1e-14, hi - lo, 1.0)
    uvw = np.clip((pts - lo) / span, 0.0, 1.0)

    Bs = [_basis_matrix_1d(block.knots[a], block.degree[a], uvw[:, a])
          for a in range(3)]
    nx, ny, nz = block.shape
    # control indexing in NURBS is [i, j, k]; flatten x-fastest:
    # dof = i + j*nx + k*nx*ny
    F = np.einsum("ni,nj,nk->nijk", Bs[0], Bs[1], Bs[2])
    F = np.transpose(F, (0, 3, 2, 1)).reshape(len(pts), nx * ny * nz)
    return F


class FFDBlock:
    """Host-side FFD design map for a set of shell patches.

    Freezes each patch CP's parametric location in the block, exposing

      cp_flat(x) = F @ x     per field, x = flattened block coefficients

    F is (n_total_surface_cp, n_ffd) dense; products run on the MXU
    inside jitted design pipelines. dof order x-fastest (`ijk2dof`).
    """

    def __init__(self, block: NURBS, cp_surf: np.ndarray):
        """cp_surf: (n_total_cp, 3) stacked initial surface CPs."""
        self.block = block
        self.shape = block.shape
        self.n_ffd = int(np.prod(block.shape))
        self.F = ffd_eval_matrix(block, cp_surf)
        # initial block coefficients per field, x-fastest
        pts = block.points  # (nx, ny, nz, 3)
        self.p0 = np.stack(
            [np.transpose(pts[..., f], (2, 1, 0)).ravel() for f in range(3)],
            axis=-1,
        )  # (n_ffd, 3)
        # linear precision check: F @ p0 reproduces the input CPs
        err = np.abs(self.F @ self.p0 - cp_surf).max()
        scale = max(np.abs(cp_surf).max(), 1.0)
        assert err <= 1e-9 * scale, (
            f"FFD block does not reproduce surface CPs (err {err:.2e}); "
            "are all CPs inside the block?")
