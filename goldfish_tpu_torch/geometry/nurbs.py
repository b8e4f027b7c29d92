"""Generic NURBS container (host-side CAD object).

Replaces the igakit `NURBS` container used throughout the reference
(reference: GOLDFISH/utils/ffd_utils.py:100-124, cpiga2xi.py:336).
Control points are stored in homogeneous form (w*x, w*y, w*z, w) so the
refinement operators from `ops.refine` act linearly.
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.ops.bspline import basis_at_points, greville
from goldfish_tpu_torch.ops.refine import (
    degree_elevation_operator,
    refine_knots_operator,
)

__all__ = ["NURBS"]


class NURBS:
    """Tensor-product NURBS of parametric dimension 1..3 in R^3.

    control: (..., 4) homogeneous array, one leading axis per parametric
    dimension; knots: tuple of knot vectors; degree inferred from sizes.
    """

    def __init__(self, knots, control):
        self.knots = tuple(np.asarray(k, dtype=np.float64) for k in knots)
        control = np.asarray(control, dtype=np.float64)
        if control.shape[-1] == 3:  # non-rational input -> weights 1
            control = np.concatenate(
                [control, np.ones(control.shape[:-1] + (1,))], axis=-1
            )
        self.control = control
        assert control.ndim - 1 == len(self.knots)

    # ------------------------------------------------------------------
    @property
    def dim(self) -> int:
        return len(self.knots)

    @property
    def degree(self) -> tuple[int, ...]:
        return tuple(
            len(k) - self.control.shape[i] - 1 for i, k in enumerate(self.knots)
        )

    @property
    def shape(self) -> tuple[int, ...]:
        return self.control.shape[:-1]

    @property
    def weights(self) -> np.ndarray:
        return self.control[..., 3]

    @property
    def points(self) -> np.ndarray:
        """De-homogenized control points (..., 3)."""
        return self.control[..., :3] / self.control[..., 3:4]

    def copy(self) -> "NURBS":
        return NURBS([k.copy() for k in self.knots], self.control.copy())

    # ------------------------------------------------------------------
    def _apply_axis(self, A: np.ndarray, new_knots: np.ndarray, axis: int) -> "NURBS":
        ctrl = np.moveaxis(self.control, axis, 0)
        ctrl = np.tensordot(A, ctrl, axes=(1, 0))
        ctrl = np.moveaxis(ctrl, 0, axis)
        knots = list(self.knots)
        knots[axis] = new_knots
        return NURBS(knots, ctrl)

    def elevate(self, axis: int, t: int) -> "NURBS":
        if t <= 0:
            return self.copy()
        A, nk = degree_elevation_operator(self.knots[axis], self.degree[axis], t)
        return self._apply_axis(A, nk, axis)

    def refine(self, axis: int, new_knots) -> "NURBS":
        new_knots = np.asarray(new_knots, dtype=np.float64)
        if new_knots.size == 0:
            return self.copy()
        A, nk = refine_knots_operator(self.knots[axis], self.degree[axis], new_knots)
        return self._apply_axis(A, nk, axis)

    # ------------------------------------------------------------------
    def evaluate(self, *params) -> np.ndarray:
        """Evaluate at tensor-product parameter grids.

        evaluate(u) / evaluate(u, v) / evaluate(u, v, w) with 1D arrays;
        returns grid of physical points (..., 3).
        """
        assert len(params) == self.dim
        hom = self.control
        for axis, us in enumerate(params):
            us = np.atleast_1d(np.asarray(us, dtype=np.float64))
            p = self.degree[axis]
            spans, ders = basis_at_points(self.knots[axis], p, us, 0)
            n = self.control.shape[axis]
            B = np.zeros((len(us), n))
            for i, s in enumerate(spans):
                B[i, s - p: s + 1] = ders[i, 0]
            hom = np.moveaxis(np.tensordot(B, np.moveaxis(hom, axis, 0), axes=(1, 0)), 0, axis)
        return hom[..., :3] / hom[..., 3:4]

    def greville_points(self, axis: int) -> np.ndarray:
        return greville(self.knots[axis], self.degree[axis])

    def bounds(self) -> tuple[np.ndarray, np.ndarray]:
        pts = self.points.reshape(-1, 3)
        return pts.min(axis=0), pts.max(axis=0)
