"""Linear design-space constraint operators on FFD / surface CP grids.

A NumPy copy of goldfish_tpu/design/constraints.py (`grid_dof`,
`align_operator`, `align_expansion_operator`, `pin_operator`,
`regu_operator`): small dense host matrices, applied as matrix products
inside constraint functions.

Grid dof order is x-fastest (dof = i + j*nx + k*nx*ny).
"""

from __future__ import annotations

import numpy as np

__all__ = ["grid_dof", "align_operator", "align_expansion_operator",
           "pin_operator", "regu_operator"]


def grid_dof(i, j, k, nx, ny):
    """Flat dof of grid index (i, j, k), x-fastest."""
    return i + j * nx + k * nx * ny


def _axes_iter(shape, axis):
    """Yield index tuples sweeping `axis` with the others fixed."""
    nx, ny, nz = shape
    other = [r for a, r in enumerate((range(nx), range(ny), range(nz)))
             if a != axis]
    for b in other[0]:
        for c in other[1]:
            line = []
            for t in range(shape[axis]):
                idx = [b, c]
                idx.insert(axis, t)
                line.append(tuple(idx))
            yield line


def align_operator(shape, axis) -> np.ndarray:
    """Rows force equality of coefficients along the given axis (or axes):
    A @ x = 0 <=> x constant along each grid line/slab. The rows are
    linearly independent (first-vs-rest within each equivalence group), so
    SLSQP's meq <= n holds when aligning along several axes at once."""
    nx, ny, nz = shape
    axes = (axis,) if np.ndim(axis) == 0 else tuple(axis)
    n = nx * ny * nz
    groups = {}
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                key = tuple(c for a, c in enumerate((i, j, k))
                            if a not in axes)
                groups.setdefault(key, []).append(grid_dof(i, j, k, nx, ny))
    rows = []
    for dofs in groups.values():
        for other in dofs[1:]:
            r = np.zeros(n)
            r[dofs[0]] = 1.0
            r[other] = -1.0
            rows.append(r)
    return np.stack(rows) if rows else np.zeros((0, n))


def align_expansion_operator(shape, axis):
    """The alignment constraint in expansion form: one design dof per
    aligned grid line (or slab), broadcast to every member, as the
    reference's multi-FFD drivers do it (the design space has fewer dofs
    instead of A @ x = 0 rows). Returns (A, reps): A is (n_full, n_design);
    `reps` are the representative full-grid dofs (x-fastest order) whose
    initial values seed the design vector (x_full0[reps] == design0)."""
    nx, ny, nz = shape
    axes = (axis,) if np.ndim(axis) == 0 else tuple(axis)
    groups = {}
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                key = tuple(c for a, c in enumerate((i, j, k))
                            if a not in axes)
                groups.setdefault(key, []).append(grid_dof(i, j, k, nx, ny))
    A = np.zeros((nx * ny * nz, len(groups)))
    reps = np.empty(len(groups), dtype=int)
    for col, dofs in enumerate(groups.values()):
        A[dofs, col] = 1.0
        reps[col] = dofs[0]
    return A, reps


def pin_operator(shape, pinned) -> np.ndarray:
    """Selection rows for pinned grid dofs; the constraint is P @ x = P @ x0.
    `pinned` is an iterable of (i, j, k) triples or flat dofs."""
    nx, ny, nz = shape
    n = nx * ny * nz
    rows = []
    for p in pinned:
        d = grid_dof(*p, nx, ny) if np.ndim(p) else int(p)
        r = np.zeros(n)
        r[d] = 1.0
        rows.append(r)
    return np.stack(rows) if rows else np.zeros((0, n))


def regu_operator(shape, axis) -> np.ndarray:
    """First-difference rows along `axis`: (D @ x)_m = x_{t+1} - x_t; used as
    D @ x >= eps to keep the CP spacing monotone and non-degenerate."""
    nx, ny, nz = shape
    rows = []
    for line in _axes_iter(shape, axis):
        for a, b in zip(line[:-1], line[1:]):
            r = np.zeros(nx * ny * nz)
            r[grid_dof(*b, nx, ny)] = 1.0
            r[grid_dof(*a, nx, ny)] = -1.0
            rows.append(r)
    return np.stack(rows) if rows else np.zeros((0, nx * ny * nz))
