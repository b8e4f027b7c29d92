"""Multi-patch cantilever plate: the thickness-optimization demo geometry.

Port of goldfish_tpu/models/plate.py (constants and `build`, copied host
code): a rectangular plate split into num_patches bilinear strips along x,
elevated to degree p with deliberately non-matching per-strip element
counts (penalty-coupled), clamped at x = 0 (two CP layers) and loaded by a
dead line load on the far edge.
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.geometry.cadkit import bilinear
from goldfish_tpu_torch.physics.coupling import InterfaceSpec
from goldfish_tpu_torch.solver.system import NonMatchingSystem

__all__ = ["E", "NU", "H_TH", "LENGTH", "WIDTH", "EDGE_LOAD", "build"]

E = 68.0e9       # Pa
NU = 0.35
H_TH = 1.0e-2    # m
LENGTH = 1.0     # plate x-extent
WIDTH = 1.0      # plate y-extent
EDGE_LOAD = -100.0  # N/m, z, far edge


def build(num_el: int = 4, p: int = 3, num_patches: int = 4,
          penalty_coefficient: float = 1.0e3, device=None):
    """The plate on `device` (None: the current CUDA device)."""
    dx = LENGTH / num_patches
    surfs = []
    for i in range(num_patches):
        x0, x1 = i * dx, (i + 1) * dx
        s = bilinear([x0, 0, 0], [x1, 0, 0], [x0, WIDTH, 0], [x1, WIDTH, 0])
        s = s.elevate(0, p - 1).elevate(1, p - 1)
        ne0 = num_el + (i % 2)      # non-matching element counts
        ne1 = num_el + ((i + 1) % 2)
        s = s.refine(0, np.linspace(0, 1, ne0 + 1)[1:-1])
        s = s.refine(1, np.linspace(0, 1, ne1 + 1)[1:-1])
        surfs.append(s)

    specs = []
    for i in range(num_patches - 1):
        specs.append(InterfaceSpec(
            pair=(i, i + 1),
            xi_ends_A=np.array([[1.0, 0.0], [1.0, 1.0]]),
            xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
            n_mortar_el=2 * (num_el + 2)))

    sys_ = NonMatchingSystem(surfs, E, NU, H_TH, specs=specs,
                             penalty_coefficient=penalty_coefficient,
                             device=device)
    # clamp the x = 0 edge of patch 0, two CP layers
    sys_.add_side_bc(0, direction=0, side=0, n_layers=2)
    # dead line load on the far edge of the last patch
    sys_.add_edge_load(num_patches - 1, direction=0, side=1,
                       force=[0.0, 0.0, EDGE_LOAD])
    return sys_
