"""Two-patch T-beam: the reference's canonical coupling fixture.

Port of goldfish_tpu/models/tbeam.py (constants and `create_surf`, copied
host code). A flange (width 2 in x, length 20 in y) and a web (depth 2
downward in z, same length) whose midline/top-edge intersection runs the
full length; both patches clamped at y = 0; tip point load in z at the
flange corner xi = (1, 1). Deliberately non-matching element counts
(num_el vs num_el + 1).

`build` is the fixed-intersection system; `build_mi` the
moving-intersection one of scripts/bench_mi.py (the seam sits on the
flange's knot line xi_u = 0.5 and on the web's edge xi_u = 0, sampled by
`n_pts` points).
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.geometry.cadkit import line, ruled
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.physics.coupling import InterfaceSpec
from goldfish_tpu_torch.solver.system import NonMatchingSystem

__all__ = ["E", "NU", "H_TH", "LENGTH", "WIDTH", "DEPTH", "create_surf",
           "build", "build_mi"]

E = 1.0e7
NU = 0.0
H_TH = 0.1
LENGTH = 20.0
WIDTH = 2.0
DEPTH = 2.0


def create_surf(pts, num_el0, num_el1, p) -> NURBS:
    """Ruled surface between line(pts[0], pts[1]) and line(pts[2], pts[3]),
    elevated to degree p, refined to (num_el0, num_el1) elements."""
    s = ruled(line(pts[0], pts[1]), line(pts[2], pts[3]))
    p0, p1 = s.degree
    s = s.elevate(0, p - p0).elevate(1, p - p1)
    s = s.refine(0, np.linspace(0, 1, num_el0 + 1)[1:-1])
    s = s.refine(1, np.linspace(0, 1, num_el1 + 1)[1:-1])
    return s


def _surfs(num_el: int, p: int):
    w2 = WIDTH / 2.0
    pts0 = [[-w2, 0.0, 0.0], [w2, 0.0, 0.0],
            [-w2, LENGTH, 0.0], [w2, LENGTH, 0.0]]
    pts1 = [[0.0, 0.0, 0.0], [0.0, 0.0, -DEPTH],
            [0.0, LENGTH, 0.0], [0.0, LENGTH, -DEPTH]]
    srf0 = create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = create_surf(pts1, max((num_el + 1) // 2, 1), num_el + 1, p)
    return [srf0, srf1]


def _seam(n_mortar_el: int) -> InterfaceSpec:
    """Flange u = 0.5 line <-> web u = 0 line, both along v."""
    return InterfaceSpec(pair=(0, 1),
                         xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
                         xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                         n_mortar_el=n_mortar_el)


def _clamp_and_load(sys, tip_load):
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, tip_load])
    return sys


def build(num_el: int = 10, p: int = 3, penalty_coefficient: float = 1.0e3,
          tip_load: float = 10.0, device=None):
    """The 2-patch T-beam with a fixed intersection (2 (num_el + 1) mortar
    elements)."""
    sys = NonMatchingSystem(_surfs(num_el, p), E, NU, H_TH,
                            specs=[_seam(2 * (num_el + 1))],
                            penalty_coefficient=penalty_coefficient,
                            device=device)
    return _clamp_and_load(sys, tip_load)


def build_mi(num_el: int = 40, p: int = 3, n_pts: int = 17,
             penalty_coefficient: float = 1.0e3, tip_load: float = 10.0,
             device=None):
    """The T-beam with a moving intersection of `n_pts` points (defaults:
    scripts/bench_mi.py's NUM_EL=40, P_DEG=3, N_PTS=17)."""
    from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

    sys = MINonMatchingSystem(_surfs(num_el, p), E, NU, H_TH,
                              specs=[_seam(n_pts - 1)], n_pts_list=[n_pts],
                              penalty_coefficient=penalty_coefficient,
                              device=device)
    return _clamp_and_load(sys, tip_load)
