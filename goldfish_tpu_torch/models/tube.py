"""Four-patch tube (quarter cylinders, exact rational geometry).

Port of goldfish_tpu/models/tube.py (constants and `build`, copied host
code): a circular tube split into 4 penalty-coupled quarter patches along
axial seams, clamped at one end, loaded by internal follower pressure or a
tip force. Each patch is `cadkit.revolve` of an axial line: degree p along
the axis (u), rational degree 2 around it (v).
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.geometry.cadkit import line, revolve
from goldfish_tpu_torch.physics.coupling import InterfaceSpec
from goldfish_tpu_torch.solver.system import NonMatchingSystem

__all__ = ["E", "NU", "H_TH", "RADIUS", "LENGTH", "surfaces", "seam_specs",
           "build"]

E = 2.0e9
NU = 0.3
H_TH = 5.0e-3
RADIUS = 0.5
LENGTH = 3.0


def surfaces(num_el: int = 4, p: int = 3):
    """The four quarter-cylinder patches (odd patches one element finer)."""
    surfs = []
    for k in range(4):
        gen = line([RADIUS, 0.0, 0.0], [RADIUS, 0.0, LENGTH])
        s = revolve(gen, point=(0, 0, 0), axis=(0, 0, 1),
                    angle=(k * np.pi / 2, (k + 1) * np.pi / 2))
        # u: axial (degree 1 -> elevate), v: circumferential (rational,
        # keep degree 2 and refine)
        s = s.elevate(0, p - s.degree[0])
        ne_u = num_el + (k % 2)
        s = s.refine(0, np.linspace(0, 1, 2 * ne_u + 1)[1:-1])
        s = s.refine(1, np.linspace(0, 1, ne_u + 1)[1:-1])
        surfs.append(s)
    return surfs


def seam_specs(num_el: int = 4):
    """The four axial seams: patch k's v = 1 edge against patch k+1's v = 0
    edge."""
    return [InterfaceSpec(
        pair=(k, (k + 1) % 4),
        xi_ends_A=np.array([[0.0, 1.0], [1.0, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [1.0, 0.0]]),
        n_mortar_el=2 * num_el + 2) for k in range(4)]


def build(num_el: int = 4, p: int = 3, penalty_coefficient: float = 1.0e3,
          pressure: float = 0.0, tip_force=None, device=None):
    """The fixed-seam tube, clamped at z = 0 (two CP layers), with an
    optional follower pressure and a tip force spread over the four free
    edges."""
    sys = NonMatchingSystem(surfaces(num_el, p), E, NU, H_TH,
                            specs=seam_specs(num_el),
                            penalty_coefficient=penalty_coefficient,
                            device=device)
    for k in range(4):
        sys.add_side_bc(k, direction=0, side=0, n_layers=2)  # clamp z=0
    if pressure:
        sys.set_pressure([pressure] * 4)
    if tip_force is not None:
        for k in range(4):
            sys.add_edge_load(k, direction=0, side=1,
                              force=np.asarray(tip_force) / 4.0)
    return sys
