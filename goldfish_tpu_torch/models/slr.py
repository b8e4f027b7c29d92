"""Scordelis-Lo roof, built from 9 non-matching patches.

Port of goldfish_tpu/models/slr.py (constants, `roof_patch`, `build` and
`solve_qoi`, copied host code): a cylindrical roof of radius 25, length 50,
80-degree opening, under a vertical dead load of 90 per unit area, rigid
diaphragms at both ends, split into 3 x 3 rational patches with
deliberately NON-MATCHING element counts, penalty-coupled. Published QoI:
the vertical displacement magnitude 0.3006 at the free-edge midpoint (the
reference's tests/test_slr.py), in the linear regime (`solve_qoi`'s small
load scale).
"""

from __future__ import annotations

import numpy as np

from goldfish_tpu_torch.geometry.cadkit import circle, ruled
from goldfish_tpu_torch.physics.coupling import InterfaceSpec
from goldfish_tpu_torch.solver.system import NonMatchingSystem

__all__ = ["QOI_REF", "L", "R", "E", "NU", "H_TH", "AREAL_FORCE",
           "roof_patch", "build", "solve_qoi"]

QOI_REF = 0.3006

L = 50.0
R = 25.0
E = 4.32e8
NU = 0.0
H_TH = 0.25
AREAL_FORCE = 90.0


def roof_patch(num_el, p, angle_lim_deg, z_lim):
    a = (np.deg2rad(angle_lim_deg[0]), np.deg2rad(angle_lim_deg[1]))
    c0 = circle(center=[0, 0, z_lim[0]], radius=R, angle=a)
    c1 = circle(center=[0, 0, z_lim[1]], radius=R, angle=a)
    s = ruled(c0, c1)
    s = s.elevate(0, p - s.degree[0]).elevate(1, p - s.degree[1])
    nk = np.linspace(0, 1, num_el + 1)[1:-1]
    return s.refine(0, nk).refine(1, nk)


def build(num_el: int = 6, p: int = 3, penalty_coefficient: float = 1.0e3,
          load_scale: float = 1.0, device=None):
    """The 9-patch system with the reference's exact layout, every tensor
    on `device` (the current CUDA device when None; pass device="cpu" for
    the plain CPU path)."""
    angles = [50, 80, 100, 130]
    angle_lims = [angles[0:2], angles[1:3], angles[2:4]] * 3
    z_vals = [0, L / 4, 3 * L / 4, L]
    z_lims = [z_vals[0:2]] * 3 + [z_vals[1:3]] * 3 + [z_vals[2:4]] * 3
    # per-patch element counts (deliberately non-matching)
    nels = [num_el, num_el - 2, num_el - 1,
            num_el + 2, num_el + 1, num_el + 3,
            num_el - 1, num_el, num_el - 2]
    surfs = [roof_patch(nels[i], p, angle_lims[i], z_lims[i])
             for i in range(9)]

    # interfaces: vertical (shared angular edge, segment along v) for
    # in-row neighbors; horizontal (shared z edge, along u) across rows
    mapping = [[0, 1], [1, 2], [3, 4], [4, 5], [6, 7], [7, 8],
               [0, 3], [3, 6], [1, 4], [4, 7], [2, 5], [5, 8]]
    v_locs = (np.array([[1.0, 0.0], [1.0, 1.0]]),
              np.array([[0.0, 0.0], [0.0, 1.0]]))
    h_locs = (np.array([[0.0, 1.0], [1.0, 1.0]]),
              np.array([[0.0, 0.0], [1.0, 0.0]]))
    specs = []
    for j, (iA, iB) in enumerate(mapping):
        locs = v_locs if j < 6 else h_locs
        n_m = 2 * (nels[iA] + nels[iB])
        specs.append(InterfaceSpec(
            pair=(iA, iB), xi_ends_A=locs[0], xi_ends_B=locs[1],
            n_mortar_el=n_m))

    sys = NonMatchingSystem(surfs, E, NU, H_TH, specs=specs,
                            penalty_coefficient=penalty_coefficient,
                            device=device)

    # rigid diaphragm BCs: u_x = u_y = 0 at z=0 (patches 0-2, side v=0)
    # and z=L (patches 6-8, side v=1); one z-pin kills the rigid mode
    for ip in range(3):
        sys.add_side_bc(ip, direction=1, side=0, n_layers=1, fields=(0, 1))
    for ip in range(6, 9):
        sys.add_side_bc(ip, direction=1, side=1, n_layers=1, fields=(0, 1))
    sys.add_zero_dofs(0, [0], fields=(2,))

    sys.set_dead_load([0.0, -AREAL_FORCE * load_scale, 0.0])
    return sys


def solve_qoi(sys: NonMatchingSystem | None = None, load_scale: float = 1e-3,
              **kw):
    """Solve and return (QoI, d, sys): the free-edge midpoint vertical
    displacement magnitude normalized by load_scale. The published 0.3006 is
    the LINEAR response; the small default load_scale recovers it (at the
    nominal load the geometrically nonlinear answer is ~0.2535)."""
    sys = sys or build(load_scale=load_scale, **kw)
    d = sys.solve_nonlinear()
    # free edge theta = 50 deg is u = 0 on patches 0, 3, 6; the roof's
    # midpoint lies on patch 3 (z in [L/4, 3L/4]) at v = 0.5
    u = sys.evaluate_displacement(d, 3, [0.0, 0.5])
    return float(abs(u[1])) / load_scale, d, sys
