"""eVTOL-class wing shape optimization with moving spar and rib seams
through the OpenMDAO graph.

Port of demos/evtol_wing_shopt_mi.py (the reference's
evtol_wing_shopt_{rspar_rrib,rspar_srib,sspar_srib,qspar_rrib,
rspar_rrib_outer} family and its custom align comps): a tapered, swept
4-patch wing box (upper skin, lower skin, spar web, rib) whose spar and rib
positions are the design variables. The spar-skin and rib-skin
intersections are design-dependent seams, solved by the implicit CP -> xi
map (`CPIGA2XiComp`) and differentiated through both implicit solves.

`EvtolSparRibAlignComp` is one affine map from the design dofs to the full
flat CP vector with constant partials: the rib's x control points follow
its spanwise station through the planform's leading/trailing-edge lines,
the spar's x field the chord-fraction interpolation. Variant = spar mode x
rib mode:

  rspar : rigid spar     - 2 dofs, chord fraction at root + tip
  sspar : straight spar  - 4 dofs, root/tip x bottom/top (the web leans)
  qspar : quadratic spar - 6 dofs, root/mid/tip x bottom/top
  rrib  : rigid rib      - 1 dof, spanwise station
  srib  : straight rib   - 2 dofs, front/rear stations (the rib skews)

`rspar_rrib_outer` also frees the outer mold line: a degree-p Bernstein
spanwise height profile z_top(y) whose exact knot-insertion images drive
the upper-skin z CPs, the spar web's z field and the rib's top edge
together, so the edge-pinned seams stay exactly coincident for any
profile; the rib station is pinned in that variant.

    python -m goldfish_tpu_torch.demos.evtol_wing_shopt_mi
        [--variant rspar_rrib] [--num-el 4] [--p 3] [--maxiter 6]
        [--device cpu]
"""

from __future__ import annotations

import argparse
from math import comb

import numpy as np

try:
    import openmdao.api as om
except ModuleNotFoundError:
    from goldfish_tpu_torch.om_shim import api as om

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.geometry.cadkit import line, ruled
from goldfish_tpu_torch.om_comps.components import (
    CPIGA2XiComp,
    DispMintStatesComp,
    IntEnergyComp,
    IntXiEdgeComp,
    _LinearMapComp,
)
from goldfish_tpu_torch.ops.refine import refine_knots_operator
from goldfish_tpu_torch.physics.coupling import InterfaceSpec
from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

__all__ = ["E", "NU", "H_TH", "HALF_SPAN", "ROOT_CHORD", "TAPER", "SWEEP",
           "BOX_H", "LOAD", "VARIANTS", "build_system", "design_map",
           "EvtolSparRibAlignComp", "ShapeOptGroup", "build_problem",
           "main"]

E = 70.0e9
NU = 0.33
H_TH = 4.0e-3
HALF_SPAN = 4.0
ROOT_CHORD = 1.2
TAPER = 0.55
SWEEP = 0.5          # leading-edge x shift at the tip
BOX_H = 0.12         # skin-to-skin height
LOAD = -80.0         # upper-skin dead load (N/m^2), downward

VARIANTS = ("rspar_rrib", "rspar_srib", "sspar_srib", "qspar_rrib",
            "qspar_srib", "rspar_rrib_outer")


def _x_le(y):
    return SWEEP * y / HALF_SPAN


def _chord(y):
    return ROOT_CHORD * (1.0 - (1.0 - TAPER) * y / HALF_SPAN)


def _surf(c0_pts, c1_pts, ne0, ne1, p):
    s = ruled(line(*c0_pts), line(*c1_pts))
    p0, p1 = s.degree
    s = s.elevate(0, p - p0).elevate(1, p - p1)
    s = s.refine(0, np.linspace(0, 1, ne0 + 1)[1:-1])
    return s.refine(1, np.linspace(0, 1, ne1 + 1)[1:-1])


def build_system(s_root=0.30, s_tip=0.30, y_rib_frac=0.45, num_el=4,
                 p=3, penalty_coefficient=1.0e3, h_th=H_TH, device=None):
    """The 4-patch wing box at the initial design (patches: 0 upper skin,
    1 lower skin, 2 spar, 3 rib), clamped at the root, the upper skin
    under a downward dead load; on `device` (None: the current CUDA
    device)."""
    L = HALF_SPAN
    y_r = y_rib_frac * L

    def le(y, z):
        return [_x_le(y), y, z]

    def te(y, z):
        return [_x_le(y) + _chord(y), y, z]

    def xs(y, s):
        return _x_le(y) + s * _chord(y)

    up = _surf((le(0, BOX_H), te(0, BOX_H)), (le(L, BOX_H), te(L, BOX_H)),
               num_el, 2 * num_el, p)
    lo = _surf((le(0, 0.0), te(0, 0.0)), (le(L, 0.0), te(L, 0.0)),
               num_el, 2 * num_el, p)
    spar = _surf(([xs(0, s_root), 0, 0.0], [xs(0, s_root), 0, BOX_H]),
                 ([xs(L, s_tip), L, 0.0], [xs(L, s_tip), L, BOX_H]),
                 max(num_el // 2, 1), 2 * num_el + 1, p)
    rib = _surf(([_x_le(y_r), y_r, 0.0],
                 [_x_le(y_r) + _chord(y_r), y_r, 0.0]),
                ([_x_le(y_r), y_r, BOX_H],
                 [_x_le(y_r) + _chord(y_r), y_r, BOX_H]),
                num_el + 1, max(num_el // 2, 1), p)

    vr = y_rib_frac
    n_pts = 2 * num_el + 3
    specs = [
        # the spar's top and bottom edges in the skins (the seams move
        # with s_root / s_tip)
        InterfaceSpec(pair=(0, 2),
                      xi_ends_A=np.array([[s_root, 0.0], [s_tip, 1.0]]),
                      xi_ends_B=np.array([[1.0, 0.0], [1.0, 1.0]]),
                      n_mortar_el=n_pts - 1),
        InterfaceSpec(pair=(1, 2),
                      xi_ends_A=np.array([[s_root, 0.0], [s_tip, 1.0]]),
                      xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                      n_mortar_el=n_pts - 1),
        # the rib's top and bottom edges in the skins (they move with the
        # rib station)
        InterfaceSpec(pair=(0, 3),
                      xi_ends_A=np.array([[0.0, vr], [1.0, vr]]),
                      xi_ends_B=np.array([[0.0, 1.0], [1.0, 1.0]]),
                      n_mortar_el=n_pts - 1),
        InterfaceSpec(pair=(1, 3),
                      xi_ends_A=np.array([[0.0, vr], [1.0, vr]]),
                      xi_ends_B=np.array([[0.0, 0.0], [1.0, 0.0]]),
                      n_mortar_el=n_pts - 1),
    ]
    sys = MINonMatchingSystem([up, lo, spar, rib], E, NU, h_th,
                              specs=specs, n_pts_list=[n_pts] * len(specs),
                              penalty_coefficient=penalty_coefficient,
                              device=device)
    for ip in (0, 1, 2):
        sys.add_side_bc(ip, direction=1, side=0, n_layers=2)
    sys.set_dead_load([[0.0, 0.0, LOAD], [0.0, 0.0, 0.0],
                       [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    return sys


def _spar_basis(mode, eta, zeta):
    """Chord-fraction interpolation bases s(eta, zeta) on the spar web
    (eta = y / L spanwise, zeta = z / BOX_H through the height); 2, 4 or 6
    dofs, nodal at their stations."""
    if mode == "rspar":                     # rigid: root + tip
        return [1.0 - eta, eta]
    if mode == "sspar":                     # straight, the web can lean
        return [(1.0 - eta) * (1.0 - zeta), eta * (1.0 - zeta),
                (1.0 - eta) * zeta, eta * zeta]
    if mode == "qspar":                     # quadratic in span
        l0 = 2.0 * (eta - 0.5) * (eta - 1.0)
        l1 = -4.0 * eta * (eta - 1.0)
        l2 = 2.0 * eta * (eta - 0.5)
        return [l0 * (1.0 - zeta), l1 * (1.0 - zeta), l2 * (1.0 - zeta),
                l0 * zeta, l1 * zeta, l2 * zeta]
    raise ValueError(mode)


def _bernstein(p, t):
    return np.array([comb(p, j) * t ** j * (1.0 - t) ** (p - j)
                     for j in range(p + 1)])


def _profile_operator(knots, p):
    """Exact knot-insertion operator from the degree-p Bernstein (single
    element) space into the patch direction (knots, p): the z-profile
    polynomial is reproduced exactly in the patch basis, so surfaces
    slaved through it stay coincident along the seams."""
    bern = np.concatenate([np.zeros(p + 1), np.ones(p + 1)])
    interior = np.asarray(knots, dtype=np.float64)[p + 1:-(p + 1)]
    T, new_knots = refine_knots_operator(bern, p, interior)
    assert np.allclose(new_knots, np.asarray(knots, dtype=np.float64))
    return T


def design_map(sys, y_rib0, variant="rspar_rrib", s0=(0.30, 0.30)):
    """The affine map cp_flat = A @ x_design + offset of the custom align
    comp. Returns (A, offset, x0, lower, upper); x0 reproduces the
    geometry the system was built at (spar fractions `s0`, rib station
    `y_rib0`)."""
    spar_mode, rib_mode = variant.split("_")[:2]
    outer = variant.endswith("_outer")
    lay = CPLayout(sys.metas, sys.stack.max_cp, sys.device)
    cp0 = lay.to_flat(sys.cp).cpu().numpy()          # (n_flat, 3)
    offs = np.concatenate([[0], np.cumsum([m.n_cp for m in sys.metas])])
    L = HALF_SPAN
    c_slope = -(1.0 - TAPER) * ROOT_CHORD / L
    sweep_slope = SWEEP / L

    n_spar = {"rspar": 2, "sspar": 4, "qspar": 6}[spar_mode]
    n_rib = 0 if outer else {"rrib": 1, "srib": 2}[rib_mode]
    p = sys.surfs[0].degree[1]               # the skins' spanwise degree
    n_z = (p + 1) if outer else 0
    n_dv = n_spar + n_rib + n_z
    A = np.zeros((cp0.size, n_dv))
    offset = cp0.ravel().copy()
    x0 = np.empty(n_dv)
    lower = np.empty(n_dv)
    upper = np.empty(n_dv)

    # each spar dof is the chord fraction at its station; the built ruled
    # spar's x offset is linear in y, so its fraction at station eta is
    # [(1 - eta) s_root c(0) + eta s_tip c(L)] / c(eta L)
    s_root0, s_tip0 = s0
    spar_etas = {"rspar": [0.0, 1.0],
                 "sspar": [0.0, 1.0, 0.0, 1.0],
                 "qspar": [0.0, 0.5, 1.0, 0.0, 0.5, 1.0]}[spar_mode]
    x0[:n_spar] = [(s_root0 * (1.0 - e) * _chord(0.0)
                    + s_tip0 * e * _chord(L)) / _chord(e * L)
                   for e in spar_etas]
    lower[:n_spar] = 0.15
    upper[:n_spar] = 0.80

    # spar (patch 2): x_cp = x_le(y_cp) + sum_j basis_j(eta, zeta) s_j
    # chord(y_node_j), each dof weighted by its own station's chord, so
    # the spar stays ruled between stations as the built one is
    o2 = offs[2]
    for k in range(sys.metas[2].n_cp):
        row = (o2 + k) * 3 + 0
        y, z = cp0[o2 + k, 1], cp0[o2 + k, 2]
        basis = _spar_basis(spar_mode, y / L, z / BOX_H)
        for j, b in enumerate(basis):
            A[row, j] = b * _chord(spar_etas[j] * L)
        offset[row] = _x_le(y)

    # rib (patch 3): front and rear stations slaved to the planform lines
    # x_le(y) = sweep_slope y and x_te(y) = x_le(y) + chord(y)
    o3 = offs[3]
    if not outer:
        jr = n_spar
        for k in range(sys.metas[3].n_cp):
            t = (cp0[o3 + k, 0] - _x_le(y_rib0)) / _chord(y_rib0)
            rx = (o3 + k) * 3 + 0
            ry = (o3 + k) * 3 + 1
            if rib_mode == "rrib":          # 1 dof: the y station
                A[rx, jr] = sweep_slope + t * c_slope
                A[ry, jr] = 1.0
            else:                           # srib: y_front, y_rear
                A[rx, jr] = (1.0 - t) * sweep_slope
                A[rx, jr + 1] = t * (sweep_slope + c_slope)
                A[ry, jr] = 1.0 - t
                A[ry, jr + 1] = t
            offset[rx] = t * ROOT_CHORD
            offset[ry] = 0.0
        x0[jr:jr + n_rib] = y_rib0
        lower[jr:jr + n_rib] = 0.25 * L
        upper[jr:jr + n_rib] = 0.75 * L

    if outer:
        # the outer mold line: a degree-p Bernstein spanwise height
        # profile z_top(y); its exact knot-insertion images drive the
        # upper skin's z, the spar's z field (scaled by zeta) and the
        # rib's top edge, keeping every edge-pinned seam coincident
        jz = n_spar
        T_skin = _profile_operator(sys.surfs[0].knots[1], p)
        T_spar = _profile_operator(sys.surfs[2].knots[1],
                                   sys.surfs[2].degree[1])
        n_v0 = sys.metas[0].n_v
        for k in range(sys.metas[0].n_cp):      # upper skin z
            rz = (offs[0] + k) * 3 + 2
            A[rz, jz:] = T_skin[k % n_v0, :]
            offset[rz] = 0.0
        n_v2 = sys.metas[2].n_v
        for k in range(sys.metas[2].n_cp):      # spar web z
            rz = (o2 + k) * 3 + 2
            zeta = cp0[o2 + k, 2] / BOX_H
            A[rz, jz:] = zeta * T_spar[k % n_v2, :]
            offset[rz] = 0.0
        bern_rib = _bernstein(p, y_rib0 / L)
        for k in range(sys.metas[3].n_cp):      # rib top edge z
            rz = (o3 + k) * 3 + 2
            zeta = cp0[o3 + k, 2] / BOX_H
            A[rz, jz:] = zeta * bern_rib
            offset[rz] = 0.0
        x0[jz:] = BOX_H
        lower[jz:] = 0.75 * BOX_H
        upper[jz:] = 1.75 * BOX_H
        # the root profile dof is pinned: the clamped edge stays fixed
        lower[jz] = upper[jz] = BOX_H
    return A, offset, x0, lower, upper


class EvtolSparRibAlignComp(_LinearMapComp):
    """Spar/rib design -> full flat CP vector (the reference's custom
    align comp: `design_map`'s A and offset)."""


class ShapeOptGroup(om.Group):
    """Minimize W_int over the spar/rib design, through both implicit
    solves."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("design_map")   # (A, offset, x0, lo, up)

    def init_parameters(self):
        self.design_name = "spar_rib_design"
        self.cp_iga_name = "CP_IGA"
        self.xi_name = "int_para_coords"
        self.disp_name = "displacements"
        self.int_energy_name = "w_int"

    def setup(self):
        sys = self.options["nonmatching_sys"]
        A, offset, x0, lower, upper = self.options["design_map"]

        inputs_comp = om.IndepVarComp()
        inputs_comp.add_output(self.design_name, shape=x0.size, val=x0)
        self.add_subsystem("inputs_comp", inputs_comp)

        align = EvtolSparRibAlignComp(
            A=A, offset=offset, input_name=self.design_name,
            output_name=self.cp_iga_name)
        align.init_parameters()
        self.add_subsystem("spar_rib_align_comp", align)

        c2x = CPIGA2XiComp(nonmatching_sys=sys,
                           input_cp_name=self.cp_iga_name,
                           output_xi_name=self.xi_name)
        c2x.init_parameters()
        self.add_subsystem("cpiga2xi_comp", c2x)

        disp = DispMintStatesComp(nonmatching_sys=sys,
                                  input_cp_name=self.cp_iga_name,
                                  input_xi_name=self.xi_name,
                                  output_u_name=self.disp_name,
                                  rtol=1e-10)
        disp.init_parameters()
        self.add_subsystem("disp_states_comp", disp)

        wint = IntEnergyComp(nonmatching_sys=sys,
                             input_cp_name=self.cp_iga_name,
                             input_u_name=self.disp_name,
                             output_name=self.int_energy_name)
        wint.init_parameters()
        self.add_subsystem("int_energy_comp", wint)

        edge = IntXiEdgeComp(nonmatching_sys=sys,
                             input_xi_name=self.xi_name,
                             output_name="int_xi_edge")
        edge.init_parameters()
        self.add_subsystem("int_xi_edge_comp", edge)

        design = "inputs_comp." + self.design_name
        cp_iga = "spar_rib_align_comp." + self.cp_iga_name
        xi = "cpiga2xi_comp." + self.xi_name
        self.connect(design, "spar_rib_align_comp." + self.design_name)
        for comp in ("cpiga2xi_comp", "disp_states_comp", "int_energy_comp"):
            self.connect(cp_iga, comp + "." + self.cp_iga_name)
        self.connect(xi, "disp_states_comp." + self.xi_name)
        self.connect("disp_states_comp." + self.disp_name,
                     "int_energy_comp." + self.disp_name)
        self.connect(xi, "int_xi_edge_comp." + self.xi_name)

        self.add_design_var(design, lower=lower, upper=upper)
        # the xi-edge rows stay in the graph as a monitored invariant and
        # are not handed to SLSQP: this build's xi residual pins the edge
        # coordinates itself, so the rows are identically zero with a zero
        # Jacobian, and degenerate equality rows make the QP subproblem
        # exit with a zero step; `main` asserts the invariant instead
        self.add_objective("int_energy_comp." + self.int_energy_name,
                           scaler=1e2)


def build_problem(num_el=4, p=3, maxiter=6, design0=(0.30, 0.30, 0.45),
                  h_th=H_TH, variant="rspar_rrib", device=None):
    """(prob, system), set up; the system on `device` (the current CUDA
    device when None)."""
    s_root, s_tip, y_frac = design0
    sys = build_system(s_root=s_root, s_tip=s_tip, y_rib_frac=y_frac,
                       num_el=num_el, p=p, h_th=h_th, device=device)
    dmap = design_map(sys, y_rib0=y_frac * HALF_SPAN, variant=variant,
                      s0=(s_root, s_tip))
    model = ShapeOptGroup(nonmatching_sys=sys, design_map=dmap)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys


def main(num_el=4, p=3, maxiter=6, verbose=True, variant="rspar_rrib",
         device=None):
    prob, sys = build_problem(num_el=num_el, p=p, maxiter=maxiter,
                              variant=variant, device=device)
    prob.run_model()
    J0 = float(np.asarray(prob["int_energy_comp.w_int"]).ravel()[0])
    prob.run_driver()
    J1 = float(np.asarray(prob["int_energy_comp.w_int"]).ravel()[0])
    x = np.asarray(prob["inputs_comp.spar_rib_design"])
    edge = np.asarray(prob["int_xi_edge_comp.int_xi_edge"])
    if verbose:
        print(f"[{variant}] w_int {J0:.6e} -> {J1:.6e} "
              f"({100 * (1 - J1 / J0):.1f}% lower)")
        print(f"design: {np.array2string(x, precision=4)}  "
              f"max|xi_edge|={np.abs(edge).max():.2e}")
    assert J1 < J0
    assert np.abs(edge).max() < 1e-8  # the xi edge invariant held
    return prob, sys, J0, J1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default="rspar_rrib", choices=VARIANTS)
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=6)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(num_el=args.num_el, p=args.p, maxiter=args.maxiter,
         variant=args.variant, device=args.device)
