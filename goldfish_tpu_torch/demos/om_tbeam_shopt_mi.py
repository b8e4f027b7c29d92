"""T-beam shape optimization with a moving intersection through the
OpenMDAO graph.

Port of demos/om_tbeam_shopt_mi.py (the reference's T_beam_2patch_shopt_mi
ShapeOptGroup): design CPs -> CPSurfOrderElevationComp ->
CPSurfKnotRefienmentComp -> CPAnalysis2FullComp (embed into the full flat
CP vector) -> CPIGA2XiComp (implicit CP -> xi) -> DispMintStatesComp
(implicit solve with the xi input) -> IntEnergyComp objective, with the
CPSurfPinComp and IntXiEdgeComp equality constraints, driven by
ScipyOptimizeDriver SLSQP. Runs on real OpenMDAO when installed, else on
goldfish_tpu_torch.om_shim (the same API). The system is `tbeam.build_mi`.

As in the JAX package, SciPy's SLSQP stops this demo at its first
iteration (ROADMAP C9: "Singular matrix C in LSQ subproblem", or "More
equality constraints than independent variables" where the xi-edge and
pin rows outnumber the design variables): the
design-variable bounds (+-0.95 of the flange's half-width) exclude the
flange's pinned corner CPs at +-1 of it, so SciPy clips the start into the
bounds and the pin equality cannot hold; and an x-field design keeps the
web's edge on u_B = 0 (its z depends on u_B alone), so the xi-edge
constraint's rows of the totals are exactly zero. w_int ends lower only
through the clipped start.

    python -m goldfish_tpu_torch.demos.om_tbeam_shopt_mi
        [--num-el 4] [--p 3] [--n-pts 12] [--maxiter 6] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

try:
    import openmdao.api as om
except ModuleNotFoundError:
    from goldfish_tpu_torch.om_shim import api as om

from goldfish_tpu_torch.design.cp_design import CPSurfDesign2Analysis
from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.models import tbeam
from goldfish_tpu_torch.om_comps.components import (
    CPIGA2XiComp,
    CPSurfKnotRefienmentComp,
    CPSurfOrderElevationComp,
    CPSurfPinComp,
    DispMintStatesComp,
    IntEnergyComp,
    IntXiEdgeComp,
    _LinearMapComp,
)

__all__ = ["CPAnalysis2FullComp", "build_mi_tbeam", "ShapeOptGroup",
           "build_problem", "main"]


class CPAnalysis2FullComp(_LinearMapComp):
    """Embed one optimized field's analysis CPs into the full flat CP
    vector (all patches x 3 fields), the other entries frozen at their
    initial values."""

    def initialize(self):
        super().initialize()
        self.options.declare("cp0_flat")    # (n_flat, 3) initial CPs
        self.options.declare("surf_inds")
        self.options.declare("field", default=0)
        self.options.declare("offsets")     # surface -> (flat offset, n_cp)

    def init_parameters(self):
        cp0 = np.asarray(self.options["cp0_flat"])
        field = self.options["field"]
        offsets = self.options["offsets"]
        cols = []
        offset = cp0.ravel().copy()
        for i in self.options["surf_inds"]:
            o, n = offsets[i]
            for k in range(n):
                col = np.zeros(cp0.size)
                col[(o + k) * 3 + field] = 1.0
                cols.append(col)
                offset[(o + k) * 3 + field] = 0.0
        self.options["A"] = np.stack(cols, axis=1)
        self.options["offset"] = offset
        super().init_parameters()


def build_mi_tbeam(num_el=4, p=3, n_pts=12, device=None):
    """The 2-patch T-beam with one web intersection: `tbeam.build_mi` (the
    JAX demo's construction: both patches clamped at y = 0, the tip point
    load, penalty 1e3)."""
    return tbeam.build_mi(num_el=num_el, p=p, n_pts=n_pts, device=device)


class ShapeOptGroup(om.Group):
    """The reference's ShapeOptGroup: minimize W_int over the design CPs of
    one field."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("design2analysis")
        self.options.declare("opt_field", default=0)

    def init_parameters(self):
        self.cpsurf_design_name = "CPS_design"
        self.cpsurf_elevated_name = "CPS_elevated"
        self.cpsurf_analysis_name = "CPS_analysis"
        self.cp_iga_name = "CP_IGA"
        self.xi_name = "int_para_coords"
        self.disp_name = "displacements"
        self.int_energy_name = "w_int"

    def setup(self):
        sys = self.options["nonmatching_sys"]
        d2a = self.options["design2analysis"]
        field = self.options["opt_field"]
        lay = CPLayout(sys.metas, sys.stack.max_cp, sys.device)

        x_design = np.concatenate(
            [d2a.init_design_cp(i, field) for i in d2a.surf_inds])
        inputs_comp = om.IndepVarComp()
        inputs_comp.add_output(self.cpsurf_design_name,
                               shape=x_design.size, val=x_design)
        self.add_subsystem("inputs_comp", inputs_comp)

        elev = CPSurfOrderElevationComp(
            design2analysis=d2a, fields=(field,),
            input_name=self.cpsurf_design_name,
            output_name=self.cpsurf_elevated_name)
        elev.init_parameters()
        self.add_subsystem("cpsurf_order_elevation_comp", elev)

        refc = CPSurfKnotRefienmentComp(
            design2analysis=d2a, fields=(field,),
            input_name=self.cpsurf_elevated_name,
            output_name=self.cpsurf_analysis_name)
        refc.init_parameters()
        self.add_subsystem("cpsurf_knot_refinement_comp", refc)

        offsets = {}
        o = 0
        for i, m in enumerate(sys.metas):
            offsets[i] = (o, m.n_cp)
            o += m.n_cp
        emb = CPAnalysis2FullComp(
            cp0_flat=lay.to_flat(sys.cp).cpu().numpy(),
            surf_inds=d2a.surf_inds, field=field, offsets=offsets,
            input_name=self.cpsurf_analysis_name,
            output_name=self.cp_iga_name)
        emb.init_parameters()
        self.add_subsystem("cp_analysis2full_comp", emb)

        c2x = CPIGA2XiComp(nonmatching_sys=sys,
                           input_cp_name=self.cp_iga_name,
                           output_xi_name=self.xi_name)
        c2x.init_parameters()
        self.add_subsystem("cpiga2xi_comp", c2x)

        disp = DispMintStatesComp(nonmatching_sys=sys,
                                  input_cp_name=self.cp_iga_name,
                                  input_xi_name=self.xi_name,
                                  output_u_name=self.disp_name,
                                  rtol=1e-11)
        disp.init_parameters()
        self.add_subsystem("disp_states_comp", disp)

        wint = IntEnergyComp(nonmatching_sys=sys,
                             input_cp_name=self.cp_iga_name,
                             input_u_name=self.disp_name,
                             output_name=self.int_energy_name)
        wint.init_parameters()
        self.add_subsystem("int_energy_comp", wint)

        # edge-type xi dofs must stay on their parametric edge
        edge = IntXiEdgeComp(nonmatching_sys=sys,
                             input_xi_name=self.xi_name,
                             output_name="int_xi_edge")
        edge.init_parameters()
        self.add_subsystem("int_xi_edge_comp", edge)

        # pin the design-grid corners of the flange so that the beam cannot
        # translate
        nu0, nv0 = d2a.design_shapes[d2a.surf_inds[0]]
        pin = CPSurfPinComp(
            design2analysis=d2a, fields=(field,),
            pinned={d2a.surf_inds[0]: [0, (nu0 - 1) * nv0],
                    d2a.surf_inds[1]: []},
            input_name=self.cpsurf_design_name, output_name="cps_pin")
        pin.init_parameters()
        self.add_subsystem("cpsurf_pin_comp", pin)
        pin_target = pin.A @ x_design

        cp_iga = "cp_analysis2full_comp." + self.cp_iga_name
        xi = "cpiga2xi_comp." + self.xi_name
        design = "inputs_comp." + self.cpsurf_design_name
        self.connect(design, "cpsurf_order_elevation_comp."
                     + self.cpsurf_design_name)
        self.connect("cpsurf_order_elevation_comp."
                     + self.cpsurf_elevated_name,
                     "cpsurf_knot_refinement_comp."
                     + self.cpsurf_elevated_name)
        self.connect("cpsurf_knot_refinement_comp."
                     + self.cpsurf_analysis_name,
                     "cp_analysis2full_comp." + self.cpsurf_analysis_name)
        for comp in ("cpiga2xi_comp", "disp_states_comp", "int_energy_comp"):
            self.connect(cp_iga, comp + "." + self.cp_iga_name)
        self.connect(xi, "disp_states_comp." + self.xi_name)
        self.connect("disp_states_comp." + self.disp_name,
                     "int_energy_comp." + self.disp_name)
        self.connect(xi, "int_xi_edge_comp." + self.xi_name)
        self.connect(design, "cpsurf_pin_comp." + self.cpsurf_design_name)

        w2 = tbeam.WIDTH / 2
        self.add_design_var(design, lower=-0.95 * w2, upper=0.95 * w2)
        self.add_constraint("cpsurf_pin_comp.cps_pin", equals=pin_target)
        if edge.output_shape:
            self.add_constraint("int_xi_edge_comp.int_xi_edge",
                                equals=np.zeros(edge.output_shape))
        self.add_objective("int_energy_comp." + self.int_energy_name,
                           scaler=1e1)


def build_problem(num_el=4, p=3, n_pts=12, design_nel=(1, 1), maxiter=6,
                  device=None):
    """(prob, system, design2analysis), set up; the system on `device` (the
    current CUDA device when None)."""
    sys = build_mi_tbeam(num_el=num_el, p=p, n_pts=n_pts, device=device)
    d2a = CPSurfDesign2Analysis(sys.surfs, design_nel=design_nel,
                                design_degree=2)
    model = ShapeOptGroup(nonmatching_sys=sys, design2analysis=d2a)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys, d2a


def main(num_el=4, p=3, n_pts=12, maxiter=6, device=None):
    prob, sys, d2a = build_problem(num_el=num_el, p=p, n_pts=n_pts,
                                   maxiter=maxiter, device=device)
    prob.run_model()
    J0 = float(prob["int_energy_comp.w_int"][0])
    prob.run_driver()
    J1 = float(prob["int_energy_comp.w_int"][0])
    print(f"w_int {J0:.6e} -> {J1:.6e} ({100 * (1 - J1 / J0):.1f}% lower)")
    assert J1 < J0
    return prob


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--n-pts", type=int, default=12)
    ap.add_argument("--maxiter", type=int, default=6)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(num_el=args.num_el, p=args.p, n_pts=args.n_pts,
         maxiter=args.maxiter, device=args.device)
