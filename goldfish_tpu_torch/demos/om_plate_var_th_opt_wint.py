"""Variable-thickness plate optimization through the OpenMDAO graph.

Port of demos/om_plate_var_th_opt_wint.py: IndepVarComp(h_th_ffd) ->
HthFFD2FEComp -> HthFE2IGAComp -> DispStatesComp -> IntEnergyComp objective
and VolumeComp equality, with the HthFFDAlignComp / HthFFDReguComp linear
constraints, driven by ScipyOptimizeDriver SLSQP. Runs on real OpenMDAO
when installed, else on goldfish_tpu_torch.om_shim (the same API).

    python -m goldfish_tpu_torch.demos.om_plate_var_th_opt_wint
        [--num-el 3] [--maxiter 20] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

try:
    import openmdao.api as om
except ModuleNotFoundError:
    from goldfish_tpu_torch.om_shim import api as om

from goldfish_tpu_torch.design.constraints import align_operator, regu_operator
from goldfish_tpu_torch.design.pipeline import ThicknessFFD
from goldfish_tpu_torch.models import plate
from goldfish_tpu_torch.om_comps.components import (
    DispStatesComp,
    HthFE2IGAComp,
    HthFFD2FEComp,
    HthFFDAlignComp,
    HthFFDReguComp,
    IntEnergyComp,
    VolumeComp,
)

__all__ = ["VarThOptGroup", "build_problem", "main"]


class VarThOptGroup(om.Group):
    """The reference VarThOptGroup: minimize W_int at constant volume."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("th_ffd")
        self.options.declare("h0", default=plate.H_TH)

    def init_parameters(self):
        self.h_th_ffd_name = "thickness_FFD"
        self.h_th_fe_name = "thickness_FE"
        self.h_th_iga_name = "thickness_IGA"
        self.disp_name = "displacements"
        self.int_energy_name = "w_int"
        self.volume_name = "volume"

    def setup(self):
        sys = self.options["nonmatching_sys"]
        th = self.options["th_ffd"]
        h0 = self.options["h0"]

        inputs_comp = om.IndepVarComp()
        inputs_comp.add_output(self.h_th_ffd_name, shape=th.n_ffd,
                               val=th.init_h_ffd(h0))
        self.add_subsystem("inputs_comp", inputs_comp)

        ffd2fe = HthFFD2FEComp(A=th.F.cpu().numpy(),
                               input_name=self.h_th_ffd_name,
                               output_name=self.h_th_fe_name)
        ffd2fe.init_parameters()
        self.add_subsystem("h_th_ffd2fe_comp", ffd2fe)

        fe2iga = HthFE2IGAComp(size=th.layout.n_flat,
                               input_name=self.h_th_fe_name,
                               output_name=self.h_th_iga_name)
        fe2iga.init_parameters()
        self.add_subsystem("h_th_fe2iga_comp", fe2iga)

        disp = DispStatesComp(nonmatching_sys=sys,
                              input_h_th_name=self.h_th_iga_name,
                              output_u_name=self.disp_name)
        disp.init_parameters()
        self.add_subsystem("disp_states_comp", disp)

        wint = IntEnergyComp(nonmatching_sys=sys,
                             input_h_th_name=self.h_th_iga_name,
                             input_u_name=self.disp_name,
                             output_name=self.int_energy_name)
        wint.init_parameters()
        self.add_subsystem("int_energy_comp", wint)

        vol = VolumeComp(nonmatching_sys=sys,
                         input_h_th_name=self.h_th_iga_name,
                         output_name=self.volume_name)
        vol.init_parameters()
        self.add_subsystem("volume_comp", vol)
        self.vol_val = float(sys.volume())

        # FFD-grid align (x-fastest dof order) and regu operators
        grid = th.shape
        A_align = align_operator(grid, axis=1)
        align = HthFFDAlignComp(A=A_align, input_name=self.h_th_ffd_name,
                                output_name="thickness_FFD_align")
        align.init_parameters()
        self.add_subsystem("h_th_ffd_align_comp", align)
        A_regu = regu_operator(grid, axis=0)
        regu = HthFFDReguComp(A=A_regu, input_name=self.h_th_ffd_name,
                              output_name="thickness_FFD_regu")
        regu.init_parameters()
        self.add_subsystem("h_th_ffd_regu_comp", regu)

        iga = "h_th_fe2iga_comp." + self.h_th_iga_name
        self.connect("inputs_comp." + self.h_th_ffd_name,
                     "h_th_ffd2fe_comp." + self.h_th_ffd_name)
        self.connect("h_th_ffd2fe_comp." + self.h_th_fe_name,
                     "h_th_fe2iga_comp." + self.h_th_fe_name)
        for comp in ("disp_states_comp", "volume_comp", "int_energy_comp"):
            self.connect(iga, comp + "." + self.h_th_iga_name)
        self.connect("disp_states_comp." + self.disp_name,
                     "int_energy_comp." + self.disp_name)
        for comp in ("h_th_ffd_align_comp", "h_th_ffd_regu_comp"):
            self.connect("inputs_comp." + self.h_th_ffd_name,
                         comp + "." + self.h_th_ffd_name)

        self.add_design_var("inputs_comp." + self.h_th_ffd_name,
                            lower=0.4 * h0, upper=4.0 * h0, scaler=1e2)
        self.add_constraint("h_th_ffd_align_comp.thickness_FFD_align",
                            equals=np.zeros(A_align.shape[0]))
        self.add_constraint("h_th_ffd_regu_comp.thickness_FFD_regu",
                            lower=np.full(A_regu.shape[0], -5e-2 * h0))
        self.add_constraint("volume_comp." + self.volume_name,
                            equals=self.vol_val)
        self.add_objective("int_energy_comp." + self.int_energy_name,
                           scaler=1e1)


def build_problem(num_el=3, p=2, num_patches=2, ffd_els=(4, 2, 1),
                  maxiter=20, device=None):
    sys = plate.build(num_el=num_el, p=p, num_patches=num_patches,
                      device=device)
    th = ThicknessFFD(sys, num_els=ffd_els, p=(2, 1, 1))
    model = VarThOptGroup(nonmatching_sys=sys, th_ffd=th)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys, th


def main(num_el=3, maxiter=20, device=None):
    prob, sys, th = build_problem(num_el=num_el, maxiter=maxiter,
                                  device=device)
    prob.run_model()
    J0 = float(prob["int_energy_comp.w_int"][0])
    prob.run_driver()
    J1 = float(prob["int_energy_comp.w_int"][0])
    vol = float(prob["volume_comp.volume"][0])
    print(f"w_int {J0:.6e} -> {J1:.6e} ({100 * (1 - J1 / J0):.1f}% lower)"
          f"  volume {vol:.6e} (target {prob.model.vol_val:.6e})")
    assert J1 < J0
    assert abs(vol - prob.model.vol_val) / prob.model.vol_val < 1e-6
    return prob


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=20)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(num_el=args.num_el, maxiter=args.maxiter, device=args.device)
