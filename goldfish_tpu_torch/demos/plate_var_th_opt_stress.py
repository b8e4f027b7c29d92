"""Stress-constrained variable-thickness plate sizing through the
OpenMDAO graph: minimize the volume subject to a KS-aggregated maximum von
Mises stress allowable.

Port of demos/plate_var_th_opt_stress.py:

    min  volume(h)
    s.t. KS-max sigma_vM(top surface) <= sigma_allow
         align/regu regularity on the thickness FFD grid
         h in [h0/4, 4 h0]

on the penalty-coupled two-patch plate (models/plate.py), through
IndepVarComp -> HthFFD2FEComp -> HthFE2IGAComp -> DispStatesComp ->
VolumeComp (objective) and MaxvMStressComp (the nonlinear constraint),
driven by SLSQP (real OpenMDAO when installed, else
goldfish_tpu_torch.om_shim). sigma_allow = 1.6 x the KS stress of the
uniform start, so the plate thins until the stress allowable stops it. On
the card the stress and its gradient run through kernel K9.

    python -m goldfish_tpu_torch.demos.plate_var_th_opt_stress
        [--num-el 3] [--maxiter 30] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

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
    MaxvMStressComp,
    VolumeComp,
)
from goldfish_tpu_torch.operations.exops import MaxvMStressExOperation

__all__ = ["StressConsThOptGroup", "build_problem", "record", "run", "main"]

FFD = "inputs_comp.thickness_FFD"
VOL = "volume_comp.volume"
SIG = "max_vmstress_comp.max_vmstress"


class StressConsThOptGroup(om.Group):
    """Volume-min / stress-constrained variant of the reference
    VarThOptGroup, with MaxvMStressComp as the constraint."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("th_ffd")
        self.options.declare("h0", default=plate.H_TH)
        self.options.declare("sigma_allow")
        self.options.declare("ks_rho", default=100.0)

    def init_parameters(self):
        self.h_th_ffd_name = "thickness_FFD"
        self.h_th_fe_name = "thickness_FE"
        self.h_th_iga_name = "thickness_IGA"
        self.disp_name = "displacements"
        self.volume_name = "volume"
        self.stress_name = "max_vmstress"

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

        vol = VolumeComp(nonmatching_sys=sys,
                         input_h_th_name=self.h_th_iga_name,
                         output_name=self.volume_name)
        vol.init_parameters()
        self.add_subsystem("volume_comp", vol)
        self.vol0 = float(sys.volume())

        stress = MaxvMStressComp(
            nonmatching_sys=sys, input_h_th_name=self.h_th_iga_name,
            input_u_name=self.disp_name, output_name=self.stress_name,
            op_kwargs=dict(rho=float(self.options["ks_rho"]),
                           method="KS", through="top"))
        stress.init_parameters()
        self.add_subsystem("max_vmstress_comp", stress)

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
        for comp in ("disp_states_comp", "volume_comp", "max_vmstress_comp"):
            self.connect(iga, comp + "." + self.h_th_iga_name)
        self.connect("disp_states_comp." + self.disp_name,
                     "max_vmstress_comp." + self.disp_name)
        for comp in ("h_th_ffd_align_comp", "h_th_ffd_regu_comp"):
            self.connect("inputs_comp." + self.h_th_ffd_name,
                         comp + "." + self.h_th_ffd_name)

        sigma_allow = float(self.options["sigma_allow"])
        self.add_design_var("inputs_comp." + self.h_th_ffd_name,
                            lower=0.25 * h0, upper=4.0 * h0, scaler=1e2)
        self.add_constraint("h_th_ffd_align_comp.thickness_FFD_align",
                            equals=np.zeros(A_align.shape[0]))
        self.add_constraint("h_th_ffd_regu_comp.thickness_FFD_regu",
                            lower=np.full(A_regu.shape[0], -5e-2 * h0))
        # KS max-vM <= allowable; `upper` is in model units, the scaler
        # only normalizes the driver's view
        self.add_constraint("max_vmstress_comp." + self.stress_name,
                            upper=sigma_allow, scaler=1.0 / sigma_allow)
        self.add_objective("volume_comp." + self.volume_name,
                           scaler=1.0 / self.vol0)


def build_problem(num_el=3, p=2, num_patches=2, ffd_els=(4, 2, 1),
                  maxiter=30, sigma_factor=1.6, ks_rho=100.0, device=None):
    """(prob, sys, th, sigma_allow, sigma0) with sigma_allow = sigma_factor
    x the KS stress at the uniform thickness h0 (> 1 so that the plate can
    thin until the stress reaches the allowable)."""
    sys = plate.build(num_el=num_el, p=p, num_patches=num_patches,
                      device=device)
    th = ThicknessFFD(sys, num_els=ffd_els, p=(2, 1, 1))

    # the initial KS stress places the allowable
    d = sys.solve_nonlinear(rtol=1e-10, max_it=30)
    lay = th.layout
    op = MaxvMStressExOperation(sys, rho=ks_rho, through="top")
    sigma0 = op.compute(*(lay.to_flat(x).reshape(-1).cpu().numpy()
                          for x in (sys.cp, sys.h_init, d)))
    sigma_allow = sigma_factor * sigma0

    model = StressConsThOptGroup(nonmatching_sys=sys, th_ffd=th,
                                 sigma_allow=sigma_allow, ks_rho=ks_rho)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-10
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys, th, sigma_allow, sigma0


def record(prob):
    """Wrap what the driver calls for a fun evaluation (prob.run_model)
    and a jac evaluation (prob._linearize_all, then prob.compute_totals) to
    log their host walls and the (volume, KS stress) of every model
    evaluation. Returns the log."""
    log = SimpleNamespace(evaluations=[], fun_wall=[], jac_wall=[], lin=0.0)
    run_model, linearize = prob.run_model, prob._linearize_all
    compute_totals = prob.compute_totals

    def timed_run_model():
        t0 = time.perf_counter()
        run_model()
        log.fun_wall.append(time.perf_counter() - t0)
        log.evaluations.append((float(prob[VOL][0]), float(prob[SIG][0])))

    def timed_linearize():
        t0 = time.perf_counter()
        out = linearize()
        log.lin += time.perf_counter() - t0
        return out

    def timed_compute_totals(*args, **kwargs):
        t0 = time.perf_counter()
        out = compute_totals(*args, **kwargs)
        log.jac_wall.append(time.perf_counter() - t0 + log.lin)
        log.lin = 0.0
        return out

    prob.run_model = timed_run_model
    prob._linearize_all = timed_linearize
    prob.compute_totals = timed_compute_totals
    return log


def run(prob):
    """run_model, then the driver: a namespace with the start and end
    volume and KS stress, the SciPy result and the `record` log."""
    log = record(prob)
    prob.run_model()
    V0, s0 = log.evaluations[0]
    prob.run_driver()
    V1, s1 = log.evaluations[-1]
    return SimpleNamespace(V0=V0, s0=s0, V1=V1, s1=s1, log=log,
                           result=prob._driver_result)


def main(num_el=3, maxiter=30, device=None):
    prob, sys, th, sigma_allow, sigma0 = build_problem(
        num_el=num_el, maxiter=maxiter, device=device)
    out = run(prob)
    V0, V1, s1 = out.V0, out.V1, out.s1
    print(f"volume {V0:.6e} -> {V1:.6e} ({100 * (1 - V1 / V0):.1f}% "
          f"lighter), KS stress {sigma0:.4e} -> {s1:.4e} "
          f"(allowable {sigma_allow:.4e})")
    assert V1 < V0                      # the plate got lighter
    assert s1 <= 1.02 * sigma_allow     # feasible (2% KS slack)
    # the stress constraint is active at the optimum (within 5%)
    assert s1 >= 0.95 * sigma_allow, (s1, sigma_allow)
    return prob


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=30)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(num_el=args.num_el, maxiter=args.maxiter, device=args.device)
