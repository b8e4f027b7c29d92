"""eVTOL-class wing: skins, spars and ribs through the CAD path, SHAPE and
THICKNESS optimization with a rib-alignment and a constant-volume
constraint.

Port of demos/evtol_wing_shopt.py. The box wing of models/boxwing.py is
exported to IGES, read back, and its intersections are found by the
preprocessor (`geometry.preprocessing.Preprocessor`); the system is built
from what was read. Pressure on the upper skins, the root rib clamped. The
design is a shape FFD in z (`ShapeFFD`, its z columns tied together) and
a spanwise thickness FFD; the objective is the internal energy, at the
start volume; SLSQP.

    python -m goldfish_tpu_torch.demos.evtol_wing_shopt [--sections 3]
        [--num-el 3] [--maxiter 5] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["build_system", "setup", "main"]


def build_system(n_sections=3, num_el=3, p=3, verbose=True, device=None):
    """IGES round trip, intersection discovery and the system. Returns
    (system, box wing, preprocessor)."""
    from goldfish_tpu_torch.geometry.igs_io import (
        read_igs_file,
        write_igs_file,
    )
    from goldfish_tpu_torch.geometry.preprocessing import Preprocessor
    from goldfish_tpu_torch.models import boxwing
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    base = boxwing.build(n_sections=n_sections, num_el=num_el, p=p,
                         device=device)
    igs = os.path.join(tempfile.gettempdir(), "evtol_wing.igs")
    write_igs_file(igs, base.surfs)
    surfs = read_igs_file(igs)
    if verbose:
        print(f"IGS round-trip: {len(surfs)} surfaces", flush=True)

    t0 = time.perf_counter()
    pre = Preprocessor(surfs, device=device).compute_intersections(
        rtol=2e-4, mortar_refine=2)
    if verbose:
        print(f"preprocessor: {pre.num_intersections} intersections "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)

    sys_ = NonMatchingSystem(surfs, boxwing.E, boxwing.NU, boxwing.H_TH,
                             specs=pre.interface_specs(), device=device)
    # clamp the root rib; pressure on the upper skins
    sys_.add_side_bc(base.ids["rib0"], direction=1, side=0, n_layers=1)
    p_vec = np.zeros(sys_.num_splines)
    for k in range(n_sections):
        p_vec[base.ids[f"up{k}"]] = boxwing.PRESSURE
    sys_.set_pressure(p_vec)
    return sys_, base, pre


def setup(n_sections=3, num_el=3, p=3, verbose=True, device=None):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the preprocessor `pre`, the FFD maps `sh`, `th`, the solve
    function `solve`, the objective `obj(dvs, d0) -> (W_int, d)`, the start
    `x0` (a dict) and the `OptProblem` `prob`."""
    from goldfish_tpu_torch.design.constraints import align_operator
    from goldfish_tpu_torch.design.pipeline import ShapeFFD, ThicknessFFD
    from goldfish_tpu_torch.models import boxwing
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_, base, pre = build_system(n_sections, num_el, p, verbose, device)
    dev = sys_.device
    sh = ShapeFFD(sys_, num_els=(2, max(n_sections, 2), 2), p=2,
                  opt_fields=(2,))
    th = ThicknessFFD(sys_, num_els=(1, max(n_sections, 2), 1),
                      p=(1, 2, 1))
    # the root rib is clamped along one edge only (a hinge): the rotation
    # about it is resisted by the follower pressure alone, which leaves the
    # tangent at d = 0 slightly indefinite, so the factor is an LU
    solve = build_solve_fn(sys_.data, rtol=1e-8, max_it=30, kind="lu")
    V0 = float(sys_.volume())

    # the z columns of the shape FFD move together (the reference's
    # rib-alignment role with z the only shape field)
    A_align = align_operator(sh.shape, axis=2)
    At = torch.tensor(A_align, dtype=torch.float64, device=dev)

    def obj(dvs, d0):
        cp = sh(dvs["p_ffd"])
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                        sys_.nu), d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, sh(dvs["p_ffd"]),
                               th(dvs["h_ffd"]))

    p0 = sh.init_p_ffd()
    h0 = th.init_h_ffd(boxwing.H_TH)
    prob = OptProblem(device=dev)
    span = float(np.max(np.abs(p0))) + 1.0
    prob.add_design_var("p_ffd", p0, lower=p0 - 0.2 * span,
                        upper=p0 + 0.2 * span)
    prob.add_design_var("h_ffd", h0, lower=boxwing.H_TH / 5,
                        upper=boxwing.H_TH * 5, scaler=1e2)
    prob.set_objective(obj, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("rib_align", lambda dvs: At @ dvs["p_ffd"],
                        equals=np.asarray(A_align @ p0))
    return SimpleNamespace(sys=sys_, base=base, pre=pre, sh=sh, th=th,
                           solve=solve, obj=obj,
                           x0={"p_ffd": p0, "h_ffd": h0}, prob=prob)


def main(n_sections=3, num_el=3, p=3, maxiter=5, verbose=True, device=None):
    ns = setup(n_sections, num_el, p, verbose, device)
    t0 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} ({res.nit} its, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
    return res, ns.sys, ns.sh, ns.th


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", type=int, default=3)
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=5)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(n_sections=a.sections, num_el=a.num_el, maxiter=a.maxiter,
         device=a.device)
