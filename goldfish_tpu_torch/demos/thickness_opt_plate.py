"""Variable-thickness plate optimization, the headline thickness demo.

Port of demos/thickness_opt_plate.py. Geometry: an IGES plate of
non-matching strips when a file is given (`igs`: its intersections found
by the preprocessor), else the built-in 4-patch plate of models/plate.py.
Minimize the internal energy at constant volume; the thickness is an FFD
block (num_els (4, 1, 1), degree (3, 1, 1)) aligned across the width;
SLSQP; a checkpoint every iteration and VTK output of the optimum.

    python -m goldfish_tpu_torch.demos.thickness_opt_plate [--num-el 4]
        [--maxiter 30] [--igs FILE] [--results DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["build_system", "setup", "main"]


def build_system(num_el, igs=None, device=None):
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    if igs is not None:
        from goldfish_tpu_torch.geometry.igs_io import read_igs_file
        from goldfish_tpu_torch.geometry.preprocessing import Preprocessor

        surfs = read_igs_file(igs)
        pre = Preprocessor(surfs, device=device).compute_intersections(
            rtol=1e-4, mortar_refine=2)
        sys_ = NonMatchingSystem(surfs, 68e9, 0.35, 1e-2,
                                 specs=pre.interface_specs(), device=device)
        sys_.add_side_bc(0, direction=1, side=0, n_layers=2)
        sys_.add_edge_load(len(surfs) - 1, direction=1, side=1,
                           force=[0.0, 0.0, -100.0])
        return sys_
    from goldfish_tpu_torch.models import plate

    return plate.build(num_el=num_el, p=3, num_patches=4, device=device)


def setup(num_el=4, igs=None, device=None):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the thickness FFD `th`, the solve function `solve`, the objective
    `obj(dvs, d0) -> (W_int, d)`, the start `x0` and the `OptProblem`
    `prob`."""
    from goldfish_tpu_torch.design.constraints import align_operator
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_ = build_system(num_el, igs, device)
    dev = sys_.device
    h0_val = float(sys_.h_init.max())
    th = ThicknessFFD(sys_, num_els=(4, 1, 1), p=(3, 1, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-10, max_it=30)
    cp = sys_.cp
    V0 = float(sys_.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                        sys_.nu), d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, cp, th(dvs["h_ffd"]))

    A = align_operator(th.shape, axis=(1, 2))
    At = torch.tensor(A, dtype=torch.float64, device=dev)
    x0 = th.init_h_ffd(h0_val)
    prob = OptProblem(device=dev)
    prob.add_design_var("h_ffd", x0, lower=h0_val / 20, upper=h0_val * 50,
                        scaler=1e2)
    prob.set_objective(obj, scaler=1e1, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("align", lambda dvs: At @ dvs["h_ffd"],
                        equals=np.zeros(A.shape[0]))
    return SimpleNamespace(sys=sys_, th=th, solve=solve, obj=obj, x0=x0,
                           prob=prob)


def main(num_el=4, maxiter=30, results="./results/plate_thopt",
         verbose=True, igs=None, device=None):
    from goldfish_tpu_torch.utils.checkpoint import Checkpointer
    from goldfish_tpu_torch.utils.vtk_io import SurfaceWriter

    ns = setup(num_el, igs, device)
    sys_ = ns.sys
    Checkpointer(os.path.join(results, "opt_state.npz")).attach(ns.prob)
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    with torch.no_grad():
        h_op = ns.th(torch.tensor(res.x["h_ffd"], device=sys_.device))
        d_op = ns.solve(sys_.cp, h_op, sys_.zero_displacement())
    SurfaceWriter(sys_, save_path=results).save(d=d_op, h=h_op, tag="final")
    if verbose:
        print(f"J: {res.history[0] if res.history else float('nan'):.4e}"
              f" -> {res.fun:.4e}  ({res.nit} its, {res.message})")
    return res, sys_, ns.th


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=30)
    ap.add_argument("--igs", default=None)
    ap.add_argument("--results", default="./results/plate_thopt")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, results=a.results, igs=a.igs,
         device=a.device)
