"""Flagship workflow: thickness optimization of the 20-patch wing.

Port of demos/wing_thickness_opt.py, the production counterpart of the
single wing20 iteration run as a complete driver: FFD-parametrized skin
thickness (`ThicknessFFD`, num_els (4, 4, 1), degree (2, 2, 1), uniform
through z by an align constraint), strain-energy objective, constant
volume, SLSQP through `OptProblem.run`, a checkpoint every iteration with
resumption after process death
(`utils.checkpoint.resume_run`), VTK output of the optimum and stage
timers (`utils.profiling.profiler`).

    python -m goldfish_tpu_torch.demos.wing_thickness_opt [--num-el 6]
        [--p 3] [--maxiter 20] [--results DIR] [--device cpu]

A run killed and invoked again with the same results directory resumes
from its last accepted iterate (design and warm-start displacement).
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["setup", "main"]


def setup(num_el=6, p=3, device=None, system=None):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the thickness FFD `th`, the solve function `solve`, the
    objective `obj(dvs, d0) -> (W_int, d)`, the volume `vol(dvs)`, the
    align operator `A` (rows that vanish on a z-uniform design), the start
    volume `V0` and the `OptProblem` `prob`. `system`: a wing already built
    (its num_el, p and device stand), to pose a fresh problem on it."""
    from goldfish_tpu_torch.design.constraints import align_operator
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_ = wing.build(num_el=num_el, p=p, device=device) if system is None \
        else system
    dev = sys_.device
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    cp = sys_.cp
    V0 = float(sys_.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                        sys_.nu), d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, cp, th(dvs["h_ffd"]))

    A = align_operator(th.shape, axis=2)
    At = torch.tensor(A, dtype=torch.float64, device=dev)
    prob = OptProblem(device=dev)
    prob.add_design_var("h_ffd", th.init_h_ffd(wing.H_TH),
                        lower=wing.H_TH / 10, upper=wing.H_TH * 10,
                        scaler=1e2)
    prob.set_objective(obj, scaler=1.0, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("align", lambda dvs: At @ dvs["h_ffd"],
                        equals=np.zeros(A.shape[0]))
    return SimpleNamespace(sys=sys_, th=th, solve=solve, obj=obj, vol=vol,
                           A=A, V0=V0, prob=prob)


def main(num_el=6, p=3, maxiter=20, results="./results/wing_thopt",
         verbose=True, device=None, ns=None):
    """Run (or resume) the optimization; returns (result, system, FFD).
    `ns`: a `setup` namespace to run instead of building one (its
    `prob.iter_callback` is kept; the checkpoint chains after it)."""
    from goldfish_tpu_torch.utils.checkpoint import Checkpointer, resume_run
    from goldfish_tpu_torch.utils.profiling import profiler
    from goldfish_tpu_torch.utils.vtk_io import SurfaceWriter

    ns = setup(num_el, p, device) if ns is None else ns
    sys_, th = ns.sys, ns.th
    ck = Checkpointer(os.path.join(results, "opt_state.npz"))
    with profiler.stage("slsqp_total"):
        res, _ = resume_run(ns.prob, ck, maxiter=maxiter, tol=1e-12,
                            verbose=verbose)
    with profiler.stage("final_solve"), torch.no_grad():
        h_op = th(torch.tensor(res.x["h_ffd"], device=sys_.device))
        d_op = ns.solve(sys_.cp, h_op, sys_.zero_displacement())
    SurfaceWriter(sys_, save_path=results).save(d=d_op, h=h_op, tag="final")
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} "
              f"({res.nit} SLSQP its, {res.message})")
        print(profiler.summary())
    return res, sys_, th


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=6)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=20)
    ap.add_argument("--results", default="./results/wing_thopt")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, p=a.p, maxiter=a.maxiter, results=a.results,
         device=a.device)
