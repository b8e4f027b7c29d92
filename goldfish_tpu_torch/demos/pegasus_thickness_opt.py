"""Pegasus-class full-scale thickness optimization: 91 coupled patches.

Port of demos/pegasus_thickness_opt.py, the counterpart of the reference's
largest problem (demos_om/thickness_opt/pegasus/pegasus_var_th_opt_wint.py:
203-206: 18 sections x 4 surfaces + ribs). The box wing of models/boxwing.py
(91 patches, 216 interfaces, N = 11466 padded dofs at the default size) is
sized for minimum internal energy W_int at constant volume with SLSQP
(`OptProblem.run_slsqp`), its state warm-started between evaluations.

Design: a spanwise thickness FFD (`ThicknessFFD`, num_els (1, 6, 1), degree
(1, 2, 1)), or one constant thickness per patch with `const_th`
(`PatchConstantThickness`, the reference's pegasus_const_th_opt_wint.py
parametrization).

Routes (`route`):
- "dense" (the default): the persistent Cholesky factor with refinement
  (`implicit.build_solve_fn`), as scripts/pegasus_slsqp_only.py runs it;
- "krylov", the reference demo's route: Newton-Krylov forward and GMRES-IR
  adjoint (`krylov.build_solve_fn_krylov`), the exact tangent applied by
  kernel K4, preconditioned by the dense f64 LU of K refactored at every
  Newton iteration. The reference's pair-Schwarz preconditioner does not
  converge on box wings (ROADMAP Queue C), so this route holds the same
  O(N^2) matrix as the dense one and costs more per evaluation; it is kept
  for a preconditioner that does without the dense LU.

    python -m goldfish_tpu_torch.demos.pegasus_thickness_opt [--sections 18]
        [--num-el 3] [--maxiter 5] [--const-th] [--route dense|krylov]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import torch

from goldfish_tpu_torch.models import boxwing

__all__ = ["setup", "main"]


def setup(n_sections=18, num_el=3, p=3, const_th=False, route="dense",
          device=None):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the thickness map `th`, the solve function `solve`, the objective
    `obj(dvs, d0) -> (W_int, d)`, the volume `vol(dvs)`, the start `x0`
    (numpy), the volume `V0` and the `OptProblem` `prob` (design variable
    "h_ffd", volume equality)."""
    from goldfish_tpu_torch.design.pipeline import (
        PatchConstantThickness,
        ThicknessFFD,
    )
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell

    sys_ = boxwing.build(n_sections=n_sections, num_el=num_el, p=p,
                         device=device)
    dev = sys_.device
    if const_th:
        th = PatchConstantThickness(sys_)
        x0 = th.init_h(boxwing.H_TH)
    else:
        th = ThicknessFFD(sys_, num_els=(1, 6, 1), p=(1, 2, 1))
        x0 = th.init_h_ffd(boxwing.H_TH)
    if route == "krylov":
        from goldfish_tpu_torch.solver.krylov import build_solve_fn_krylov

        solve = build_solve_fn_krylov(sys_.data, rtol=1e-8, cg_rtol=1e-8)
    elif route == "dense":
        from goldfish_tpu_torch.solver.implicit import build_solve_fn

        solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    else:
        raise ValueError(f"route: {route!r}, expected 'krylov' or 'dense'")
    cp = sys_.cp
    V0 = float(sys_.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                        sys_.nu), d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, cp, th(dvs["h_ffd"]))

    prob = OptProblem(device=dev)
    prob.add_design_var("h_ffd", x0, lower=boxwing.H_TH / 5,
                        upper=boxwing.H_TH * 5, scaler=1e2)
    prob.set_objective(obj, scaler=1.0, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    return SimpleNamespace(sys=sys_, th=th, solve=solve, obj=obj, vol=vol,
                           x0=x0, V0=V0, prob=prob)


def main(n_sections=18, num_el=3, p=3, maxiter=5, verbose=True,
         const_th=False, route="dense", device=None):
    t0 = time.perf_counter()
    ns = setup(n_sections, num_el, p, const_th, route, device)
    s = ns.sys
    if verbose:
        n_dofs = sum(m.n_cp for m in s.metas) * 3
        print(f"pegasus-class: {s.num_splines} patches, {len(s.specs)} "
              f"intersections, {n_dofs} dofs (build "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
    t1 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    wall = time.perf_counter() - t1
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        with torch.no_grad():
            V1 = float(ns.vol({"h_ffd": torch.tensor(
                res.x["h_ffd"], dtype=torch.float64, device=s.device)}))
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} ({res.nit} SLSQP its, "
              f"{wall:.1f}s wall, {wall / max(res.nit, 1):.1f}s/it); "
              f"volume {ns.V0:.6e} -> {V1:.6e}", flush=True)
    return res, s, ns.th, wall


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", type=int, default=18)
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=5)
    ap.add_argument("--const-th", action="store_true",
                    help="one thickness per patch (the reference's "
                         "pegasus_const_th_opt_wint.py parametrization)")
    ap.add_argument("--route", default="dense", choices=("dense", "krylov"))
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(n_sections=a.sections, num_el=a.num_el, p=a.p, maxiter=a.maxiter,
         const_th=a.const_th, route=a.route, device=a.device)
