"""Thickness optimization of a plate with a circular hole under in-plane
tension: the trimmed-surface demo.

Port of demos/plate_hole_thickness_opt.py. The hole is a parameter-space
trim loop honored by cut-cell quadrature (geometry/trim.py: a
`trim_subdiv`-subdivided rule, coverage weights in (0, 1] on cut cells,
void elements dropped). In-plane tension concentrates stress at the hole;
minimizing the strain energy at fixed material volume thickens the hole
band and thins the far field. SLSQP over a 4 x 4 thickness FFD, the state
warm-started between evaluations.

    python -m goldfish_tpu_torch.demos.plate_hole_thickness_opt
        [--num-el 8] [--maxiter 20] [--results DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["build_system", "setup", "near_far", "main"]


def build_system(num_el=8, r_hole=0.25, trim_subdiv=4, device=None):
    from goldfish_tpu_torch.geometry.cadkit import bilinear
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    s = bilinear([0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0])
    s = s.elevate(0, 2).elevate(1, 2)
    rr = np.linspace(0, 1, num_el + 1)[1:-1]
    s = s.refine(0, rr).refine(1, rr)
    t = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    hole = np.stack([0.5 + r_hole * np.cos(t),
                     0.5 + r_hole * np.sin(t)], axis=-1)
    sys_ = NonMatchingSystem([s], 1e7, 0.3, 1e-2, trims=[(None, [hole])],
                             trim_subdiv=trim_subdiv, device=device)
    # 2 layers: one layer leaves the rigid rotation about the clamped
    # edge as an exact zero-energy mode (K singular at d = 0)
    sys_.add_side_bc(0, direction=0, side=0, n_layers=2)
    sys_.add_edge_load(0, direction=0, side=1, force=[20.0, 0.0, 0.0])
    return sys_, hole


def setup(num_el=8, r_hole=0.25, trim_subdiv=4, device=None):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the thickness FFD `th`, the solve function `solve`, the objective
    `obj(dvs, d0) -> (W_int, d)`, the start `x0`, the volume `V0` and the
    `OptProblem` `prob`."""
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_, hole = build_system(num_el, r_hole, trim_subdiv, device)
    h0_val = float(sys_.h_init.max())
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
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

    x0 = th.init_h_ffd(h0_val)
    prob = OptProblem(device=sys_.device)
    prob.add_design_var("h_ffd", x0, lower=h0_val / 10, upper=h0_val * 10,
                        scaler=1e2)
    prob.set_objective(obj, scaler=1e2, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    return SimpleNamespace(sys=sys_, hole=hole, r_hole=r_hole, th=th,
                           solve=solve, obj=obj, x0=x0, V0=V0, prob=prob)


def near_far(sys_, h, r_hole):
    """Mean thickness coefficient of the CPs near the hole (r < 1.6 r_hole
    from its center) and far from it (r > 2.8 r_hole)."""
    xy = sys_.cp[0, :, :2].cpu().numpy()
    rdist = np.linalg.norm(xy - 0.5, axis=-1)
    h_cp = h[0].detach().cpu().numpy()
    return (float(h_cp[rdist < 1.6 * r_hole].mean()),
            float(h_cp[rdist > 2.8 * r_hole].mean()))


def main(num_el=8, maxiter=20, results="./results/plate_hole_thopt",
         verbose=True, r_hole=0.25, device=None):
    from goldfish_tpu_torch.utils.vtk_io import SurfaceWriter

    ns = setup(num_el, r_hole=r_hole, device=device)
    sys_ = ns.sys
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    with torch.no_grad():
        h_op = ns.th(torch.tensor(res.x["h_ffd"], device=sys_.device))
        d_op = ns.solve(sys_.cp, h_op, sys_.zero_displacement())
    near, far = near_far(sys_, h_op, r_hole)
    if verbose:
        print(f"J0={res.history[0]:.6e} J*={res.fun:.6e}")
        print(f"mean thickness near hole {near:.4e} vs far {far:.4e} "
              f"(ratio {near / far:.2f})")
    if results:
        os.makedirs(results, exist_ok=True)
        SurfaceWriter(sys_, save_path=results).save(d=d_op, h=h_op,
                                                    tag="final")
    return res, sys_, ns.th, (near, far)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=8)
    ap.add_argument("--maxiter", type=int, default=20)
    ap.add_argument("--results", default="./results/plate_hole_thopt")
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, results=a.results,
         device=a.device)
