"""Fixed-intersection T-beam shape optimization (FFD, x field).

Port of demos/tbeam_shape_opt.py (reference role:
demos_om/shape_opt/T-beam/T_beam_shape_opt_wint.py): a 2-patch T-beam
whose web starts off-center, clamped at y = 0 and loaded by a follower
pressure on the flange. The design is the x coefficients of an FFD block
(num_els (3, 1, 2), degree (3, 1, 2)); the constraints are the block's pin
rows (its x-faces and its clamped-edge face keep their values), first
differences along x of at least 1e-2 (no folding) and constant volume; the
objective is the internal energy. SLSQP moves the web back toward the
flange center, where it stiffens most.

    python -m goldfish_tpu_torch.demos.tbeam_shape_opt [--num-el 6]
        [--maxiter 20] [--device cpu]
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["E", "NU", "H_TH", "LENGTH", "WIDTH", "DEPTH", "PRESSURE",
           "build", "setup", "web_x", "main"]

E = 1.0e12
NU = 0.0
H_TH = 0.1
LENGTH = 20.0
WIDTH = 2.0
DEPTH = 2.0
PRESSURE = 1.0


def build(num_el=6, p=3, x_web=0.4, device=None):
    """The T-beam with its web seam at x = x_web (the flange is linear in
    x, so the seam lies at u = (x_web + W/2) / W)."""
    from goldfish_tpu_torch.models.tbeam import create_surf
    from goldfish_tpu_torch.physics.coupling import InterfaceSpec
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    w2 = WIDTH / 2.0
    pts0 = [[-w2, 0.0, 0.0], [w2, 0.0, 0.0],
            [-w2, LENGTH, 0.0], [w2, LENGTH, 0.0]]
    pts1 = [[x_web, 0.0, 0.0], [x_web, 0.0, -DEPTH],
            [x_web, LENGTH, 0.0], [x_web, LENGTH, -DEPTH]]
    srf0 = create_surf(pts0, max(num_el // 2, 2), num_el, p)
    srf1 = create_surf(pts1, max((num_el + 1) // 2, 2), num_el + 1, p)
    u_seam = (x_web + w2) / WIDTH
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[u_seam, 0.0], [u_seam, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=2 * (num_el + 1))]
    sys_ = NonMatchingSystem([srf0, srf1], E, NU, H_TH, specs=specs,
                             device=device)
    sys_.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys_.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys_.set_pressure([-PRESSURE, 0.0])
    return sys_


def setup(num_el=6, p=3, x_web=0.4, device=None):
    """The optimization problem, not yet run: a namespace with `sys`, the
    FFD map `ffd`, `solve`, `obj(dvs, d0) -> (W_int, d)`, `vol`, the start
    `p0`, its volume `V0` and the `OptProblem` `prob`."""
    from goldfish_tpu_torch.design.constraints import (
        pin_operator,
        regu_operator,
    )
    from goldfish_tpu_torch.design.pipeline import ShapeFFD
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_ = build(num_el, p, x_web, device)
    dev = sys_.device
    w2 = WIDTH / 2.0
    ffd = ShapeFFD(sys_, num_els=(3, 1, 2), p=(3, 1, 2),
                   lims=np.array([[-w2 - 1e-3, w2 + 1e-3],
                                  [0.0, LENGTH],
                                  [-DEPTH - 1e-3, 1e-3]]),
                   opt_fields=(0,))
    nx, ny, nz = ffd.shape
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=40)

    def obj(dvs, d0):
        cp = ffd(dvs["p_x"])
        d = solve(cp, sys_.h_init, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                        sys_.E, sys_.nu), d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, ffd(dvs["p_x"]), sys_.h_init)

    # pin rows: the block's x-faces keep the flange edges at x = +-1, its
    # clamped-edge face (j = 0) keeps the support
    pinned = [(i, j, k) for i in (0, nx - 1)
              for j in range(ny) for k in range(nz)]
    pinned += [(i, 0, k) for i in range(1, nx - 1) for k in range(nz)]
    P = pin_operator(ffd.shape, pinned)
    D = regu_operator(ffd.shape, axis=0)
    Pt = torch.tensor(P, dtype=torch.float64, device=dev)
    Dt = torch.tensor(D, dtype=torch.float64, device=dev)

    p0 = ffd.init_p_ffd()
    with torch.no_grad():
        V0 = float(vol({"p_x": torch.tensor(p0, device=dev)}))
    prob = OptProblem(device=dev)
    prob.add_design_var("p_x", p0, lower=p0 - 0.8, upper=p0 + 0.8)
    prob.set_objective(obj, scaler=1e2, state0=sys_.zero_displacement())
    prob.add_constraint("pin", lambda dvs: Pt @ dvs["p_x"],
                        equals=np.asarray(P @ p0))
    prob.add_constraint("regu", lambda dvs: Dt @ dvs["p_x"], lower=1e-2)
    prob.add_constraint("volume", vol, equals=V0, scaler=1.0 / V0)
    return SimpleNamespace(sys=sys_, ffd=ffd, solve=solve, obj=obj, vol=vol,
                           p0=p0, V0=V0, prob=prob)


def web_x(ns, p_x):
    """The web's mean x over its CPs at the FFD design p_x."""
    with torch.no_grad():
        cp = ns.ffd(torch.tensor(p_x, device=ns.sys.device))
    n_cp1 = ns.sys.metas[1].n_cp
    return float(cp[1].reshape(-1, 3)[:n_cp1, 0].mean())


def main(num_el=6, p=3, maxiter=20, x_web=0.4, verbose=True, device=None,
         ns=None):
    """Returns (result, J0, web x at the optimum, system, FFD). `ns`: a
    `setup` namespace to run instead of building one."""
    ns = setup(num_el, p, x_web, device) if ns is None else ns
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)
    with torch.no_grad():
        J0, _ = ns.obj({"p_x": torch.tensor(ns.p0, device=ns.sys.device)},
                       ns.sys.zero_displacement())
    wx = web_x(ns, res.x["p_x"])
    if verbose:
        print(f"W_int: {float(J0):.6e} -> {res.fun:.6e} "
              f"({res.nit} its); web x: {x_web:.3f} -> {wx:.3f}")
    return res, float(J0), wx, ns.sys, ns.ffd


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=20)
    ap.add_argument("--num-el", type=int, default=6)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, device=a.device)
