"""Fixed-intersection tube shape optimization (FFD, x + y fields).

Port of demos/tube_shape_opt.py: the 4-patch tube of models/tube.py with
its cross-section squashed into an ellipse (affine scaling of the circle's
homogeneous CPs, so the geometry stays exact), under an internal follower
pressure. The design is the x and y coefficients of an FFD block
(num_els (2, 2, 1), degree (3, 3, 1)); the objective is the internal
energy at the Newton solution, its gradient the implicit-function adjoint;
the clamped-end FFD slab is pinned (equality) and the first differences
along x and y stay >= 1e-3 (regu). Pressurizing an elliptical tube bends
the wall, so SLSQP rounds the cross-section back toward the
membrane-dominated circle.

    python -m goldfish_tpu_torch.demos.tube_shape_opt [--num-el 4]
        [--maxiter 15] [--device cpu]
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.models import tube
from goldfish_tpu_torch.solver.system import NonMatchingSystem

__all__ = ["SCALE_X", "SCALE_Y", "build", "setup", "roundness", "main"]

SCALE_X, SCALE_Y = 1.30, 0.72


def build(num_el=4, p=3, pressure=2.0e4, device=None):
    """models.tube geometry, cross-section scaled to an ellipse."""
    surfs = []
    for s in tube.surfaces(num_el, p):
        c = s.control.copy()
        c[..., 0] *= SCALE_X  # homogeneous wx scales the point x
        c[..., 1] *= SCALE_Y
        surfs.append(NURBS(s.knots, c))
    sys_ = NonMatchingSystem(surfs, tube.E, tube.NU, tube.H_TH,
                             specs=tube.seam_specs(num_el), device=device)
    for k in range(4):
        sys_.add_side_bc(k, direction=0, side=0, n_layers=2)
    sys_.set_pressure([pressure] * 4)
    return sys_


def setup(num_el=4, p=3, device=None, pressure=2.0e4):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the FFD map `ffd`, the solve function `solve` (its persistent
    factor is `solve.device_factor`), the objective `obj(dvs, d0) -> (J,
    d)`, the start `p0`, the pin and regu operators `P`, `D` (numpy) and
    the `OptProblem` `prob`."""
    from goldfish_tpu_torch.design.constraints import (
        pin_operator,
        regu_operator,
    )
    from goldfish_tpu_torch.design.pipeline import ShapeFFD
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_ = build(num_el, p, pressure, device=device)
    dev = sys_.device
    R = tube.RADIUS
    m = 1.05 * max(SCALE_X * R, SCALE_Y * R)
    ffd = ShapeFFD(sys_, num_els=(2, 2, 1), p=(3, 3, 1),
                   lims=np.array([[-m, m], [-m, m],
                                  [-1e-3, tube.LENGTH + 1e-3]]),
                   opt_fields=(0, 1))
    nx, ny, nz = ffd.shape
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=40)

    def obj(dvs, d0):
        cp = ffd(dvs["p_xy"])
        d = solve(cp, sys_.h_init, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init, sys_.E,
                                     sys_.nu)
        return J, d

    # pin the clamped-end (k = 0) z-slab in both fields so the support
    # geometry stays put
    pinned = [(i, j, 0) for i in range(nx) for j in range(ny)]
    P1 = pin_operator(ffd.shape, pinned)
    P = np.block([[P1, np.zeros_like(P1)], [np.zeros_like(P1), P1]])
    # regu: x spacing monotone along the block's x axis, y along y
    Dx = regu_operator(ffd.shape, axis=0)
    Dy = regu_operator(ffd.shape, axis=1)
    D = np.block([[Dx, np.zeros_like(Dx)], [np.zeros_like(Dy), Dy]])
    Pt = torch.tensor(P, dtype=torch.float64, device=dev)
    Dt = torch.tensor(D, dtype=torch.float64, device=dev)

    p0 = ffd.init_p_ffd()
    prob = OptProblem(device=dev)
    prob.add_design_var("p_xy", p0, lower=p0 - 0.45 * R, upper=p0 + 0.45 * R)
    prob.set_objective(obj, scaler=1.0, state0=sys_.zero_displacement())
    prob.add_constraint("pin", lambda dvs: Pt @ dvs["p_xy"],
                        equals=np.asarray(P @ p0))
    prob.add_constraint("regu", lambda dvs: Dt @ dvs["p_xy"], lower=1e-3)
    return SimpleNamespace(sys=sys_, ffd=ffd, solve=solve, obj=obj, p0=p0,
                           P=P, D=D, prob=prob)


def roundness(sys_, cp):
    """max/min radius of the free-end cross-section (the four patches at
    xi = (1, 0.5))."""
    from goldfish_tpu_torch.ops.bspline import rational_basis_2d

    pts = []
    cpn = cp.detach().cpu().numpy()
    for k in range(4):
        s = sys_.surfs[k]
        pd, qd = s.degree
        conn, tab = rational_basis_2d(s.knots[0], s.knots[1], pd, qd,
                                      s.weights, np.array([[1.0, 0.5]]),
                                      nd=0)
        pts.append(tab[(0, 0)][0] @ cpn[k][conn[0]])
    r = np.linalg.norm(np.asarray(pts)[:, :2], axis=1)
    return float(r.max() / r.min())


def main(num_el=4, p=3, maxiter=15, verbose=True, device=None):
    ns = setup(num_el, p, device)
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)
    with torch.no_grad():
        J0, _ = ns.obj({"p_xy": torch.tensor(ns.p0, device=ns.sys.device)},
                       ns.sys.zero_displacement())
    if verbose:
        cp_opt = ns.ffd(torch.tensor(res.x["p_xy"], device=ns.sys.device))
        print(f"W_int: {float(J0):.6e} -> {res.fun:.6e} ({res.nit} its); "
              f"axis ratio: {SCALE_X / SCALE_Y:.3f} -> "
              f"{roundness(ns.sys, cp_opt):.3f}")
    return res, float(J0), ns.sys, ns.ffd


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=15)
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()
    main(num_el=args.num_el, maxiter=args.maxiter, device=args.device)
