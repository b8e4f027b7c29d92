"""Draft-tube shape optimization with moving intersections and an FFD block.

Port of demos/draft_tube_shopt_mi_wffd.py: the 4-patch pressurized tube of
models/tube.py whose cross-section is FFD-parametrized (num_els (2, 2, 2),
degree 2, x and y fields); its four axial seams are differentiable
intersections, re-solved (CP -> xi) at every design, and the gradient runs
through both implicit solves (`MINonMatchingSystem.build_forward`). The
start is an ovalized cross-section (free-end layers stretched in x,
squeezed in y); the clamped-end FFD layer is pinned, so SLSQP must round
the pressurized tube back out while the support ring stays put.

    python -m goldfish_tpu_torch.demos.draft_tube_shopt_mi_wffd
        [--num-el 3] [--maxiter 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

from goldfish_tpu_torch.models import tube

__all__ = ["build_mi_tube", "setup", "main"]


def build_mi_tube(num_el=3, p=3, pressure=2.0e4, device=None):
    """The tube with its four seams as moving intersections of
    2 num_el + 3 points each."""
    from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

    specs = tube.seam_specs(num_el)
    n_pts = 2 * num_el + 3
    sys_ = MINonMatchingSystem(tube.surfaces(num_el, p), tube.E, tube.NU,
                               tube.H_TH, specs=specs,
                               n_pts_list=[n_pts] * len(specs),
                               device=device)
    for k in range(4):
        sys_.add_side_bc(k, direction=0, side=0, n_layers=2)
    sys_.set_pressure([pressure] * 4)
    return sys_


def setup(num_el=3, p=3, device=None, pressure=2.0e4):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the FFD map `sh`, the forward `forward(cp, h, d0) -> (d, xi)`
    (its displacement solve is `forward.solve_d`), the objective `obj(dvs,
    d_prev) -> (J, d)`, the unperturbed `p0`, the ovalized start `p_start`,
    the pin operator `A_pin2` (numpy) and the `OptProblem` `prob`."""
    from goldfish_tpu_torch.design.constraints import pin_operator
    from goldfish_tpu_torch.design.pipeline import ShapeFFD
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell

    sys_ = build_mi_tube(num_el=num_el, p=p, pressure=pressure,
                         device=device)
    dev = sys_.device
    sh = ShapeFFD(sys_, num_els=(2, 2, 2), p=2, opt_fields=(0, 1))
    forward = sys_.build_forward(rtol=1e-9, max_it=25)

    # pin the clamped-end FFD layer (z-slab 0) so the support ring cannot
    # move
    nx, ny, nz = sh.shape
    pinned = [(i, j, 0) for i in range(nx) for j in range(ny)]
    A_pin2 = np.kron(np.eye(2), pin_operator(sh.shape, pinned))
    At = torch.tensor(A_pin2, dtype=torch.float64, device=dev)

    def obj(dvs, d_prev):
        cp = sh(dvs["p_ffd"])
        d, xi = forward(cp, sys_.h_init, d_prev)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init, sys_.E,
                                     sys_.nu)
        return J, d

    p0 = sh.init_p_ffd()
    # start from an ovalized cross-section (free-end layers squeezed)
    n = sh.n_ffd
    k_of_dof = np.arange(n) // (nx * ny)     # x-fastest dof order
    free_z = (k_of_dof > 0).astype(float)
    p_start = p0.copy()
    p_start[:n] *= 1.0 + 0.08 * free_z        # stretch x
    p_start[n:] *= 1.0 - 0.07 * free_z        # squeeze y
    prob = OptProblem(device=dev)
    prob.add_design_var("p_ffd", p_start, lower=p0 - 0.3 * tube.RADIUS,
                        upper=p0 + 0.3 * tube.RADIUS)
    prob.set_objective(obj, state0=sys_.zero_displacement())
    prob.add_constraint("pin", lambda dvs: At @ dvs["p_ffd"],
                        equals=np.asarray(A_pin2 @ p0))
    return SimpleNamespace(sys=sys_, sh=sh, forward=forward, obj=obj, p0=p0,
                           p_start=p_start, A_pin2=A_pin2, prob=prob)


def main(num_el=3, p=3, maxiter=4, verbose=True, device=None):
    ns = setup(num_el, p, device)
    t0 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} ({res.nit} its, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
    return res, ns.sys, ns.sh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=4)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, device=a.device)
