"""T-beam shape optimization with a moving intersection.

Port of demos/shape_opt_mint_tbeam.py (reference:
demos_om/shape_opt_mint/T-beam/T_beam_2patch_shopt_mi.py): the design is
the lateral (x) offsets of the web's spanwise control rows; as the web
bends, the web-flange intersection moves across the flange, and the
gradient flows through CP -> xi -> displacement -> energy (the port's
CP -> xi solve and moving-seam displacement solve, both implicit). The
first row, at the clamped end, is held at 0 by its bounds; the objective
is the strain energy under the tip load.

    python -m goldfish_tpu_torch.demos.shape_opt_mint_tbeam [--num-el 4]
        [--maxiter 15] [--device cpu]
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["build", "setup", "main"]


def build(num_el=4, p=3, device=None):
    """The 2-patch T-beam with a moving seam at the flange's middle,
    clamped at y = 0, a tip load on the flange's far corner."""
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.physics.coupling import InterfaceSpec
    from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
            [0, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = tbeam.create_surf(pts1, max((num_el + 1) // 2, 1), num_el + 1, p)
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=2 * num_el + 2)]
    sys_ = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU, tbeam.H_TH,
                               specs=specs, device=device)
    sys_.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys_.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys_.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys_


def setup(num_el=4, p=3, device=None):
    """The optimization problem, not yet run: a namespace with `sys`, the
    coupled `forward(cp, h, d0) -> (d, xi)`, `cp_of(dvs)`, `obj(dvs, d0) ->
    (W_int, d)`, the start `x0` and the `OptProblem` `prob`."""
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell

    sys_ = build(num_el, p, device)
    dev = sys_.device
    forward = sys_.build_forward(rtol=1e-10, max_it=25)
    m1 = sys_.metas[1]
    n_rows = m1.n_v
    row_of = torch.tensor(np.tile(np.arange(m1.n_v)[None, :],
                                  (m1.n_u, 1)).ravel(), device=dev)
    cp0 = sys_.cp

    def cp_of(dvs):
        delta = torch.zeros_like(cp0)
        delta[1, :m1.n_cp, 0] = dvs["web_dx"][row_of]
        return cp0 + delta

    def obj(dvs, d0):
        cp = cp_of(dvs)
        d, _ = forward(cp, sys_.h_init, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                        sys_.E, sys_.nu), d

    lb = np.full(n_rows, -0.35)
    ub = np.full(n_rows, 0.35)
    lb[0] = ub[0] = 0.0  # the clamped end stays put
    x0 = np.zeros(n_rows)
    prob = OptProblem(device=dev)
    prob.add_design_var("web_dx", x0, lower=lb, upper=ub, scaler=1.0)
    prob.set_objective(obj, scaler=1e2, state0=sys_.zero_displacement())
    return SimpleNamespace(sys=sys_, forward=forward, cp_of=cp_of, obj=obj,
                           x0=x0, prob=prob)


def main(num_el=4, p=3, maxiter=15, verbose=True, device=None, ns=None):
    """Returns (result, J0, system). `ns`: a `setup` namespace to run
    instead of building one."""
    ns = setup(num_el, p, device) if ns is None else ns
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)
    with torch.no_grad():
        J0, _ = ns.obj({"web_dx": torch.tensor(ns.x0, device=ns.sys.device)},
                       ns.sys.zero_displacement())
    if verbose:
        print(f"strain energy: {float(J0):.6e} -> {res.fun:.6e} "
              f"({res.nit} its, {res.message})")
    return res, float(J0), ns.sys


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=15)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, device=a.device)
