"""Shape optimization: plate -> arch.

Port of demos/shape_opt_arch.py (reference: demos_om/shape_opt/arch and
the case study of arXiv 2410.02225). A flat multi-patch plate under a
downward areal dead load, pinned at both x-ends; the design is the z
coefficients of an FFD block (`ShapeFFD`, num_els (4, 1, 1), degree
(2, 1, 1), z field only) with its end slabs held at 0 by their bounds; the
objective is the internal energy. SLSQP bows the plate into an arch,
trading bending for membrane action: the strain energy drops by orders of
magnitude.

    python -m goldfish_tpu_torch.demos.shape_opt_arch [--num-el 4]
        [--maxiter 25] [--device cpu]
"""

from __future__ import annotations

import argparse
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["build", "setup", "main"]


def build(num_el=4, p=3, num_patches=3, device=None):
    """models.plate's plate with the cantilever set-up replaced: both
    x-ends pinned, a uniform dead load."""
    from goldfish_tpu_torch.models import plate

    sys_ = plate.build(num_el=num_el, p=p, num_patches=num_patches,
                       device=device)
    sys_._free[:] = sys_.stack.cp_mask.cpu().numpy()[..., None] * np.ones(3)
    sys_._data = None
    sys_.edge_load_entries = []
    sys_.add_side_bc(0, direction=0, side=0, n_layers=1)
    sys_.add_side_bc(num_patches - 1, direction=0, side=1, n_layers=1)
    sys_.set_dead_load([0.0, 0.0, -1.0e4])
    return sys_


def setup(num_el=4, p=3, num_patches=3, device=None):
    """The optimization problem, not yet run: a namespace with `sys`, the
    FFD map `ffd`, `solve`, `obj(dvs, d0) -> (W_int, d)`, the start `p0`
    and the `OptProblem` `prob`."""
    from goldfish_tpu_torch.design.pipeline import ShapeFFD
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_ = build(num_el, p, num_patches, device)
    ffd = ShapeFFD(sys_, num_els=(4, 1, 1), p=(2, 1, 1),
                   lims=np.array([[0.0, 1.0], [0.0, 1.0], [-0.02, 0.3]]),
                   opt_fields=(2,))
    solve = build_solve_fn(sys_.data, rtol=1e-10, max_it=40)

    def obj(dvs, d0):
        cp = ffd(dvs["p_z"])
        d = solve(cp, sys_.h_init, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                        sys_.E, sys_.nu), d

    p0 = ffd.init_p_ffd()
    nx = ffd.shape[0]
    # the supported ends: the block's first and last x-slabs stay put
    lb = np.full(p0.shape, -0.02)
    ub = np.full(p0.shape, 0.30)
    ix = np.arange(ffd.n_ffd) % nx  # x-fastest flattening
    lb[ix == 0] = ub[ix == 0] = 0.0
    lb[ix == nx - 1] = ub[ix == nx - 1] = 0.0
    prob = OptProblem(device=sys_.device)
    prob.add_design_var("p_z", p0, lower=lb, upper=ub, scaler=10.0)
    prob.set_objective(obj, scaler=1e-1, state0=sys_.zero_displacement())
    return SimpleNamespace(sys=sys_, ffd=ffd, solve=solve, obj=obj, p0=p0,
                           prob=prob)


def main(num_el=4, p=3, num_patches=3, maxiter=25, verbose=True,
         device=None, ns=None):
    """Returns (result, J0, system, FFD). `ns`: a `setup` namespace to run
    instead of building one."""
    ns = setup(num_el, p, num_patches, device) if ns is None else ns
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)
    with torch.no_grad():
        J0, _ = ns.obj({"p_z": torch.tensor(ns.p0, device=ns.sys.device)},
                       ns.sys.zero_displacement())
    if verbose:
        print(f"strain energy: {float(J0):.6e} -> {res.fun:.6e} "
              f"({res.nit} its)")
    return res, float(J0), ns.sys, ns.ffd


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=25)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, device=a.device)
