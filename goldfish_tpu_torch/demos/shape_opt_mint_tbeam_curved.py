"""T-beam shape optimization with a CURVED moving intersection.

Port of demos/shape_opt_mint_tbeam_curved.py: a sinusoidally swept web
crosses a flat flange transversally; the intersection is a curved
parametric polyline, traced by the preprocessor (marching Newton, then
the equal-arc-length polish by the CP -> xi solve: kernels K5 and K7 on
the card), fed through polyline InterfaceSpecs and solved again (CP -> xi)
at every design step (K5-K7 with the MI shell solve). Design: the
amplitudes of three sine sweep modes of the web; objective W_int.

    python -m goldfish_tpu_torch.demos.shape_opt_mint_tbeam_curved
        [--num-el 4] [--maxiter 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["build_curved_mi", "setup", "main"]


def build_curved_mi(num_el=4, p=3, amp=0.06, n_pts=11, device=None):
    """The flange and the swept web, their seam traced by the preprocessor;
    returns (MI system, preprocessor)."""
    from goldfish_tpu_torch.geometry.nurbs import NURBS
    from goldfish_tpu_torch.geometry.preprocessing import Preprocessor
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

    w2 = tbeam.WIDTH / 2
    zs_top = 0.25 * tbeam.DEPTH
    flange = tbeam.create_surf(
        [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
         [w2, tbeam.LENGTH, 0]], num_el, num_el, p)
    web = tbeam.create_surf(
        [[0, 0, zs_top], [0, 0, -tbeam.DEPTH],
         [0, tbeam.LENGTH, zs_top], [0, tbeam.LENGTH, -tbeam.DEPTH]],
        max(num_el // 2, 1), num_el + 1, p)
    ctrl = web.control.copy()
    gv = web.greville_points(1)
    bend = amp * np.sin(np.pi * gv)
    w = ctrl[..., 3:4]
    ctrl[..., 0:1] = ctrl[..., 0:1] + bend[None, :, None] * w
    web = NURBS(web.knots, ctrl)

    pre = Preprocessor([flange, web], device=device).compute_intersections(
        rtol=2e-4, mortar_refine=2)
    if pre.num_intersections != 1:
        raise RuntimeError(f"expected one seam, the preprocessor found "
                           f"{pre.num_intersections}")
    sys_ = MINonMatchingSystem([flange, web], tbeam.E, tbeam.NU, tbeam.H_TH,
                               specs=pre.interface_specs(),
                               n_pts_list=[n_pts], device=device)
    sys_.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys_.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys_.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys_, pre


def setup(num_el=4, p=3, device=None):
    """The optimization problem, not yet run: a namespace with the system
    `sys`, the preprocessor `pre`, the forward map `forward(cp, h, d0) ->
    (d, xi)`, the design map `cp_of(amp)`, the objective `obj(dvs, d0) ->
    (W_int, d)` and the `OptProblem` `prob` (design "amp", 3 modes)."""
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import kl_shell

    sys_, pre = build_curved_mi(num_el=num_el, p=p, device=device)
    dev = sys_.device
    forward = sys_.build_forward(rtol=1e-10, max_it=25)
    m = sys_.metas[1]
    gv = sys_.surfs[1].greville_points(1)
    modes = np.stack([np.tile(np.sin((k + 1) * np.pi * gv)[None, :],
                              (m.n_u, 1)).ravel()
                      for k in range(3)])  # 3 sweep modes (3, n_cp)
    P, C = sys_.cp.shape[:2]
    M = np.zeros((P, C, 3, 3))
    M[1, : m.n_cp, 0, :] = modes.T
    Mt = torch.tensor(M.reshape(-1, 3), dtype=torch.float64, device=dev)

    def cp_of(amp):
        return sys_.cp + (Mt @ amp).reshape(P, C, 3)

    def obj(dvs, d_prev):
        cp = cp_of(dvs["amp"])
        d, _ = forward(cp, sys_.h_init, d_prev)
        return kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                        sys_.E, sys_.nu), d

    prob = OptProblem(device=dev)
    prob.add_design_var("amp", np.zeros(3), lower=-0.1 * tbeam.WIDTH,
                        upper=0.1 * tbeam.WIDTH)
    prob.set_objective(obj, state0=sys_.zero_displacement())
    return SimpleNamespace(sys=sys_, pre=pre, forward=forward, cp_of=cp_of,
                           obj=obj, prob=prob)


def main(num_el=4, p=3, maxiter=4, verbose=True, device=None):
    ns = setup(num_el, p, device)
    if verbose:
        xiA = ns.pre.intersections_para_coords[0][0]
        chord = np.linspace(xiA[0], xiA[-1], xiA.shape[0])
        print(f"curved seam: {xiA.shape[0]} pts, max parametric "
              f"deviation from chord {np.max(np.abs(xiA - chord)):.4f}",
              flush=True)
    t0 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.6e} -> {res.fun:.6e} ({res.nit} its, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
    return res, ns.sys


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=4)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, device=a.device)
