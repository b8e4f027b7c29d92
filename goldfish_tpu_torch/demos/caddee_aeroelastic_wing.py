"""CADDEE-structured aeroelastic wing: knot/CP lists + intersection cache
in, coupled aero-structural equilibrium + adjoint out.

Port of demos/caddee_aeroelastic_wing.py: the aircraft framework hands
`KLShellModel` raw knot vectors, control-point grids, a bc list and a
name1..name6 npz intersection cache (written here by the preprocessor and
read back); an analytic aero stand-in (local incidence from the
z-displacement tilts the lift on the upper skins) feeds distributed
forces; n_fp fixed-point passes close the coupling, and the coupled
adjoint dW_int/dh differentiates through the solves and the aero map
(autograd through `build_field_solve_fn`'s implicit adjoint).

    python -m goldfish_tpu_torch.demos.caddee_aeroelastic_wing
        [--sections 3] [--num-el 3] [--p 3] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

__all__ = ["build_knot_cp_lists", "main"]


def build_knot_cp_lists(n_sections=3, num_el=3, p=3, device=None):
    """The CADDEE-side artifacts: per-surface knot vectors and homogeneous
    CP grids of the box wing (models/boxwing.py), the bc list and the upper
    skins' ids."""
    from goldfish_tpu_torch.models import boxwing

    base = boxwing.build(n_sections=n_sections, num_el=num_el, p=p,
                         device=device)
    knot_list = [[np.asarray(k) for k in s.knots] for s in base.surfs]
    cp_list = [np.asarray(s.control) for s in base.surfs]  # homogeneous
    bc_list = [[base.ids["rib0"], 1, 0]]
    upper = [base.ids[f"up{k}"] for k in range(n_sections)]
    return knot_list, cp_list, bc_list, upper


def main(n_sections=3, num_el=3, p=3, n_fp=4, q_dyn=2.0e2, alpha0=0.05,
         verbose=True, device=None):
    from goldfish_tpu_torch.caddee import KLShellModel
    from goldfish_tpu_torch.geometry.nurbs import NURBS
    from goldfish_tpu_torch.geometry.preprocessing import Preprocessor
    from goldfish_tpu_torch.models import boxwing

    knot_list, cp_list, bc_list, upper = build_knot_cp_lists(
        n_sections, num_el, p, device)

    # intersection cache round trip (the wing_int_data.npz role)
    surfs = [NURBS(k, c) for k, c in zip(knot_list, cp_list)]
    cache = os.path.join(tempfile.gettempdir(), "boxwing_int_data.npz")
    Preprocessor(surfs, device=device).compute_intersections(
        rtol=2e-4, mortar_refine=2).save_intersections_data(cache)

    model = KLShellModel(knot_list, cp_list, bc_list, int_data=cache,
                         E=boxwing.E, nu=boxwing.NU, h_th=boxwing.H_TH,
                         device=device)
    if verbose:
        print(f"KLShellModel: {model.num_surfs} surfaces, "
              f"{model.preprocessor.num_intersections} intersections",
              flush=True)

    sys_ = model.system
    dev = sys_.device
    solve = model.field_solver()
    cp = sys_.cp
    mask_up = np.zeros((sys_.num_splines, 1, 1))
    mask_up[upper] = 1.0
    mask_up = (torch.tensor(mask_up, device=dev)
               * sys_.stack.cp_mask[..., None])
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=dev)

    def aero(d):
        """Toy VLM stand-in: the local incidence from the z-displacement
        field tilts the lift on the upper skins (differentiable)."""
        twist = d[..., 2:3] / boxwing.HALF_SPAN
        lift = q_dyn * 2.0 * np.pi * (alpha0 - twist)
        return (lift * mask_up) * ez

    d0 = sys_.zero_displacement()
    h = sys_.h_init.clone().requires_grad_(True)
    with torch.enable_grad():
        d = d0
        for _ in range(n_fp):
            d = solve(cp, h, aero(d), d)
        J0 = model.internal_energy(d, h)
        (gh,) = torch.autograd.grad(J0, h)
    tip = sys_.evaluate_displacement(d.detach(), upper[-1], [0.5, 1.0])
    J0 = float(J0.detach())
    if verbose:
        print(f"aeroelastic equilibrium: tip u_z = {float(tip[2]):.6f} "
              f"m, W_int = {J0:.5e}", flush=True)
        print(f"|d W_int / d h| (coupled adjoint): "
              f"{float(torch.linalg.norm(gh)):.4e}", flush=True)
    return J0, tip, gh, model


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", type=int, default=3)
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(n_sections=a.sections, num_el=a.num_el, p=a.p, device=a.device)
