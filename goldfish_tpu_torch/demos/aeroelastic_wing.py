"""Aeroelastic coupling demo with a strip-theory aero model.

Port of demos/aeroelastic_wing.py (reference analogue:
demos_csdl_alpha/ex_caddee/kl_shell_aeroelastic_coupling.py). The aero
model is a differentiable strip theory: the local lift is q 2 pi
alpha_eff, alpha_eff = alpha0 - the local twist of the deformed wing (the
spanwise slope of u_z at each control point, by a constant Greville
evaluation operator). The aeroelastic equilibrium is the fixed point

    f_k = aero(d_k);   d_{k+1} = solve(cp, h, f_k)

unrolled `n_fp` times. The solve is `implicit.build_field_solve_fn`: the
damped Newton solve on one persistent factor with the distributed load f
as an adjoint input (the JAX demo assembles K and solves it densely in its
adjoint; the port's adjoint is the certificate-gated refinement on the
persistent factor). d(strain energy)/dh through the coupled system is one
`torch.autograd.grad`.

    python -m goldfish_tpu_torch.demos.aeroelastic_wing [--num-el 3]
        [--p 3] [--n-chord 4] [--n-span 5] [--n-fp 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

__all__ = ["greville_dy_operator", "build_coupled", "main"]


def greville_dy_operator(system):
    """Constant per-patch operators (P, C, C), padded: d_z coefficients ->
    d(u_z)/dv at the Greville points (one row per CP)."""
    from goldfish_tpu_torch.ops.bspline import rational_basis_2d

    P, C = system.stack.n_patches, system.stack.max_cp
    G = np.zeros((P, C, C))
    for ip, m in enumerate(system.metas):
        s = m.surf
        gu = s.greville_points(0)
        gv = s.greville_points(1)
        pts = np.stack(np.meshgrid(gu, gv, indexing="ij"), -1).reshape(-1, 2)
        conn, tab = rational_basis_2d(
            s.knots[0], s.knots[1], *s.degree, s.weights, pts, nd=1)
        for k in range(pts.shape[0]):
            G[ip, k, conn[k]] = tab[(0, 1)][k]  # spanwise (v) derivative
    return torch.tensor(G, dtype=torch.float64, device=system.device)


def build_coupled(num_el=3, p=3, n_chord=4, n_span=5, n_fp=4, q_dyn=30.0,
                  alpha0=0.08, device=None):
    """Returns (J, sys_): J(h) -> (W_int, d) runs the coupled fixed point
    from d = 0 and is differentiable in h by autograd. `J.solve` is the
    field solve (its persistent factor `.device_factor`)."""
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_field_solve_fn

    sys_ = wing.build(n_chord=n_chord, n_span=n_span, num_el=num_el, p=p,
                      load_scale=0.0, device=device)
    solve = build_field_solve_fn(sys_.data, rtol=1e-9, max_it=25)
    G = greville_dy_operator(sys_)
    cp = sys_.cp
    mask = sys_.stack.cp_mask

    def aero(d):
        twist = torch.einsum("pij,pj->pi", G, d[..., 2]) / wing.HALF_SPAN
        lift = q_dyn * 2.0 * math.pi * (alpha0 - twist)
        z = torch.zeros_like(lift)
        return torch.stack([z, z, lift * mask], -1)

    def J(h):
        d = sys_.zero_displacement()
        for _ in range(n_fp):
            d = solve(cp, h, aero(d), d)
        return kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                        sys_.nu), d

    J.solve = solve
    return J, sys_


def main(num_el=3, p=3, n_chord=4, n_span=5, n_fp=4, q_dyn=30.0,
         alpha0=0.08, verbose=True, device=None):
    """Returns (J0, tip displacement (3,), dJ/dh (P, C), system)."""
    J, sys_ = build_coupled(num_el, p, n_chord, n_span, n_fp, q_dyn, alpha0,
                            device)
    h = sys_.h_init.detach().clone().requires_grad_(True)
    J0, d = J(h)
    (gh,) = torch.autograd.grad(J0, h)
    tip = sys_.evaluate_displacement(d, sys_.num_splines - 1, [0.5, 1.0])
    if verbose:
        print(f"aeroelastic equilibrium: tip u_z = {float(tip[2]):.5f} m, "
              f"W_int = {float(J0):.5e}")
        print(f"|d W_int / d h| (coupled adjoint): "
              f"{float(torch.linalg.norm(gh)):.4e}")
    return float(J0), tip, gh.detach(), sys_


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--n-chord", type=int, default=4)
    ap.add_argument("--n-span", type=int, default=5)
    ap.add_argument("--n-fp", type=int, default=4)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(num_el=a.num_el, p=a.p, n_chord=a.n_chord, n_span=a.n_span,
         n_fp=a.n_fp, device=a.device)
