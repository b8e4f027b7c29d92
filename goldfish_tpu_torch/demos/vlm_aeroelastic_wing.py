"""Aeroelastic wing with a vortex-lattice aero solver, coupled through the
shell's distributed-force adjoint input.

Port of demos/vlm_aeroelastic_wing.py: the VLM lattice rides the DEFORMED
shell midsurface (`vlm.lattice_points` on kernel K5's rows, which
`vlm.lattice_rows` computes once), panel forces (the AIC by kernel K11,
Gamma by `torch.linalg.solve`) feed back through
`implicit.build_field_solve_fn`'s f input, the coupled state is advanced by
n_fp unrolled fixed-point passes, and one `torch.autograd.grad` delivers
the coupled fluid-structure design gradient dW_int/dh through both solvers,
checked against a central difference.

    python -m goldfish_tpu_torch.demos.vlm_aeroelastic_wing [--n-chord 2]
        [--n-span 3] [--num-el 3] [--p 3] [--mc 6] [--ns 10] [--n-fp 4]
        [--device cpu]

Without --device it runs on the current CUDA device.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.models import wing
from goldfish_tpu_torch.ops.bspline_traced import make_surf_set
from goldfish_tpu_torch.physics import kl_shell
from goldfish_tpu_torch.physics.vlm import (
    build_lattice_param,
    forces_to_cp_field,
    lattice_points,
    lattice_rows,
    solve_panel_forces,
)
from goldfish_tpu_torch.solver.implicit import build_field_solve_fn

FD_EPS = 1e-6


def cp_parametric_locations(sys_, n_chord, n_span):
    """Global parametric location (n_cp_total, 2) of every flat CP, from
    the Greville points of the patch (i, j) covering [i/nc, (i+1)/nc] x
    [j/ns, (j+1)/ns] (models/wing.build's layout)."""
    cp_uv = []
    for j in range(n_span):
        for i in range(n_chord):
            s = sys_.surfs[j * n_chord + i]
            gu = np.asarray(s.greville_points(0))
            gv = np.asarray(s.greville_points(1))
            U = (i + gu[:, None]) / n_chord + 0 * gv[None, :]
            V = (j + gv[None, :]) / n_span + 0 * gu[:, None]
            cp_uv.append(np.stack([U.ravel(), V.ravel()], -1))
    return np.concatenate(cp_uv, axis=0)


def build_coupled(n_chord=2, n_span=3, num_el=3, p=3, mc=6, ns=10,
                  alpha=0.06, q_dyn=40.0, n_fp=4, rtol=1e-9, device=None):
    """Returns (J_of_h, sys_, h0): J_of_h(h, d0) -> (W_int, (d, lift)) runs
    the coupled aeroelastic fixed point from d0 and is differentiable in h
    by autograd. `J_of_h.solve` is the field solve (its persistent factor
    `.device_factor`, its Newton iterations per call `.solver.its_log`);
    `J_of_h.corners(d)` the deformed lattice corners at d."""
    sys_ = wing.build(n_chord=n_chord, n_span=n_span, num_el=num_el, p=p,
                      load_scale=0.0, device=device)
    dev = sys_.device
    ss, (pd, qd) = make_surf_set(sys_.surfs, device=dev)
    lay = CPLayout(sys_.metas, sys_.stack.max_cp, device=dev)
    lat = build_lattice_param(n_chord, n_span, mc, ns,
                              cp_uv=cp_parametric_locations(sys_, n_chord,
                                                            n_span),
                              device=dev)
    # K5 once: the corners' parametric points are fixed
    rows = lattice_rows(ss, pd, qd, lat)
    solve = build_field_solve_fn(sys_.data, rtol=rtol, max_it=30)
    cp = sys_.cp
    mask = sys_.stack.cp_mask[..., None]
    # solve_panel_forces uses V_inf = 1, rho = 2 q_dyn so that
    # 0.5 rho V^2 = q_dyn
    rho = 2.0 * q_dyn

    def aero_field(d):
        corners = lattice_points(ss, pd, qd, lat, cp, d, rows)
        F, aux = solve_panel_forces(corners, alpha, V_inf=1.0, rho=rho)
        f = forces_to_cp_field(lat, F, aux["area"], lay.to_padded)
        return f * mask, aux["lift"]

    def J_of_h(h, d0):
        d = d0
        lift = None
        for _ in range(n_fp):
            f, lift = aero_field(d)
            d = solve(cp, h, f, d)
        Wi = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        return Wi, (d, lift)

    J_of_h.solve = solve
    J_of_h.corners = lambda d: lattice_points(ss, pd, qd, lat, cp, d, rows)
    return J_of_h, sys_, sys_.h_init


def fd_direction(sys_, h0):
    """The demo's seeded finite-difference direction (real CPs only)."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=tuple(h0.shape)) \
        * sys_.stack.cp_mask.cpu().numpy()
    return torch.tensor(v, dtype=h0.dtype, device=h0.device)


def coupled_gradient(J_of_h, h0, d0):
    """(W_int, d, lift, dW_int/dh) of one coupled evaluation from d0."""
    h = h0.detach().clone().requires_grad_(True)
    J, (d, lift) = J_of_h(h, d0)
    (gh,) = torch.autograd.grad(J, h)
    return J.detach(), d.detach(), lift.detach(), gh


@torch.no_grad()
def fd_check(J_of_h, sys_, h0, d0, gh):
    """Central difference of W_int along the demo's direction against the
    adjoint's: (ad, fd, rel)."""
    v = fd_direction(sys_, h0)
    Jp, _ = J_of_h(h0 + FD_EPS * v, d0)
    Jm, _ = J_of_h(h0 - FD_EPS * v, d0)
    fd = float((Jp - Jm) / (2 * FD_EPS))
    ad = float((gh * v).sum())
    return ad, fd, abs(ad - fd) / max(abs(fd), 1e-300)


def main(n_chord=2, n_span=3, num_el=3, p=3, mc=6, ns=10, n_fp=4,
         check_fd=True, verbose=True, device=None):
    J_of_h, sys_, h0 = build_coupled(n_chord=n_chord, n_span=n_span,
                                     num_el=num_el, p=p, mc=mc, ns=ns,
                                     n_fp=n_fp, device=device)
    d0 = sys_.zero_displacement()
    J, d, lift, gh = coupled_gradient(J_of_h, h0, d0)
    tip = sys_.evaluate_displacement(d, sys_.num_splines - 1, [0.5, 1.0])
    if verbose:
        print(f"coupled aeroelastic: lift = {float(lift):.3f} N, "
              f"tip u_z = {float(tip[2]):.5f} m, W_int = {float(J):.5e}")
        print(f"|dW_int/dh| (coupled adjoint through VLM + shell): "
              f"{float(torch.linalg.norm(gh)):.4e}")

    rel = None
    if check_fd:
        ad, fd, rel = fd_check(J_of_h, sys_, h0, d0, gh)
        if verbose:
            print(f"coupled dJ/dh vs FD: ad={ad:.8e} fd={fd:.8e} "
                  f"rel={rel:.2e}")
        assert rel < 1e-5, rel
    return float(J), float(lift), np.asarray(tip), gh, rel, sys_


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-chord", type=int, default=2)
    ap.add_argument("--n-span", type=int, default=3)
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--mc", type=int, default=6)
    ap.add_argument("--ns", type=int, default=10)
    ap.add_argument("--n-fp", type=int, default=4)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(n_chord=a.n_chord, n_span=a.n_span, num_el=a.num_el, p=a.p,
         mc=a.mc, ns=a.ns, n_fp=a.n_fp, device=a.device)
