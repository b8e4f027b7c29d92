"""Reference numbers for the PyTorch port's contact press and Riks paths
(JAX, CPU, f64).

- `press<n>`: tests/test_contact.py's two-plate press (`_press_problem`:
  two clamped plates 0.12 apart, q = 120 on the upper one, k_pen = 1e7,
  r_max = 0.1) at num_el=n: `continuation_solve` (4 levels, rtol 1e-9,
  max_it 40) from d = 0, then `build_solve_fn(rtol=1e-10, max_it=60)` warm
  at the equilibrium, J = W_int and dJ/dh by the adjoint, and the test's
  central difference along its seeded v (eps 1e-6). Writes d, W_c, the
  midspan deflection, |r|/|r(0)|, J, dJ/dh (P, C), ad, fd and the walls.
- `riks<n>`: tests/test_riks.py's shallow cylindrical panel (hinged edges,
  centre point load 4000) at num_el=n: `riks_solve(lam_target=1,
  dlam0=0.02, rtol=1e-6, dl_max=60, max_steps=150)`. Writes the final d
  and lam, |r|/|q| at lam = 1, the path's (lam, |d|), lam_peak, lam_valley,
  the pre-limit |d| and the wall.

The machine with the GPU has no JAX, so `chip_smoke.py` and the port's CPU
tests check the port against tests/data/torch_port_contact_reference.json.

    JAX_PLATFORMS=cpu python scripts/torch_port_contact_reference.py
        [--only press4 press6 riks6 riks24]

Each part is merged into the existing file as it ends.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_contact_reference.json")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

FD_EPS = 1e-6


def press_case(num_el):
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.physics.contact import contact_energy
    from goldfish_tpu.solver.implicit import build_solve_fn, \
        continuation_solve
    from goldfish_tpu.solver.system import residual
    from test_contact import _press_problem

    s = _press_problem(num_el=num_el)
    data = s.data
    t0 = time.perf_counter()
    d, it, rn = continuation_solve(data, s.cp, s.h_init,
                                   s.zero_displacement(), n_steps=4,
                                   rtol=1e-9, max_it=40)
    d.block_until_ready()
    t_cont = time.perf_counter() - t0
    r0 = float(jnp.linalg.norm(residual(data, jnp.zeros_like(d), s.cp,
                                        s.h_init)))
    Wc = float(contact_energy(data.contact, s.stack, d, s.cp))
    mid = float(s.evaluate_displacement(d, 0, [0.5, 0.5])[2])

    solve = build_solve_fn(data, rtol=1e-10, max_it=60)

    def J_of_h(h):
        dd = solve(s.cp, h, d)
        return kl_shell.internal_energy(s.stack, dd, s.cp, h, s.E, s.nu)

    h0 = s.h_init
    t0 = time.perf_counter()
    J, g = jax.value_and_grad(J_of_h)(h0)
    g.block_until_ready()
    t_adj = time.perf_counter() - t0
    v = jnp.asarray(np.random.default_rng(3).normal(
        size=np.asarray(h0).shape) * np.asarray(s.stack.cp_mask))
    fd = float((J_of_h(h0 + FD_EPS * v) - J_of_h(h0 - FD_EPS * v))
               / (2 * FD_EPS))
    ad = float(jnp.sum(g * v))
    P, C = s.stack.n_patches, s.stack.max_cp
    return dict(num_el=num_el, P=P, C=C, N=P * C * 3, d=np.asarray(d).tolist(),
                W_c=Wc, mid_uz=mid, rn=float(rn), r0=r0, its_last=int(it),
                J=float(J), dJ_dh=np.asarray(g).tolist(), ad=ad, fd=fd,
                fd_rel=abs(ad - fd) / abs(fd), seconds_continuation=t_cont,
                seconds_value_and_grad=t_adj)


def riks_case(num_el):
    import jax.numpy as jnp

    from goldfish_tpu.solver.riks import riks_solve
    from goldfish_tpu.solver.system import residual, scale_loads
    from test_riks import _panel

    s = _panel(num_el=num_el)
    d0 = s.zero_displacement()
    t0 = time.perf_counter()
    d, lam, path = riks_solve(s.data, s.cp, s.h_init, d0, lam_target=1.0,
                              dlam0=0.02, rtol=1e-6, dl_max=60.0,
                              max_steps=150)
    t = time.perf_counter() - t0
    lams = np.array([p[0] for p in path])
    norms = np.array([p[1] for p in path])
    i_peak = int(np.argmax(lams[: len(lams) // 2]))
    data1 = scale_loads(s.data, 1.0)
    rn = float(jnp.linalg.norm(residual(data1, d, s.cp, s.h_init)
                               * s.data.free))
    q0 = float(jnp.linalg.norm(residual(data1, d0, s.cp, s.h_init)
                               * s.data.free))
    P, C = s.stack.n_patches, s.stack.max_cp
    return dict(num_el=num_el, P=P, C=C, N=P * C * 3,
                d=np.asarray(d).tolist(), lam=float(lam),
                rn_over_q=rn / q0, path_lam=lams.tolist(),
                path_norm=norms.tolist(), lam_peak=float(lams[i_peak]),
                lam_valley=float(lams[i_peak:].min()),
                pre_norm=float(norms[: i_peak + 1].max()),
                n_points=len(path), seconds=t)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*",
                    default=["press4", "press6", "riks6", "riks24"])
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_enable_x64", True)
    out = {}
    if os.path.exists(OUT):
        with open(OUT) as fh:
            out = json.load(fh)
    for part in args.only:
        t0 = time.perf_counter()
        kind, n = part.rstrip("0123456789"), int(part.lstrip("presik"))
        out[part] = (press_case if kind == "press" else riks_case)(n)
        print(f"{part}: {time.perf_counter() - t0:.1f} s", flush=True)
        with open(OUT, "w") as fh:
            json.dump(out, fh)


if __name__ == "__main__":
    main()
