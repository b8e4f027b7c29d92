"""Reference numbers for the port's patch-sharding tests (JAX, CPU, f64).

The JAX package, unsharded, on the CPU:

- `wing_small`: the 4-patch wing `wing.build(n_chord=2, n_span=2,
  num_el=2, p=2)` (tests/test_sharding.py's size): Pi and r at d = 0
  and at a seeded state d (numpy seed 21, 1e-3 * normal on the free
  dofs), the Newton
  solve d from 0 (rtol 1e-10), and J = W_int with dJ/dh_ffd through
  `build_solve_fn(rtol=1e-8, max_it=12)` for `ThicknessFFD((2, 1, 1),
  (2, 1, 1))` (the dry run's wing leg at this size);
- `legs`: J and dJ of each of `__graft_entry__.dryrun_multichip`'s three
  legs (wing P=20, box wing P=91, the eVTOL MI wing box), unsharded, with
  the arrays padded to `padded_patch_count(P, 2)` as the dry run pads
  them for two devices.

tests/test_torch_sharding.py and tests/test_torch_multichip.py hold the
port against tests/data/torch_port_sharding_reference.json.

    JAX_PLATFORMS=cpu python scripts/torch_port_sharding_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_sharding_reference.json")
sys.path.insert(0, ROOT)

SEED = 21
N_RANKS = 2


def flat(a):
    return np.asarray(a, dtype=np.float64).ravel().tolist()


def seeded_d(free, seed=SEED):
    """The seeded state of the padded-equivalence test (numpy)."""
    rng = np.random.default_rng(seed)
    free = np.asarray(free)
    return 1e-3 * rng.standard_normal(free.shape) * free


def wing_small():
    import jax.numpy as jnp

    from goldfish_tpu.design.pipeline import ThicknessFFD
    from goldfish_tpu.models import wing
    from goldfish_tpu.solver.implicit import build_solve_fn, newton_solve
    from goldfish_tpu.solver.system import residual, total_potential

    s = wing.build(n_chord=2, n_span=2, num_el=2, p=2)
    d = jnp.asarray(seeded_d(s.data.free))
    z = s.zero_displacement()
    out = {"shape": list(np.shape(s.cp)),
           "Pi0": float(total_potential(s.data, z, s.cp, s.h_init)),
           "r0": flat(residual(s.data, z, s.cp, s.h_init)),
           "Pi": float(total_potential(s.data, d, s.cp, s.h_init)),
           "r": flat(residual(s.data, d, s.cp, s.h_init))}
    dsol, _, _ = newton_solve(s.data, s.cp, s.h_init, s.zero_displacement(),
                              rtol=1e-10)
    out["d_solve"] = flat(dsol)
    th = ThicknessFFD(s, num_els=(2, 1, 1), p=(2, 1, 1))
    solve = build_solve_fn(s.data, rtol=1e-8, max_it=12)
    J, g = _value_grad(s, th, solve, jnp.asarray(th.init_h_ffd(wing.H_TH)))
    out.update(J=J, dJ=flat(g))
    return out


def _value_grad(s, th, solve, h_ffd, P_pad=None, data=None, cp=None,
                d0=None):
    import jax

    from goldfish_tpu.parallel.sharding import pad_state
    from goldfish_tpu.physics import kl_shell

    P_pad = s.num_splines if P_pad is None else P_pad
    data = s.data if data is None else data
    cp = s.cp if cp is None else cp
    d0 = s.zero_displacement() if d0 is None else d0

    def J(h_ffd_):
        h = pad_state(th(h_ffd_), P_pad, "repeat")
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(data.stack, d, cp, h, data.E,
                                        data.nu)

    v, g = jax.jit(jax.value_and_grad(J))(h_ffd)
    return float(v), np.asarray(g)


def legs():
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.design.pipeline import ThicknessFFD
    from goldfish_tpu.models import boxwing, wing
    from goldfish_tpu.parallel.sharding import (
        pad_state,
        pad_system,
        padded_patch_count,
    )
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver.implicit import build_solve_fn
    from goldfish_tpu.solver.system_mi import build_solve_fn_mi

    out = {}
    for name, sys_, ffd, h0 in (
            ("wing", wing.build(num_el=2, p=2), ((2, 1, 1), (2, 1, 1)),
             wing.H_TH),
            ("boxwing", boxwing.build(n_sections=18, num_el=1, p=2),
             ((2, 2, 1), (1, 1, 1)), boxwing.H_TH)):
        t0 = time.perf_counter()
        P_pad = padded_patch_count(sys_.num_splines, N_RANKS)
        data = pad_system(sys_.data, P_pad)
        cp = pad_state(sys_.cp, P_pad, "repeat")
        d0 = pad_state(sys_.zero_displacement(), P_pad, "zero")
        th = ThicknessFFD(sys_, num_els=ffd[0], p=ffd[1])
        solve = build_solve_fn(data, rtol=1e-8, max_it=12)
        J, g = _value_grad(sys_, th, solve,
                           jnp.asarray(th.init_h_ffd(h0)), P_pad, data, cp,
                           d0)
        out[name] = {"P": sys_.num_splines, "P_pad": P_pad, "J": J,
                     "dJ": flat(g)}
        print(f"{name}: J={J!r} |g|={np.linalg.norm(g)!r} "
              f"{time.perf_counter() - t0:.1f} s", flush=True)

    from demos.evtol_wing_shopt_mi import build_system

    t0 = time.perf_counter()
    s = build_system(num_el=1, p=2)
    P_pad = padded_patch_count(s.num_splines, N_RANKS)
    data = pad_system(s.data, P_pad)
    h = pad_state(s.h_init, P_pad, "repeat")
    d0 = pad_state(s.zero_displacement(), P_pad, "zero")
    solve_d = build_solve_fn_mi(data, s.mi, s.co, s.ss, s.pdeg, s.qdeg,
                                rtol=1e-10, max_it=12)

    def J(cp_):
        xi = s.c2x.solve(cp_)
        cp_p = pad_state(cp_, P_pad, "repeat")
        d = solve_d(cp_p, h, xi, d0)
        return kl_shell.internal_energy(data.stack, d, cp_p, h, data.E,
                                        data.nu)

    v, g = jax.value_and_grad(J)(s.cp)
    out["mi"] = {"P": s.num_splines, "P_pad": P_pad, "J": float(v),
                 "dJ": flat(g), "dJ_shape": list(np.shape(g))}
    print(f"mi: J={float(v)!r} |g|={np.linalg.norm(np.asarray(g))!r} "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    out = {"wing_small": wing_small()}
    print(f"wing_small: {time.perf_counter() - t0:.1f} s", flush=True)
    out["legs"] = legs()
    out["seconds"] = time.perf_counter() - t0
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh)
    print(f"wrote {OUT} ({out['seconds']:.1f} s)")


if __name__ == "__main__":
    main()
