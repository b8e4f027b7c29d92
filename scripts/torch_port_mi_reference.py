"""Reference numbers for the PyTorch port's moving-intersection iteration.

Runs the MI T-beam shape iteration of scripts/bench_mi.py at its full size
(NUM_EL=40, P_DEG=3, N_PTS=17: two patches, N = 6072 padded dofs) with the
JAX package on the CPU in float64, direct linear-solver mode: one cold
iteration at amp = 0.05 from d = 0 through `MINonMatchingSystem.
build_forward`, with `jax.value_and_grad` of the internal energy through
both implicit solves (CP -> xi and (cp, h, xi) -> d). Writes J, dJ/damp,
|d|, |xi|, |xi - xi0| to tests/data/torch_port_mi_tbeam40_reference.json.
The machine with the GPU has no JAX, so `chip_smoke.py` checks the port
against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_mi_reference.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_mi_tbeam40_reference.json")
NUM_EL, P_DEG, N_PTS = 40, 3, 17
AMP = 0.05
RTOL = 1e-9


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from goldfish_tpu.models import tbeam
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.physics.coupling import InterfaceSpec
    from goldfish_tpu.solver import linalg
    from goldfish_tpu.solver.system_mi import MINonMatchingSystem

    linalg.set_mode("direct")
    try:
        t0 = time.perf_counter()
        w2 = tbeam.WIDTH / 2
        pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
                [w2, tbeam.LENGTH, 0]]
        pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
                [0, tbeam.LENGTH, -tbeam.DEPTH]]
        srf0 = tbeam.create_surf(pts0, max(NUM_EL // 2, 1), NUM_EL, P_DEG)
        srf1 = tbeam.create_surf(pts1, max((NUM_EL + 1) // 2, 1),
                                 NUM_EL + 1, P_DEG)
        specs = [InterfaceSpec(
            pair=(0, 1),
            xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
            xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
            n_mortar_el=N_PTS - 1)]
        s = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU,
                                tbeam.H_TH, specs=specs, n_pts_list=[N_PTS])
        s.add_side_bc(0, direction=1, side=0, n_layers=1)
        s.add_side_bc(1, direction=1, side=0, n_layers=1)
        s.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])

        m = s.metas[1]
        gv = s.surfs[1].greville_points(1)
        bend = jnp.asarray(np.tile(np.sin(np.pi * gv)[None, :],
                                   (m.n_u, 1)).ravel())
        forward = s.build_forward(rtol=RTOL, max_it=30)
        d0 = s.zero_displacement()

        def J_of(amp):
            cp = s.cp.at[1, : m.n_cp, 0].add(amp * bend)
            d, xi = forward(cp, s.h_init, d0)
            J = kl_shell.internal_energy(s.stack, d, cp, s.h_init, s.E,
                                         s.nu)
            return J, (d, xi)

        (J, (d, xi)), g = jax.value_and_grad(J_of, has_aux=True)(
            jnp.asarray(AMP))
        J, g = float(J), float(g)
        xi = np.asarray(xi)
        xi0 = np.asarray(s.c2x.xi0_flat)
        dn = float(np.linalg.norm(np.asarray(d)))
        seconds = time.perf_counter() - t0
    finally:
        linalg.set_mode(None)

    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    out = {
        "workload": f"scripts/bench_mi.py build() (NUM_EL={NUM_EL}, "
                    f"P_DEG={P_DEG}, N_PTS={N_PTS}); cp = cp0 + amp*bend on "
                    f"the web's x; build_forward(rtol={RTOL}, max_it=30); "
                    f"cold at amp={AMP} from d=0, xi0",
        "solver_mode": "direct",
        "platform": "cpu",
        "dtype": "float64",
        "amp": AMP,
        "J": J,
        "dJ_damp": g,
        "d_norm": dn,
        "xi_norm": float(np.linalg.norm(xi)),
        "xi_shift_norm": float(np.linalg.norm(xi - xi0)),
        "n_dofs": int(np.asarray(s.cp).size),
        "jax_version": jax.__version__,
        "commit": commit,
        "seconds": seconds,
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"J={J!r} dJ/damp={g!r} |d|={dn!r} ({seconds:.1f} s) -> {OUT}")


if __name__ == "__main__":
    main()
