"""Reference numbers for the PyTorch port's wing20 iteration (JAX, CPU, f64).

Runs bench.py's governing workload with the JAX package on the CPU in
float64, on the persistent-device-factor path ("mixed" linear-solver
mode), and writes J(h0), dJ/dh_ffd and |d| of one cold evaluation to
tests/data/torch_port_wing20_reference.json. The machine with the GPU
has no JAX, so `chip_smoke.py` checks the port against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_reference.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_wing20_reference.json")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from goldfish_tpu.design.pipeline import ThicknessFFD
    from goldfish_tpu.models import wing
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver import linalg
    from goldfish_tpu.solver.implicit import build_solve_fn

    linalg.set_mode("mixed")
    try:
        t0 = time.perf_counter()
        sys_ = wing.build(num_el=6, p=3)
        th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
        solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
        cp = sys_.cp

        def opt_iteration(h_ffd, d0):
            h = th(h_ffd)
            d = solve(cp, h, d0)
            J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                         sys_.nu)
            return J, d

        vg = jax.value_and_grad(opt_iteration, has_aux=True)
        h0 = jnp.asarray(th.init_h_ffd(wing.H_TH))
        (J, d), g = vg(h0, sys_.zero_displacement())
        J = float(J)
        g = np.asarray(g, dtype=np.float64)
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
        "workload": "wing.build(num_el=6, p=3); ThicknessFFD((4,4,1),(2,2,1)); "
                    "build_solve_fn(rtol=1e-9, max_it=30); cold at h0",
        "solver_mode": "mixed",
        "platform": "cpu",
        "dtype": "float64",
        "J": J,
        "dJ_dh_ffd": g.tolist(),
        "d_norm": dn,
        "n_dofs": int(np.asarray(sys_.cp).size),
        "jax_version": jax.__version__,
        "commit": commit,
        "seconds": seconds,
    }
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"J={J!r} |d|={dn!r} |g|={np.linalg.norm(g)!r} "
          f"({seconds:.1f} s) -> {OUT}")


if __name__ == "__main__":
    main()
