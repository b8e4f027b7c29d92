"""Reference numbers for the PyTorch port's VLM-coupled aeroelastic wing and
Scordelis-Lo roof (JAX, CPU, f64).

Runs demos/vlm_aeroelastic_wing.py's coupled problem (`build_coupled`: the
wing at load_scale 0, a vortex lattice on its deformed midsurface, n_fp
unrolled fixed-point passes of VLM -> force field -> `build_field_solve_fn`)
with the JAX package on the CPU in float64 on the persistent-device-factor
path ("mixed" linear-solver mode), at three sizes:

- `test`: the size of tests/test_vlm.py's coupled test (2 x 3 patches,
  num_el=2, p=2, 5 x 8 panels, 3 passes);
- `demo`: the demo's defaults (2 x 3 patches, num_el=3, p=3, 6 x 10 panels,
  4 passes);
- `wing20`: the benchmark wing at full width (4 x 5 patches, num_el=6, p=3,
  N = 6600) under a 16 x 64 lattice (1024 panels), 4 passes;

and for each writes W_int, the lift, the tip displacement, dW_int/dh (the
full (P, C) vector), |d| and the demo's central-difference check (h0 +- 1e-6
v, v seeded as in the demo), with the wall of each part; then the
Scordelis-Lo roof's QoI at num_el=6 (`models/slr.solve_qoi`). The machine
with the GPU has no JAX, so `chip_smoke.py` and the port's CPU tests check
the port against tests/data/torch_port_vlm_reference.json.

    JAX_PLATFORMS=cpu python scripts/torch_port_vlm_reference.py
        [--only test demo wing20 slr]

Each part is merged into the existing file as it ends.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_vlm_reference.json")

SIZES = {
    "test": dict(n_chord=2, n_span=3, num_el=2, p=2, mc=5, ns=8, n_fp=3),
    "demo": dict(n_chord=2, n_span=3, num_el=3, p=3, mc=6, ns=10, n_fp=4),
    "wing20": dict(n_chord=4, n_span=5, num_el=6, p=3, mc=16, ns=64,
                   n_fp=4),
}
FD_EPS = 1e-6


def coupled_case(kw):
    import jax
    import jax.numpy as jnp

    from demos.vlm_aeroelastic_wing import build_coupled

    t0 = time.perf_counter()
    J_of_h, sys_, h0 = build_coupled(**kw)
    d0 = sys_.zero_displacement()
    (J, (d, lift)), gh = jax.value_and_grad(J_of_h, has_aux=True)(h0, d0)
    t_grad = time.perf_counter() - t0
    tip = sys_.evaluate_displacement(d, sys_.num_splines - 1, [0.5, 1.0])
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=np.asarray(h0).shape)
                    * np.asarray(sys_.stack.cp_mask))
    t0 = time.perf_counter()
    Jp, _ = J_of_h(h0 + FD_EPS * v, d0)
    Jm, _ = J_of_h(h0 - FD_EPS * v, d0)
    t_fd = time.perf_counter() - t0
    fd = float((Jp - Jm) / (2 * FD_EPS))
    ad = float(jnp.sum(gh * v))
    fd_direct = None
    if abs(ad - fd) > 1e-5 * abs(fd):
        # the mixed mode's FD misses at the test size (ROADMAP Queue C):
        # repeat the two evaluations in direct mode (jitted Newton, LU)
        from goldfish_tpu.solver import linalg

        linalg.set_mode(None)
        try:
            J_d, _, _ = build_coupled(**kw)
            Jp, _ = J_d(h0 + FD_EPS * v, d0)
            Jm, _ = J_d(h0 - FD_EPS * v, d0)
        finally:
            linalg.set_mode("mixed")
        fdd = float((Jp - Jm) / (2 * FD_EPS))
        fd_direct = {"fd": fdd, "rel": abs(ad - fdd) / max(abs(fdd), 1e-300)}
    out = {
        "size": kw,
        "J": float(J),
        "lift": float(lift),
        "tip": np.asarray(tip, dtype=np.float64).tolist(),
        "dW_dh": np.asarray(gh, dtype=np.float64).tolist(),
        "d_norm": float(np.linalg.norm(np.asarray(d))),
        "fd": {"eps": FD_EPS, "ad": ad, "fd": fd,
               "rel": abs(ad - fd) / max(abs(fd), 1e-300),
               "direct": fd_direct},
        "n_dofs": int(np.asarray(sys_.cp).size),
        "seconds_value_and_grad": t_grad,
        "seconds_fd": t_fd,
    }
    print(f"{kw}: J={out['J']!r} lift={out['lift']!r} tip_z={out['tip'][2]!r}"
          f" |g|={np.linalg.norm(np.asarray(gh))!r} fd rel "
          f"{out['fd']['rel']:.2e} ({t_grad:.1f} + {t_fd:.1f} s)", flush=True)
    return out


def slr_case(num_el=6):
    from goldfish_tpu.models import slr

    t0 = time.perf_counter()
    qoi, d, _ = slr.solve_qoi(num_el=num_el, load_scale=1e-3)
    out = {"num_el": num_el, "load_scale": 1e-3, "qoi": float(qoi),
           "qoi_ref": slr.QOI_REF,
           "d_norm": float(np.linalg.norm(np.asarray(d))),
           "seconds": time.perf_counter() - t0}
    print(f"slr num_el={num_el}: qoi={qoi!r} ({out['seconds']:.1f} s)",
          flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*",
                    default=["test", "demo", "wing20", "slr"])
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    from goldfish_tpu.solver import linalg

    out = {}
    if os.path.exists(OUT):
        with open(OUT) as fh:
            out = json.load(fh)
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    out.update(solver_mode="mixed", platform="cpu", dtype="float64",
               jax_version=jax.__version__, commit=commit,
               workload="demos/vlm_aeroelastic_wing.build_coupled(alpha=0.06,"
                        " q_dyn=40, rtol=1e-9): value_and_grad of W_int "
                        "in h at h0 from d = 0, then J(h0 +- eps v)")
    linalg.set_mode("mixed")
    try:
        for name in args.only:
            t0 = time.perf_counter()
            out[name] = (slr_case() if name == "slr"
                         else coupled_case(SIZES[name]))
            out[name]["seconds_total"] = time.perf_counter() - t0
            os.makedirs(os.path.dirname(OUT), exist_ok=True)
            with open(OUT, "w") as fh:
                json.dump(out, fh, indent=1)
                fh.write("\n")
    finally:
        linalg.set_mode(None)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
