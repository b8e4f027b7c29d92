"""Reference numbers for the PyTorch port's pegasus-91 thickness optimization.

Runs demos/pegasus_thickness_opt.py's problem (`boxwing.build(n_sections=18,
num_el=3, p=3)`: 91 patches, 216 interfaces, N_pad = 11466) with the JAX
package on the CPU in float64 and writes
tests/data/torch_port_pegasus91_reference.json:

- `dense`: the dense route (`implicit.build_solve_fn(rtol=1e-9, max_it=30)`,
  direct linear-solver mode: a jitted Newton on the assembled K with an
  LU solve, and the same K in the adjoint), one cold evaluation at the
  start design from d = 0 for each parametrization: the spanwise thickness
  FFD (`ThicknessFFD((1, 6, 1), (1, 2, 1))`, key `ffd`) and one constant
  thickness per patch (`PatchConstantThickness`, key `const_th`): W_int,
  dW_int/d(design), |d|, and the volume V0;
- `krylov` (with `--krylov`): the demo's own matrix-free route
  (`krylov.build_solve_fn_krylov(rtol=1e-8, cg_rtol=1e-8)`): the cold W_int
  and gradient of the FFD parametrization, then `run_slsqp(maxiter=3)` of
  the demo, with the wall of each part.

The machine with the GPU has no JAX, so `chip_smoke.py` checks the port
against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_pegasus_reference.py
        [--krylov]

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
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_pegasus91_reference.json")
MODEL = dict(n_sections=18, num_el=3, p=3)
FFD = dict(num_els=(1, 6, 1), p=(1, 2, 1))


def _merge(key, part):
    out = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            out = json.load(f)
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        commit = None
    import jax

    out.update(model=f"boxwing.build({MODEL})", platform="cpu",
               dtype="float64", jax_version=jax.__version__, commit=commit)
    out[key] = part
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def _maps(sys_):
    from goldfish_tpu.design.pipeline import (
        PatchConstantThickness,
        ThicknessFFD,
    )
    from goldfish_tpu.models import boxwing

    th = ThicknessFFD(sys_, **FFD)
    pc = PatchConstantThickness(sys_)
    return {"ffd": (th, th.init_h_ffd(boxwing.H_TH)),
            "const_th": (pc, pc.init_h(boxwing.H_TH))}


def _cold(sys_, th, x0, solve):
    """W_int and its gradient at x0 from d = 0."""
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.physics import kl_shell

    cp = sys_.cp

    def it(x, d0):
        h = th(x)
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                        sys_.nu), d

    t0 = time.perf_counter()
    (J, d), g = jax.value_and_grad(it, has_aux=True)(
        jnp.asarray(x0), sys_.zero_displacement())
    J = float(J)
    g = np.asarray(g, dtype=np.float64)
    return dict(J=J, grad=g.tolist(), d_norm=float(np.linalg.norm(
        np.asarray(d))), x0=np.asarray(x0).tolist(),
        seconds=time.perf_counter() - t0)


def dense_part():
    from goldfish_tpu.models import boxwing
    from goldfish_tpu.solver import linalg
    from goldfish_tpu.solver.implicit import build_solve_fn

    t0 = time.perf_counter()
    sys_ = boxwing.build(**MODEL)
    print(f"built in {time.perf_counter() - t0:.1f} s: "
          f"{sys_.num_splines} patches, {len(sys_.specs)} interfaces",
          flush=True)
    linalg.set_mode("direct")
    part = {"route": "implicit.build_solve_fn(rtol=1e-9, max_it=30), "
                     "direct mode", "V0": float(sys_.volume())}
    try:
        for key, (th, x0) in _maps(sys_).items():
            solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
            part[key] = _cold(sys_, th, x0, solve)
            print(f"dense {key}: J={part[key]['J']!r} |g|="
                  f"{np.linalg.norm(part[key]['grad'])!r} "
                  f"({part[key]['seconds']:.1f} s)", flush=True)
    finally:
        linalg.set_mode(None)
    _merge("dense", part)


def krylov_part():
    from demos import pegasus_thickness_opt as demo
    from goldfish_tpu.models import boxwing
    from goldfish_tpu.solver.krylov import build_solve_fn_krylov

    sys_ = boxwing.build(**MODEL)
    th, x0 = _maps(sys_)["ffd"]
    solve = build_solve_fn_krylov(sys_.data, rtol=1e-8, cg_rtol=1e-8)
    part = {"route": "krylov.build_solve_fn_krylov(rtol=1e-8, "
                     "cg_rtol=1e-8)",
            "ffd": _cold(sys_, th, x0, solve)}
    print(f"krylov ffd: J={part['ffd']['J']!r} ({part['ffd']['seconds']:.1f}"
          " s)", flush=True)
    _merge("krylov", part)
    t0 = time.perf_counter()
    res = demo.main(**{"n_sections": MODEL["n_sections"],
                       "num_el": MODEL["num_el"], "p": MODEL["p"]},
                    maxiter=3, verbose=True)[0]
    part["slsqp"] = dict(nit=int(res.nit), J_start=float(res.history[0])
                         if res.history else None, J_end=float(res.fun),
                         x_end=np.asarray(res.x["h_ffd"]).tolist(),
                         seconds=time.perf_counter() - t0)
    _merge("krylov", part)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--krylov", action="store_true",
                    help="the demo's matrix-free route instead of the dense "
                         "one")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    sys.path.insert(0, ROOT)
    if args.krylov:
        krylov_part()
    else:
        dense_part()
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
