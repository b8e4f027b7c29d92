"""Where the 4-patch moving-seam tube's SLSQP runs of the port and of the
JAX package part (ROADMAP C11), on the CPU.

Runs the OpenMDAO graph of demos/tube_shopt_mi_4patch_wffd.py (the port's,
or with `--jax` the JAX package's in float64 direct mode) at num_el=2,
p=3, maxiter 3 and the given follower pressure, and records every model
evaluation the driver makes (J, the design, |d|) into `--out` (JSON).
`--compare A B` prints, evaluation by evaluation, both runs' J, |d| and
the largest design difference. `--cold FILE K` evaluates a fresh graph
cold (d = 0) at evaluation K's design of FILE and prints its J and |d|.

    python scripts/torch_port_tube_om_mi_parting.py --pressure 5e2 --out P.json
    JAX_PLATFORMS=cpu python scripts/torch_port_tube_om_mi_parting.py --jax \\
        --pressure 5e2 --out J.json
    python scripts/torch_port_tube_om_mi_parting.py --compare P.json J.json
    python scripts/torch_port_tube_om_mi_parting.py [--jax] --pressure 5e2 \\
        --cold J.json 6
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J = "internal_energy_comp.int_E"
X = ("inputs_comp.CP_design_FFD0", "inputs_comp.CP_design_FFD1")
D = "disp_states_comp.displacements"


def problem(jax_pkg, pressure):
    sys.path.insert(0, ROOT)
    if not jax_pkg:
        import torch

        torch.set_num_threads(1)
        from goldfish_tpu_torch.demos.tube_shopt_mi_4patch_wffd import (
            build_problem,
        )

        return build_problem(num_el=2, p=3, maxiter=3, pressure=pressure,
                             device="cpu")[0]
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from goldfish_tpu.solver import linalg

    linalg.set_mode("direct")
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_port_om_mi_5b_reference import _tube_problem

    return _tube_problem(2, 3, pressure, 3)


def state(prob):
    return {"J": float(np.asarray(prob[J]).ravel()[0]),
            "x": np.concatenate([np.asarray(prob[x]).ravel()
                                 for x in X]).tolist(),
            "d_norm": float(np.linalg.norm(np.asarray(prob[D])))}


def record(prob, out):
    evals = []
    run_model = prob.run_model

    def traced():
        run_model()
        evals.append(state(prob))

    prob.run_model = traced
    prob.run_model()
    prob.run_driver()
    res = prob._driver_result
    with open(out, "w") as fh:
        json.dump({"evals": evals, "nit": int(res.nit),
                   "nfev": int(res.nfev)}, fh)
    for k, e in enumerate(evals):
        print(f"{k} J {e['J']!r} |d| {e['d_norm']!r}")


def compare(a, b):
    with open(a) as fh:
        ea = json.load(fh)["evals"]
    with open(b) as fh:
        eb = json.load(fh)["evals"]
    for k, (p, q) in enumerate(zip(ea, eb)):
        dx = float(np.abs(np.asarray(p["x"]) - np.asarray(q["x"])).max())
        print(f"{k} J {p['J']!r} | {q['J']!r}; |d| {p['d_norm']!r} | "
              f"{q['d_norm']!r}; max |x_a - x_b| {dx:.3e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--pressure", type=float, default=5e2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--cold", nargs=2, default=None)
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    prob = problem(args.jax, args.pressure)
    if args.cold:
        with open(args.cold[0]) as fh:
            x = np.asarray(json.load(fh)["evals"][int(args.cold[1])]["x"])
        n = x.size // 2
        prob[X[0]], prob[X[1]] = x[:n], x[n:]
        prob.run_model()
        print(json.dumps(state(prob) | {"x": None}))
        return
    record(prob, args.out)


if __name__ == "__main__":
    main()
