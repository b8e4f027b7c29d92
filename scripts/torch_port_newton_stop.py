"""Where the port's converged Newton solves stop, and what the finite
differences of the design see of it (ROADMAP C10), on the CPU.

Runs the OpenMDAO MI T-beam of goldfish_tpu_torch/demos/om_tbeam_shopt_mi.py
at its test size (num_el=3, p=2, n_pts=7), `check_partials` as
tests/test_torch_om_mi.py does, then `check_totals` of w_int w.r.t. the
design CPs at central-difference steps of 1e-5, 1e-6 and 1e-7, and prints
each step's relative error. Every Newton solve of the step-1e-6 pass is
followed by one dense exact Newton step from the state it returned (the
full tangent by `system.assemble_K`, `torch.linalg.solve` on the free
dofs), and the script prints how far that step moves w_int: the solve's
stopping error as the objective sees it, with the solve's iterations and
last |r|. `--root` names the tree whose `goldfish_tpu_torch` is imported
(default: this checkout), e.g. a `git archive` of the parent commit
unpacked into a gitignored directory. `--jax` runs the JAX package's demo
instead (CPU, float64, direct mode; the same passes, without the dense
step), for its own errors at the same steps.

    python scripts/torch_port_newton_stop.py [--root DIR]
    JAX_PLATFORMS=cpu python scripts/torch_port_newton_stop.py --jax
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = "int_energy_comp.w_int"
X = "inputs_comp.CPS_design"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--jax", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    if args.jax:
        return main_jax(args.root)
    import torch

    torch.set_num_threads(1)
    from goldfish_tpu_torch.demos.om_tbeam_shopt_mi import build_problem
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver import implicit
    from goldfish_tpu_torch.solver.system import (
        assemble_K,
        potential_and_residual,
    )

    log = []
    inner = implicit._newton_loop

    def newton_loop(d0, data, cp, h, *rest):
        d, it, rn, r_ref = inner(d0, data, cp, h, *rest)
        _, r = potential_and_residual(data, d, cp, h)
        n = d.numel()
        free = data.free.reshape(-1) > 0
        K = assemble_K(data, d, cp, h).reshape(n, n)[free][:, free]
        step = torch.zeros(n, dtype=d.dtype)
        step[free] = torch.linalg.solve(K, -r.reshape(-1)[free])

        def w(dx):
            return float(kl_shell.internal_energy(data.stack, dx, cp, h,
                                                  data.E, data.nu))

        log.append({"its": it, "rn": rn,
                    "dw": w(d + step.reshape(d.shape)) - w(d)})
        return d, it, rn, r_ref

    implicit._newton_loop = newton_loop
    prob = build_problem(num_el=3, p=2, n_pts=7, maxiter=3, device="cpu")[0]
    prob.run_model()
    w0 = float(prob[W][0])
    prob.check_partials(step=1e-7)
    out = {"root": os.path.abspath(args.root), "w_int": w0}
    for step in (1e-6, 1e-5, 1e-7):
        log.clear()
        rep = prob.check_totals(of=[W], wrt=[X], step=step)
        out[f"rel_error_{step:g}"] = float(rep[(W, X)]["rel error"])
        if step == 1e-6:
            dw = np.abs([e["dw"] for e in log])
            out["solves"] = len(log)
            out["dw_max"] = float(dw.max())
            out["dw_max_rel"] = float(dw.max() / abs(w0))
            out["rn_max"] = max(e["rn"] for e in log)
            out["its"] = sorted({e["its"] for e in log})
    print(json.dumps(out))


def main_jax(root):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from demos.om_tbeam_shopt_mi import build_problem
    from goldfish_tpu.solver import linalg

    linalg.set_mode("direct")
    prob = build_problem(num_el=3, p=2, n_pts=7, maxiter=3)[0]
    prob.run_model()
    prob.check_partials(step=1e-7)
    out = {"root": os.path.abspath(root), "package": "goldfish_tpu",
           "w_int": float(prob[W][0])}
    for step in (1e-6, 1e-5, 1e-7):
        rep = prob.check_totals(of=[W], wrt=[X], step=step)
        out[f"rel_error_{step:g}"] = float(rep[(W, X)]["rel error"])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
