"""The wing20 cold iteration and the plate's SLSQP walls, on the GPU, with
the solver libraries' modules loaded before anything is timed.

CUDA loads a library's kernel modules lazily, on the host, at their first
launch: a process's first cold solve pays for that, and a single run of
chip_smoke.py cannot tell it apart from the solve. This script
runs one tree's `goldfish_tpu_torch` (`--root`, default this checkout):

1. the 20-patch wing of chip_smoke.py phase 4 (wing.build(num_el=6, p=3),
   ThicknessFFD (4, 4, 1), rtol 1e-9): one untimed cold iteration loads
   the modules, then `--cold` timed cold iterations, each with a fresh
   solve (a new factor, d0 = 0), timed as phase 4 times its first
   (host clock between two synchronizes, adjoint gradient included);
   `--cold 0` skips the wing;
2. the stress-constrained plate of phase 11 (num_el=32): one untimed
   2-iteration SLSQP loads the modules, then `--plate-runs` SLSQP runs,
   each printing its iterations, its wall, and the median and total host
   walls of its fun and jac evaluations as phase 11 takes them (no
   synchronize between a fun and the next jac, so device work can fall
   in either);
3. the moving-seam tube of phase 9 (draft_tube_shopt_mi_wffd at the size
   and pressure of tests/data/torch_port_tube16_reference.json): one
   untimed `run_slsqp(maxiter=3)`, then `--tube-mi-runs` timed ones, each
   from a fresh setup, with the median and total host walls of its fun
   and jac evaluations as phase 9 prints them (`--tube-mi-runs 0`, the
   default, skips it).

To compare two trees, unpack the parent with `git archive <commit> | tar
-x -C scratch_chip/parent` and run the two alternately in one chip call.

    python scripts/torch_port_wall_ab.py [--root DIR] [--cold 3]
        [--plate-runs 1] [--tube-mi-runs 0]

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py (its timed iteration), whatever tree
    `--root` imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--cold", type=int, default=3)
    ap.add_argument("--plate-runs", type=int, default=1)
    ap.add_argument("--tube-mi-runs", type=int, default=0)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs one GPU")
    sm = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    if not os.path.abspath(_cuda.__file__).startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    _cuda.library()
    dev = torch.device("cuda", 0)
    cold = []
    if args.cold:
        cold = wing_cold(sm, args.cold, dev)
    plate = []
    for k in range(args.plate_runs + 1):
        prob, *_ = demo.build_problem(num_el=32, maxiter=30 if k else 2,
                                      device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = demo.run(prob)
        torch.cuda.synchronize()
        row = {"nit": int(out.result.nit),
               "seconds": time.perf_counter() - t0,
               "fun_median": float(np.median(out.log.fun_wall)),
               "jac_median": float(np.median(out.log.jac_wall)),
               "fun_total": float(np.sum(out.log.fun_wall)),
               "jac_total": float(np.sum(out.log.jac_wall))}
        if k:
            plate.append(row)
        print(f"[plate] run {k}{'' if k else ' (untimed)'} {json.dumps(row)}",
              flush=True)
        del prob, out
        torch.cuda.empty_cache()
    tube_mi = tube_mi_walls(args.tube_mi_runs, dev) if args.tube_mi_runs \
        else []
    print(json.dumps({"root": root, "wing20_cold": cold, "plate": plate,
                      "tube_mi": tube_mi}))


def tube_mi_walls(n, dev):
    """`n` timed moving-seam tube SLSQP runs (maxiter 3) after an untimed
    one: iterations, wall, fun and jac medians and totals (s)."""
    import numpy as np
    import torch
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as demo

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_port_tube16_reference.json")) as fh:
        ref = json.load(fh)
    rows = []
    for k in range(n + 1):
        ns = demo.setup(num_el=ref["num_el"], p=ref["p"], device=dev,
                        pressure=ref["pressure"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ns.prob.run_slsqp(maxiter=3, tol=1e-12)
        torch.cuda.synchronize()
        wf, wj = ns.prob.eval_wall["fun"], ns.prob.eval_wall["jac"]
        row = {"nit": int(res.nit), "seconds": time.perf_counter() - t0,
               "fun_median": float(np.median(wf)),
               "jac_median": float(np.median(wj)),
               "fun_total": float(np.sum(wf)), "jac_total": float(np.sum(wj))}
        if k:
            rows.append(row)
        print(f"[tube-mi] run {k}{'' if k else ' (untimed)'} "
              f"{json.dumps(row)}", flush=True)
        del ns, res
        torch.cuda.empty_cache()
    return rows


def wing_cold(sm, n, dev):
    """`n` timed cold wing20 iterations after an untimed one (s)."""
    import torch
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    sys_ = wing.build(num_el=6, p=3, device=dev)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64,
                      device=dev)
    cold = []
    for k in range(n + 1):
        solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
        run = sm.make_iteration(sys_, th, solve)
        J, d, g, dt = run(h0, sys_.zero_displacement())
        if k:
            cold.append(dt)
        print(f"[wing20] cold iteration {k}{'' if k else ' (untimed)'} "
              f"{dt:.4f} s J={float(J)!r}", flush=True)
        del solve, run, J, d, g
        torch.cuda.empty_cache()
    del sys_, th, h0
    torch.cuda.empty_cache()
    return cold


if __name__ == "__main__":
    main()
