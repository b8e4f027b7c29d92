"""How often the plate's SLSQP runs to its iteration limit, on the GPU.

ROADMAP Queue C2: the stress-constrained plate sizing
(goldfish_tpu_torch/demos/plate_var_th_opt_stress.py at num_el=32, the size
of chip_smoke.py's phase 11) stops after 11 SLSQP iterations in some runs
and runs to its 30-iteration limit in others, the runs differing only in
the rounding order of the f64-atomic kernels. This script repeats the
demo's SLSQP `--runs` times in one process (a fresh problem each time) and
prints each run's iterations, evaluations, end volume, wall and the median
host walls of its fun and jac evaluations (as chip_smoke.py phase 11 prints
them), so that two trees can be compared in one chip call: `--root` names
the tree whose `goldfish_tpu_torch` is imported (default: this checkout),
e.g. a `git archive` of the parent commit unpacked into a gitignored
directory.

    python scripts/torch_port_plate_slsqp_repeat.py [--runs 4] [--root DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    dev = torch.device("cuda", 0)
    rows = []
    for k in range(args.runs):
        prob, *_ = demo.build_problem(num_el=32, maxiter=30, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = demo.run(prob)
        torch.cuda.synchronize()
        res = out.result
        rows.append({"run": k, "nit": int(res.nit), "nfev": int(res.nfev),
                     "njev": int(res.njev), "volume_end": float(out.V1),
                     "seconds": time.perf_counter() - t0,
                     "fun_median": float(np.median(out.log.fun_wall)),
                     "jac_median": float(np.median(out.log.jac_wall))})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "nit": [r["nit"] for r in rows]}))


if __name__ == "__main__":
    main()
