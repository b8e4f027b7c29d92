"""Warm-iteration walls of the port's wing20 main path on the GPU.

Runs bench.py's workload (20-patch wing, 6600 dofs, ThicknessFFD (4,4,1),
Newton rtol 1e-9 + adjoint) with the `goldfish_tpu_torch` and
`chip_smoke.py` of the directory it is started from: one cold iteration,
then `n` warm 1e-4 steps with the secant warm start. Prints the card and
one JSON line with every warm wall and their median. Started from the
roots of two checkouts in turns (parent, change, change, parent) within
one call, it compares two versions on one card.

    python <path>/torch_port_warm_wing.py [n]      # from a checkout's root
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this measurement needs one GPU")
    sys.path.insert(0, os.getcwd())
    from chip_smoke import make_iteration
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    sys_ = wing.build(num_el=6, p=3, device=dev)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    run = make_iteration(sys_, th, solve)
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64,
                      device=dev)
    _, d, _, t_cold = run(h0, sys_.zero_displacement())
    ws = SecantWarmStart()
    ws.update(h0, d)
    walls = []
    for k in range(1, n + 1):
        hk = h0 * (1.0 + 1e-4 * k)
        _, d, _, dt = run(hk, ws.predict(hk, d))
        ws.update(hk, d)
        walls.append(dt)
    print(card)
    print(json.dumps({"tree": os.getcwd(), "cold_s": t_cold,
                      "warm_median_s": float(np.median(walls)),
                      "warm_s": walls,
                      "n_factor": solve.device_factor.n_factor}))


if __name__ == "__main__":
    main()
