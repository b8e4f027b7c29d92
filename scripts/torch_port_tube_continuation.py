"""Do the tubes reach an equilibrium at the demos' follower pressure?

At 2e4 Pa the num_el=16 tubes have no equilibrium that a Newton solve from
d = 0 reaches (scripts/torch_port_tube_reference.py). This script loads
them in steps instead, on the card: for the fixed-seam tube of
goldfish_tpu_torch/demos/tube_shape_opt.py and the moving-seam tube of
draft_tube_shopt_mi_wffd.py (at its initial seams, as a fixed-seam
SystemData through `system_mi.data_at`), both at their initial geometry,
it runs `continuation_solve` (rtol 1e-9, max_it 40) with each level
count given, on one persistent factor of each kind given (Cholesky, and
LU, which an indefinite tangent does not stop), and prints one JSON line
per run: Newton iterations and |r| / |r(0)| of each level, whether the
last level converged (|r| / |r(0)| < 1e-8), the factorizations and how
many failed (`cholesky_ex` info > 0: the tangent is indefinite), and the
wall. Where the finest LU continuation does not converge, `riks_solve`
(lam_target 1, dlam0 = 1 / levels) traces the path from d = 0 and reports
where it ends.

    python scripts/torch_port_tube_continuation.py [--num-el 16]
        [--pressure 2e4] [--levels 4 8 16] [--kinds cholesky lu]
        [--riks-steps 60]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def tube_data(which, num_el, pressure, dev):
    """(SystemData, cp, h) of one tube at its initial geometry."""
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as mi_demo
    from goldfish_tpu_torch.demos import tube_shape_opt as fixed_demo
    from goldfish_tpu_torch.solver import system_mi

    if which == "fixed":
        s = fixed_demo.build(num_el, 3, pressure, device=dev)
        return s.data, s.cp, s.h_init
    s = mi_demo.build_mi_tube(num_el=num_el, p=3, pressure=pressure,
                              device=dev)
    data = system_mi.data_at(s.data, s.mi, s.co, s.ss, s.pdeg, s.qdeg,
                             s.c2x.xi0_flat)
    return data, s.cp, s.h_init


def run(which, num_el, pressure, levels, kind, riks_steps, dev):
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.implicit import continuation_solve
    from goldfish_tpu_torch.solver.riks import riks_solve
    from goldfish_tpu_torch.solver.system import residual

    data, cp, h = tube_data(which, num_el, pressure, dev)
    d0 = torch.zeros_like(cp)
    r0 = float(torch.linalg.norm(residual(data, d0, cp, h)))
    fac = PersistentDeviceFactor(data, kind=kind)
    log = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    d, _, rn = continuation_solve(data, cp, h, d0, n_steps=levels, rtol=1e-9,
                                  max_it=40, fac=fac, log=log)
    torch.cuda.synchronize()
    out = dict(path=which, num_el=num_el, pressure=pressure, levels=levels,
               factor=kind, N=int(data.free.numel()),
               its=[int(i) for i, _ in log],
               rel_r=[float(r) / (r0 * (k + 1) / levels)
                      for k, (_, r) in enumerate(log)],
               converged=bool(float(rn) / r0 < 1e-8),
               n_factor=fac.n_factor, n_factor_failed=fac.n_factor_failed,
               failed_info=fac.failed_info[:8],
               seconds=time.perf_counter() - t0,
               finite=bool(torch.isfinite(d).all()))
    if not out["converged"] and riks_steps:
        stats = {}
        t0 = time.perf_counter()
        _, lam, path = riks_solve(data, cp, h, d0, lam_target=1.0,
                                  dlam0=1.0 / levels, rtol=1e-8,
                                  max_steps=riks_steps, stats=stats)
        torch.cuda.synchronize()
        lams = [p[0] for p in path]
        out["riks"] = dict(lam_end=lam, lam_max=max(lams),
                           points=len(path), steps=stats.get("steps"),
                           n_lu=stats["n_lu"],
                           seconds=time.perf_counter() - t0)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=16)
    ap.add_argument("--pressure", type=float, default=2.0e4)
    ap.add_argument("--levels", type=int, nargs="*", default=[4, 8, 16])
    ap.add_argument("--kinds", nargs="*", default=["cholesky", "lu"])
    ap.add_argument("--riks-steps", type=int, default=60)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for which in ("fixed", "mi"):
        for kind in a.kinds:
            for n in a.levels:
                # Riks once per tube, after the finest LU continuation
                riks = a.riks_steps if (n == max(a.levels)
                                        and kind == a.kinds[-1]) else 0
                print(json.dumps(run(which, a.num_el, a.pressure, n, kind,
                                     riks, dev)), flush=True)


if __name__ == "__main__":
    main()
