"""Which follower pressure the num_el=16 tube optimizations can run at.

For each pressure given, builds the port's two tube demos
(goldfish_tpu_torch/demos/tube_shape_opt.py, fixed seams, from p0;
draft_tube_shopt_mi_wffd.py, moving seams, from p_start) at num_el=16,
p=3 on the card, evaluates the cold objective and runs
`OptProblem.run_slsqp(maxiter=3)`, and prints one JSON line per run: J at
the start and per iteration, nfev/njev, the wall of the run, the number
of factorizations and how many of them found the tangent indefinite
(`cholesky_ex` info > 0). A pressure is usable when the cold solve
converges, no factorization fails and SLSQP ends below the start's J.

    python scripts/torch_port_tube_pressure_sweep.py [--num-el 16]
        [--maxiter 3] [pressure ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(which, num_el, pressure, maxiter, dev):
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as mi_demo
    from goldfish_tpu_torch.demos import tube_shape_opt as fixed_demo

    t0 = time.perf_counter()
    if which == "fixed":
        ns = fixed_demo.setup(num_el=num_el, p=3, device=dev,
                              pressure=pressure)
        name, x0, solve, tol = "p_xy", ns.p0, ns.solve, 1e-14
    else:
        ns = mi_demo.setup(num_el=num_el, p=3, device=dev, pressure=pressure)
        name, x0, solve, tol = "p_ffd", ns.p_start, ns.forward.solve_d, 1e-12
    with torch.no_grad():
        J0, _ = ns.obj({name: torch.tensor(x0, device=dev)},
                       ns.sys.zero_displacement())
    J0 = float(J0)
    cold_its = solve.solver.last_its
    t1 = time.perf_counter()
    res = ns.prob.run_slsqp(maxiter=maxiter, tol=tol)
    torch.cuda.synchronize()
    fac = solve.device_factor
    return dict(path=which, num_el=num_el, pressure=pressure, J0=J0,
                cold_newton_its=cold_its, history=res.history, fun=res.fun,
                nit=res.nit, nfev=res.nfev, njev=res.njev,
                slsqp_s=time.perf_counter() - t1, n_factor=fac.n_factor,
                n_factor_failed=fac.n_factor_failed,
                failed_info=fac.failed_info[:8],
                lowered=bool(res.fun < J0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("pressures", nargs="*", type=float,
                    default=[1000.0, 500.0, 200.0, 100.0, 50.0])
    ap.add_argument("--num-el", type=int, default=16)
    ap.add_argument("--maxiter", type=int, default=3)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda", 0)
    for pr in a.pressures:
        for which in ("fixed", "mi"):
            print(json.dumps(run(which, a.num_el, pr, a.maxiter, dev)),
                  flush=True)


if __name__ == "__main__":
    main()
