"""Where the time of one optimization iteration goes, on the GPU.

Wing (default): the port's first main path (bench.py's workload: 20-patch
wing, 6600 dofs, ThicknessFFD (4,4,1), Newton rtol 1e-9 + adjoint) on one
CUDA card: a cold iteration and two warm 1e-4 steps untimed, then one warm
1e-4 iteration and one 1e-2 refactor iteration under torch.profiler.

--mi: the moving-intersection T-beam iteration of scripts/bench_mi.py
(N = 6072 dofs; CP -> xi solve, MI Newton with the Woodbury seam
correction, adjoint through both implicit solves): a cold iteration at
amp = 0.05 and two warm 1e-3 steps untimed, then one warm 1e-3 step and
one 1e-2 step under torch.profiler.

--tube: one warm SLSQP evaluation of each tube shape optimization
(goldfish_tpu_torch/demos/tube_shape_opt.py and draft_tube_shopt_mi_wffd.py
at the size and pressure of tests/data/torch_port_tube16_reference.json):
the optimizer's fun and jac at the start untimed, then fun (forward only)
and jac (forward + adjoint) at a design moved by 1e-4 relative, each under
torch.profiler.

--plate: one warm SLSQP evaluation of the stress-constrained plate sizing
(goldfish_tpu_torch/demos/plate_var_th_opt_stress.py at num_el=32, N =
7140, through its OpenMDAO graph on the port's om_shim): run_model and the
driver's totals at the start untimed, then fun (run_model) and jac
(linearize + compute_totals of the objective and constraints) at a thickness
design moved by 1e-4 relative, each under torch.profiler.

For each profiled iteration it prints the wall time, the device-busy time
(union of kernel, memcpy and memset intervals), the idle share, and the
top device operations by self time. Chrome traces go to
<trace_dir>/profile_<tag>.json (a fresh temporary directory by default).

    python scripts/profile_torch_iteration.py [trace_dir]
        [--mi | --tube | --plate]
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def device_busy_us(trace_path):
    """Union of device activity intervals in a chrome trace (us)."""
    with open(trace_path) as fh:
        events = json.load(fh)["traceEvents"]
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("cat") in
                ("kernel", "gpu_memcpy", "gpu_memset"))
    busy = 0.0
    end = -1e300
    for a, b in iv:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy, len(iv)


def report(tag, prof, wall, out, extra):
    path = os.path.join(out, f"profile_{tag}.json")
    prof.export_chrome_trace(path)
    busy, n = device_busy_us(path)
    print(f"[{tag}] wall {wall * 1e3:.3f} ms (profiled), device busy "
          f"{busy / 1e3:.3f} ms over {n} device ops, idle share "
          f"{1.0 - busy / (wall * 1e6):.3f}; {extra}", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=22), flush=True)


def main_mi(out):
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import make_mi_iteration
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart

    dev = torch.device("cuda", 0)
    sys_ = tbeam.build_mi(num_el=40, p=3, n_pts=17, device=dev)
    run, forward = make_mi_iteration(sys_, dev)
    fac = forward.solve_d.device_factor
    ws_d, ws_xi = SecantWarmStart(), SecantWarmStart()
    d, xi = sys_.zero_displacement(), None

    def step(amp):
        nonlocal d, xi
        a = torch.tensor(amp, dtype=torch.float64)
        seed = None if xi is None else ws_xi.predict(a, xi).clamp(0.0, 1.0)
        _, _, d, xi, dt = run(amp, ws_d.predict(a, d), seed)
        ws_d.update(a, d)
        ws_xi.update(a, xi)
        return dt

    for k in (0, 1, 2):
        step(0.05 * (1.0 + 1e-3 * k))
    for tag, amp in (("mi_warm", 0.05 * 1.003), ("mi_step1e-2",
                                                   0.05 * 1.013)):
        nf = fac.n_factor
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = step(amp)
        report(tag, prof, wall, out,
               f"newton its {forward.solve_d.solver.last_its}, xi-newton "
               f"its {sys_.c2x.last_its}, factorizations "
               f"{fac.n_factor - nf}")


def main_tube(out):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as mi_demo
    from goldfish_tpu_torch.demos import tube_shape_opt as fixed_demo

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_port_tube16_reference.json")) as fh:
        ref = json.load(fh)
    dev = torch.device("cuda", 0)
    kw = dict(num_el=ref["num_el"], p=ref["p"], device=dev,
              pressure=ref["pressure"])
    for tag, demo in (("tube", fixed_demo), ("tube_mi", mi_demo)):
        ns = demo.setup(**kw)
        fun, jac, _ = ns.prob._build_callables()
        x0 = ns.prob._x0()
        fun(x0)
        jac(x0)
        x1 = x0 * (1.0 + 1e-4 * np.random.default_rng(0).normal(
            size=x0.size))
        solve = ns.solve if tag == "tube" else ns.forward.solve_d
        for what, fn in (("fun", fun), ("jac", jac)):
            nf = solve.device_factor.n_factor
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(x1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            report(f"{tag}_{what}", prof, wall, out,
                   f"newton its {solve.solver.last_its}, factorizations "
                   f"{solve.device_factor.n_factor - nf}")


def main_plate(out):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    dev = torch.device("cuda", 0)
    prob, sys_, th, _, _ = demo.build_problem(num_el=32, device=dev)
    model = prob.model
    of = [model._objective[0]] + list(model._constraints)
    fac = model._subs["disp_states_comp"].op.factor

    def fun():
        prob.run_model()

    def jac():
        prob.compute_totals(of, [demo.FFD], jacs=prob._linearize_all())

    fun()
    jac()
    x0 = np.asarray(prob[demo.FFD]).copy()
    prob[demo.FFD] = x0 * (1.0 + 1e-4 * np.random.default_rng(0).normal(
        size=x0.size))
    for what, fn in (("fun", fun), ("jac", jac)):
        nf = fac.n_factor
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"plate_{what}", prof, wall, out,
               f"factorizations {fac.n_factor - nf}")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile needs one GPU")
    from torch.profiler import ProfilerActivity, profile

    args = [a for a in sys.argv[1:] if a not in ("--mi", "--tube",
                                                   "--plate")]
    out = args[0] if args else tempfile.mkdtemp()
    os.makedirs(out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--mi" in sys.argv[1:]:
        return main_mi(out)
    if "--tube" in sys.argv[1:]:
        return main_tube(out)
    if "--plate" in sys.argv[1:]:
        return main_plate(out)

    from chip_smoke import make_iteration
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    dev = torch.device("cuda", 0)
    sys_ = wing.build(num_el=6, p=3, device=dev)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    run = make_iteration(sys_, th, solve)
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64,
                      device=dev)
    ws = SecantWarmStart()
    _, d, _, _ = run(h0, sys_.zero_displacement())
    ws.update(h0, d)
    for k in (1, 2):
        hk = h0 * (1.0 + 1e-4 * k)
        _, d, _, _ = run(hk, ws.predict(hk, d))
        ws.update(hk, d)

    for tag, hk in (("warm", h0 * (1.0 + 3e-4)), ("refactor", h0 * 1.01)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            _, d_new, _, _ = run(hk, ws.predict(hk, d))
            wall = time.perf_counter() - t0
        if tag == "warm":
            d = d_new
            ws.update(hk, d)
        report(tag, prof, wall, out,
               f"newton its {solve.solver.last_its}, n_factor "
               f"{solve.device_factor.n_factor}")


if __name__ == "__main__":
    main()
