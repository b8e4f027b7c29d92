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

--om-mi: one warm SLSQP evaluation of the moving-intersection T-beam
shape optimization through its OpenMDAO graph
(goldfish_tpu_torch/demos/om_tbeam_shopt_mi.py at num_el=40, p=3,
n_pts=17: N = 6072, 18 design CPs; CPIGA2XiComp -> DispMintStatesComp ->
IntEnergyComp on the port's om_shim): run_model and the driver's totals
(w_int, the pin and the 17 xi-edge rows) at the start untimed, then fun
(run_model) and jac (linearize + compute_totals) at a design moved by
1e-4 relative, each under torch.profiler.

--evtol-mi: one warm SLSQP evaluation of the eVTOL wing with moving
spar and rib seams through its OpenMDAO graph
(goldfish_tpu_torch/demos/evtol_wing_shopt_mi.py at its own size, num_el=4,
p=3, variant rspar_rrib: 3 design dofs, four seams of 11 points): run_model
and the driver's totals (w_int) at the start untimed, then fun (run_model)
and jac (linearize + compute_totals) at a design moved by 1e-4 relative,
each under torch.profiler.

--pegasus: the pegasus-91 box-wing thickness optimization
(goldfish_tpu_torch/demos/pegasus_thickness_opt.py at full size: 91
patches, N = 11466): on its Newton-Krylov route (GMRES-IR forward and
adjoint on the dense-LU preconditioner) the optimizer's fun and jac at the
start untimed, then fun and jac at a design moved by 1e-4 relative; on the
dense route (persistent Cholesky factor) a cold evaluation and one warm 1e-4
step untimed, then one warm 1e-4 step; each under torch.profiler.

--vlm: the VLM-coupled aeroelastic wing at full width
(goldfish_tpu_torch/demos/vlm_aeroelastic_wing.py's build_coupled on the
20-patch wing, N = 6600, under a 16 x 64 vortex lattice, 4 fixed-point
passes): after an untimed evaluation at the demo's size (it loads the
CUDA modules), one cold coupled evaluation with its gradient from d = 0
(the factor is built inside it), then a warm one at
h0 + 1e-4 v from the cold d untimed, then one at h0 + 2e-4 v; each of the
two profiled under torch.profiler.

--press: the two-plate contact press at num_el=32 (chip_smoke.py phase 21:
N = 6936, contact through kernel K12): after an untimed run of the whole
path at num_el=6 (it loads the CUDA modules), the cold continuation (4
levels from d = 0, one persistent Cholesky factor), then, with
`build_solve_fn` warm at the equilibrium, an untimed value and adjoint
gradient of W_int at h0, then one at h0 + 1e-4 v; the continuation and
the last evaluation each under torch.profiler.

For each profiled iteration it prints the wall time, the device-busy time
(union of kernel, memcpy and memset intervals), the idle share, and the
top device operations by self time. Chrome traces go to
<trace_dir>/profile_<tag>.json (a fresh temporary directory by default).

    python scripts/profile_torch_iteration.py [trace_dir]
        [--mi | --tube | --plate | --om-mi | --evtol-mi | --pegasus | --vlm
         | --press]
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


def profile_om_graph(out, tag, prob, design):
    """An OpenMDAO graph's SLSQP fun (run_model) and jac (linearize +
    compute_totals of the objective and constraints w.r.t. `design`): both
    at the start untimed, then both at a design moved by 1e-4 relative,
    each under torch.profiler."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    model = prob.model
    of = [model._objective[0]] + list(model._constraints)
    fac = model._subs["disp_states_comp"].op.factor

    def fun():
        prob.run_model()

    def jac():
        prob.compute_totals(of, [design], jacs=prob._linearize_all())

    fun()
    jac()
    x0 = np.asarray(prob[design]).copy()
    prob[design] = x0 * (1.0 + 1e-4 * np.random.default_rng(0).normal(
        size=x0.size))
    for what, fn in (("fun", fun), ("jac", jac)):
        nf = fac.n_factor
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        report(f"{tag}_{what}", prof, wall, out,
               f"factorizations {fac.n_factor - nf}")


def main_plate(out):
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    prob = demo.build_problem(num_el=32, device=torch.device("cuda", 0))[0]
    profile_om_graph(out, "plate", prob, demo.FFD)


def main_om_mi(out):
    from goldfish_tpu_torch.demos import om_tbeam_shopt_mi as demo

    prob = demo.build_problem(num_el=40, p=3, n_pts=17,
                              device=torch.device("cuda", 0))[0]
    profile_om_graph(out, "om_mi", prob, "inputs_comp.CPS_design")


def main_evtol_mi(out):
    from goldfish_tpu_torch.demos import evtol_wing_shopt_mi as demo

    prob = demo.build_problem(num_el=4, p=3, variant="rspar_rrib",
                              device=torch.device("cuda", 0))[0]
    profile_om_graph(out, "evtol_mi", prob, "inputs_comp.spar_rib_design")


def main_pegasus(out):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from goldfish_tpu_torch.demos import pegasus_thickness_opt as demo

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    for route in ("krylov", "dense"):
        ns = demo.setup(route=route, device=dev)
        fun, jac, _ = ns.prob._build_callables()
        x0 = ns.prob._x0()
        fun(x0)
        jac(x0)
        x1 = x0 * (1.0 + 1e-4 * rng.normal(size=x0.size))
        if route == "dense":
            jac(x1)
            x1 = x1 * (1.0 + 1e-4 * rng.normal(size=x0.size))
        for what, fn in ((("fun", fun), ("jac", jac)) if route == "krylov"
                         else (("jac", jac),)):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn(x1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            sv = ns.solve.solver
            extra = f"newton its {sv.last_its}"
            if route == "krylov":
                extra += (f", (it, |r|, alpha, GMRES cycles) {sv.last_log}, "
                          f"adjoint cycles {sv.adjoint_cycles[-1:]}")
            else:
                extra += f", n_factor {ns.solve.device_factor.n_factor}"
            report(f"pegasus_{route}_{what}", prof, wall, out, extra)
        del ns, fun, jac
        torch.cuda.empty_cache()


def main_vlm(out):
    from torch.profiler import ProfilerActivity, profile

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import vlm_aeroelastic_wing as demo

    dev = torch.device("cuda", 0)
    # load the kernels and the libraries' modules (CUDA loads them lazily,
    # at first use) with an untimed evaluation at the demo's size, so that
    # the cold profile shows the evaluation and not the loading
    _cuda.library()
    J_small, s_small, h_small = demo.build_coupled(device=dev)
    demo.coupled_gradient(J_small, h_small, s_small.zero_displacement())
    del J_small, s_small, h_small
    J_of_h, sys_, h0 = demo.build_coupled(n_chord=4, n_span=5, num_el=6,
                                          p=3, mc=16, ns=64, device=dev)
    v = demo.fd_direction(sys_, h0)
    fac = J_of_h.solve.device_factor
    its = J_of_h.solve.solver.its_log
    d = sys_.zero_displacement()

    def evaluate(h):
        nonlocal d
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, d, _, _ = demo.coupled_gradient(J_of_h, h, d)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for tag, k in (("vlm_cold", 0), ("vlm_warm_untimed", 1),
                   ("vlm_warm", 2)):
        nf, n0 = fac.n_factor, len(its)
        if tag.endswith("untimed"):
            evaluate(h0 + 1e-4 * k * v)
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            wall = evaluate(h0 + 1e-4 * k * v)
        report(tag, prof, wall, out,
               f"newton its per pass {its[n0:]}, factorizations "
               f"{fac.n_factor - nf}")


def main_press(out):
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import press_path, press_problem
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.implicit import (
        build_solve_fn,
        continuation_solve,
    )

    dev = torch.device("cuda", 0)
    _cuda.library()
    press_path(press_problem(6, dev))
    s = press_problem(32, dev)
    data = s.data
    fac = PersistentDeviceFactor(data)
    log = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d, _, _ = continuation_solve(data, s.cp, s.h_init,
                                     s.zero_displacement(), n_steps=4,
                                     rtol=1e-9, max_it=40, fac=fac, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report("press_continuation", prof, wall, out,
           f"Newton its per level {[i for i, _ in log]}, factorizations "
           f"{fac.n_factor} (failed {fac.n_factor_failed})")
    solve = build_solve_fn(data, rtol=1e-10, max_it=60)
    v = torch.tensor(np.random.default_rng(3).normal(
        size=tuple(s.h_init.shape)), device=dev) * s.stack.cp_mask

    def evaluate(h):
        hh = h.clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kl_shell.internal_energy(s.stack, solve(s.cp, hh, d), s.cp, hh,
                                 s.E, s.nu).backward()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    evaluate(s.h_init)
    nf = solve.device_factor.n_factor
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = evaluate(s.h_init + 1e-4 * v)
    report("press_adjoint", prof, wall, out,
           f"newton its {solve.solver.last_its}, factorizations "
           f"{solve.device_factor.n_factor - nf}")


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this profile needs one GPU")
    from torch.profiler import ProfilerActivity, profile

    args = [a for a in sys.argv[1:] if a not in ("--mi", "--tube",
                                                   "--plate", "--om-mi",
                                                   "--evtol-mi",
                                                   "--pegasus", "--vlm",
                                                   "--press")]
    out = args[0] if args else tempfile.mkdtemp()
    os.makedirs(out, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--mi" in sys.argv[1:]:
        return main_mi(out)
    if "--tube" in sys.argv[1:]:
        return main_tube(out)
    if "--plate" in sys.argv[1:]:
        return main_plate(out)
    if "--om-mi" in sys.argv[1:]:
        return main_om_mi(out)
    if "--evtol-mi" in sys.argv[1:]:
        return main_evtol_mi(out)
    if "--pegasus" in sys.argv[1:]:
        return main_pegasus(out)
    if "--vlm" in sys.argv[1:]:
        return main_vlm(out)
    if "--press" in sys.argv[1:]:
        return main_press(out)

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
