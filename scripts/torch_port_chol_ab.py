"""Walls of the Cholesky-route paths and the MI adjoint gate, on the GPU.

Two parts, each in one process of one tree's `goldfish_tpu_torch` (`--root`,
default this checkout), with this checkout's chip_smoke.py helpers:

walls  the evaluations whose device time `cholesky_solve` held (PERF.md
       §5), each after an untimed run that loads the CUDA modules:
       - wing20 (chip_smoke phase 4: wing.build(num_el=6, p=3),
         ThicknessFFD (4, 4, 1), rtol 1e-9): `--reps` warm 1e-4 steps
         after the cold iteration, host walls (median), then one more
         under torch.profiler (its device-busy time and the device
         operations that take most of it);
       - the MI T-beam of bench_mi.py (phase 6, N = 6072): the cold
         iteration at amp = 0.05, `--reps` warm steps (amp 1e-3 apart),
         one more profiled;
       - the VLM wing20 16 x 64 coupled evaluation with its gradient, cold
         (a fresh coupled build; phase 17);
       - the press at num_el=32 (phase 21, N = 6936): the cold 4-level
         continuation from d = 0 on a fresh factor, twice (median), then
         once more profiled.
c21    the MI solve function's adjoint gate (ROADMAP C21) at 1e-6 and
       1e-10 in turns (1e-6, 1e-10, 1e-10, 1e-6): at bench_mi's T-beam the
       cold iteration and 3 warm steps on a fresh solve function (the
       value + gradient wall; the adjoint's IR sweeps: the `n` of every
       `exact*` certificate in the factor's log; dJ/damp against
       tests/data/torch_port_mi_tbeam40_reference.json); at tbeam_stop
       (phase 33, contact, an LU factor) the value + gradient through
       `build_forward` after the four load levels; at TBEAM_STOP_SMALL
       dJ/d(amp) against tests/data/torch_port_contact_routes_reference.json.

To compare two trees, unpack the parent with `git archive <commit> | tar
-x -C scratch_chip/parent` and run them in turns in one chip call:

    for r in scratch_chip/parent . . scratch_chip/parent; do
        python scripts/torch_port_chol_ab.py --root $r --what walls; done
    python scripts/torch_port_chol_ab.py --what c21

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATES = (1e-6, 1e-10, 1e-10, 1e-6)


def _smoke():
    """This checkout's chip_smoke.py, whatever tree `--root` imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _profiled(fn, top=8):
    """(wall s, device-busy ms, [(name, device ms)]) of fn() under
    torch.profiler: device busy is the union of the kernel, memcpy and
    memset intervals of its trace (as scripts/profile_torch_iteration.py
    counts it); the top entries sum each device operation's durations by
    name."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = [e for e in json.load(fh)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") in
                      ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end, by_name = 0.0, -1e300, {}
    for e in sorted(events, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
        name = e["name"][:60]
        by_name[name] = by_name.get(name, 0.0) + e["dur"] / 1e3
    rows = sorted(by_name.items(), key=lambda r: -r[1])
    return wall, busy / 1e3, rows[:top]


def walls(sm, dev, reps):
    import numpy as np
    import torch

    from goldfish_tpu_torch.demos import vlm_aeroelastic_wing as demo
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import tbeam, wing
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.implicit import (
        build_solve_fn,
        continuation_solve,
    )

    out = {}
    # wing20: warm 1e-4 steps
    s = wing.build(num_el=6, p=3, device=dev)
    th = ThicknessFFD(s, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(s.data, rtol=1e-9, max_it=30)
    run = sm.make_iteration(s, th, solve)
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64,
                      device=dev)
    J, d, g, t_cold = run(h0, s.zero_displacement())
    ws = SecantWarmStart()
    ws.update(h0, d)
    warm = []
    for k in range(1, reps + 1):
        hk = h0 * (1.0 + 1e-4 * k)
        _, d, _, dt = run(hk, ws.predict(hk, d))
        ws.update(hk, d)
        warm.append(dt)
    hk = h0 * (1.0 + 1e-4 * (reps + 1))
    d0 = ws.predict(hk, d)
    wall, dev_ms, top = _profiled(lambda: run(hk, d0))
    out["wing20"] = dict(cold_s=t_cold, warm_s=warm,
                         warm_median_s=float(np.median(warm)),
                         profiled_wall_s=wall, device_ms=dev_ms, top=top,
                         J=float(J))
    print(f"[walls] wing20 cold {t_cold:.4f} s, warm median "
          f"{out['wing20']['warm_median_s']:.4f} s {warm}; profiled warm "
          f"step {wall * 1e3:.2f} ms, device busy {dev_ms:.3f} ms: {top}",
          flush=True)
    del s, solve, run
    torch.cuda.empty_cache()

    # the MI T-beam: cold and warm steps
    s = tbeam.build_mi(num_el=40, p=3, n_pts=17, device=dev)
    iteration, forward = sm.make_mi_iteration(s, dev)
    J, g, d, xi, t_cold = iteration(0.05, s.zero_displacement(), None)
    ws_d, ws_xi = SecantWarmStart(), SecantWarmStart()
    a0 = torch.tensor(0.05, dtype=torch.float64)
    ws_d.update(a0, d)
    ws_xi.update(a0, xi)
    warm = []
    for k in range(1, reps + 2):
        amp = 0.05 * (1.0 + 1e-3 * k)
        ak = torch.tensor(amp, dtype=torch.float64)
        seed, dk = ws_xi.predict(ak, xi).clamp(0.0, 1.0), ws_d.predict(ak, d)
        if k == reps + 1:
            wall, dev_ms, top = _profiled(lambda: iteration(amp, dk, seed))
            break
        J, g, d, xi, dt = iteration(amp, dk, seed)
        ws_d.update(ak, d)
        ws_xi.update(ak, xi)
        warm.append(dt)
    out["mi"] = dict(cold_s=t_cold, warm_s=warm,
                     warm_median_s=float(np.median(warm)),
                     profiled_wall_s=wall, device_ms=dev_ms, top=top)
    print(f"[walls] MI cold {t_cold:.4f} s, warm median "
          f"{out['mi']['warm_median_s']:.4f} s {warm}; profiled warm step "
          f"{wall * 1e3:.2f} ms, device busy {dev_ms:.3f} ms: {top}",
          flush=True)
    del s, iteration, forward
    torch.cuda.empty_cache()

    # VLM wing20 16 x 64: the cold coupled evaluation with its gradient
    J_s, s_s, h_s = demo.build_coupled(device=dev)
    demo.coupled_gradient(J_s, h_s, s_s.zero_displacement())
    del J_s, s_s, h_s
    J_of_h, s, h0 = demo.build_coupled(**sm.VLM_WIDE, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Jv, _, _, _ = demo.coupled_gradient(J_of_h, h0, s.zero_displacement())
    torch.cuda.synchronize()
    t_vlm = time.perf_counter() - t0
    out["vlm"] = dict(cold_s=t_vlm, J=float(Jv),
                      factorizations=J_of_h.solve.device_factor.n_factor)
    print(f"[walls] VLM 16x64 cold evaluation {t_vlm:.4f} s", flush=True)
    del J_of_h, s
    torch.cuda.empty_cache()

    # press32: the cold continuation, twice on fresh factors
    sm.press_path(sm.press_problem(6, dev))
    s = sm.press_problem(32, dev)
    conts = []
    for _ in range(2):
        fac = PersistentDeviceFactor(s.data)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        continuation_solve(s.data, s.cp, s.h_init, s.zero_displacement(),
                           n_steps=4, rtol=1e-9, max_it=40, fac=fac)
        torch.cuda.synchronize()
        conts.append(time.perf_counter() - t0)
    fac = PersistentDeviceFactor(s.data)
    wall, dev_ms, top = _profiled(lambda: continuation_solve(
        s.data, s.cp, s.h_init, s.zero_displacement(), n_steps=4, rtol=1e-9,
        max_it=40, fac=fac))
    out["press32"] = dict(cold_s=conts, cold_median_s=float(np.median(conts)),
                          factorizations=fac.n_factor, profiled_wall_s=wall,
                          device_ms=dev_ms, top=top)
    print(f"[walls] press32 cold continuation {conts}; profiled "
          f"{wall * 1e3:.2f} ms, device busy {dev_ms:.3f} ms: {top}",
          flush=True)
    return out


def _adjoint_sweeps(log):
    return sum(n for tag, n, _ in log if tag.startswith("exact"))


def c21(sm, dev):
    import numpy as np
    import torch

    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart

    with open(sm.REF_MI) as fh:
        ref_mi = json.load(fh)
    with open(sm.REF_ROUTES) as fh:
        ref_small = json.load(fh)["mi_small"]
    out = {"gates": list(GATES), "mi": [], "tbeam_stop": [], "small": []}
    s = tbeam.build_mi(num_el=40, p=3, n_pts=17, device=dev)
    for G in GATES:
        iteration, forward = sm.make_mi_iteration(s, dev)
        fac = forward.solve_d.device_factor
        fac._ADJOINT_TOL = G
        n0 = len(fac.cert_log)
        J, g, d, xi, t_cold = iteration(0.05, s.zero_displacement(), None)
        sweeps = [_adjoint_sweeps(fac.cert_log[n0:])]
        e_g = abs(g - ref_mi["dJ_damp"]) / abs(ref_mi["dJ_damp"])
        ws_d, ws_xi = SecantWarmStart(), SecantWarmStart()
        a0 = torch.tensor(0.05, dtype=torch.float64)
        ws_d.update(a0, d)
        ws_xi.update(a0, xi)
        warm = []
        for k in range(1, 4):
            amp = 0.05 * (1.0 + 1e-3 * k)
            ak = torch.tensor(amp, dtype=torch.float64)
            n0 = len(fac.cert_log)
            J, g, d, xi, dt = iteration(
                amp, ws_d.predict(ak, d), ws_xi.predict(ak, xi).clamp(0, 1))
            ws_d.update(ak, d)
            ws_xi.update(ak, xi)
            warm.append(dt)
            sweeps.append(_adjoint_sweeps(fac.cert_log[n0:]))
        row = dict(gate=G, cold_s=t_cold, warm_s=warm,
                   warm_median_s=float(np.median(warm)),
                   adjoint_sweeps=sweeps, dJ_damp_rel_cold=e_g,
                   n_factor=fac.n_factor)
        out["mi"].append(row)
        print(f"[c21] bench_mi gate {G:g}: cold {t_cold:.4f} s, warm "
              f"{warm}, adjoint sweeps (cold, warm...) {sweeps}, cold "
              f"dJ/damp rel to JAX {e_g:.3e}", flush=True)
        del iteration, forward, fac
    del s
    torch.cuda.empty_cache()
    s = sm.tbeam_stop_problem(dev, **sm.TBEAM_STOP_CARD)
    for G in GATES:
        o = sm.tbeam_stop_path(s, fd=False, adjoint_tol=G)
        log = o["solver"].factor.cert_log
        row = dict(gate=G, value_gradient_s=o["t_grad"],
                   levels_s=o["t_levels"], g_amp=o["g_amp"],
                   adjoint_sweeps=_adjoint_sweeps(log))
        out["tbeam_stop"].append(row)
        print(f"[c21] tbeam_stop gate {G:g}: value + gradient "
              f"{o['t_grad']:.4f} s, adjoint sweeps "
              f"{row['adjoint_sweeps']}, dJ/damp {o['g_amp']!r}", flush=True)
        del o
    del s
    torch.cuda.empty_cache()
    s = sm.tbeam_stop_problem(dev, **sm.TBEAM_STOP_SMALL)
    for G in GATES:
        o = sm.tbeam_stop_path(s, fd=False, adjoint_tol=G)
        e = abs(o["g_amp"] - ref_small["dJ_damp"]) / abs(ref_small["dJ_damp"])
        out["small"].append(dict(gate=G, dJ_damp_rel=e,
                                 value_gradient_s=o["t_grad"]))
        print(f"[c21] TBEAM_STOP_SMALL gate {G:g}: dJ/damp rel to JAX "
              f"{e:.3e}", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--what", nargs="+", default=["walls"],
                    choices=["walls", "c21"])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs one GPU")
    sm = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    from goldfish_tpu_torch import _cuda

    if not os.path.abspath(_cuda.__file__).startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    t0 = time.perf_counter()
    _cuda.library()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    res = {"card": card, "root": os.path.relpath(root, ROOT),
           "build_s": time.perf_counter() - t0}
    if "walls" in args.what:
        res["walls"] = walls(sm, dev, args.reps)
    if "c21" in args.what:
        res["c21"] = c21(sm, dev)
    print(json.dumps(res))


if __name__ == "__main__":
    main()
