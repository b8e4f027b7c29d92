"""GPU smoke run of the PyTorch port's main path (one NVIDIA card).

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no result line):

1. device: a CUDA card must be present; prints its name and power limit
   (nvidia-smi) and turns TF32 off;
2. build: nvcc-compiles goldfish_tpu_torch/csrc/*.cu into
   goldfish_tpu_torch/_build/ (first use) and prints the ptxas summary;
3. kernels: at the full 20-patch wing (6600 dofs) on the card, at a seeded
   nonzero d, every kernel (K1 shell_qp and K2 penalty_qp in their three
   modes, K3 jet_assemble, K4 jet_matvec) against its plain PyTorch version
   (relative error in norm <= 1e-11; f64 atomics sum in a run-dependent
   order), with both times;
4. main path: one thickness-optimization iteration of bench.py's workload
   (cold, with the adjoint gradient), checked against the JAX package's
   CPU f64 numbers in tests/data/torch_port_wing20_reference.json (J 1e-8,
   dJ/dh_ffd 1e-6), then 5 warm 1e-4 steps with the secant warm start and
   one 1e-2 refactor step; launch counters prove the path went through
   every kernel.

The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(ROOT, "tests", "data", "torch_port_wing20_reference.json")
KERNEL_TOL = 1e-11


def say(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` launches (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def rel_err(a, b):
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    den = float(torch.linalg.norm(b))
    return float(torch.linalg.norm(a - b)) / (den if den > 0 else 1.0), \
        float((a - b).abs().max())


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def phase_build():
    from goldfish_tpu_torch import _cuda

    t0 = time.perf_counter()
    _cuda.library()
    say(f"[build] kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(built={_cuda.build_info['built']}) -> {_cuda.build_info['path']}")
    with open(_cuda.build_info["ptxas_log"]) as fh:
        for line in fh:
            if "Compiling entry" in line or "spill" in line \
                    or "Used" in line:
                say("[ptxas] " + line.strip())


# name, source, replaced JAX device program (file:line)
KERNELS = [
    ("shell_qp/value_grad", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:142"),
    ("shell_qp/hess", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:198"),
    ("shell_qp/adjoint", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/solver/implicit.py:516"),
    ("penalty_qp/value_grad", "goldfish_tpu_torch/csrc/penalty_qp.cu",
     "goldfish_tpu/physics/coupling.py:270"),
    ("penalty_qp/hess", "goldfish_tpu_torch/csrc/penalty_qp.cu",
     "goldfish_tpu/physics/coupling.py:318"),
    ("penalty_qp/adjoint", "goldfish_tpu_torch/csrc/penalty_qp.cu",
     "goldfish_tpu/solver/implicit.py:516"),
    ("jet_assemble", "goldfish_tpu_torch/csrc/jet_assemble.cu",
     "goldfish_tpu/solver/system.py:194"),
    ("jet_matvec", "goldfish_tpu_torch/csrc/jet_matvec.cu",
     "goldfish_tpu/solver/system.py:104"),
]


def kernel_cases(sys_, seed=0):
    """(name -> (kernel fn, plain fn)) on the card at a seeded state."""
    from goldfish_tpu_torch.physics import coupling, kl_shell
    from goldfish_tpu_torch.solver import system

    data = sys_.data
    dev = sys_.cp.device
    rng = np.random.default_rng(seed)
    cp, h, st, ifs = sys_.cp, sys_.h_init, data.stack, data.ifs
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * data.free
    lam = T(rng.normal(size=tuple(cp.shape)))
    v = T(rng.normal(size=tuple(cp.shape)))
    E, nu = data.E, data.nu
    tables = system.jet_tables(data)
    Hs = system.jet_hessians(data, d, cp, h)
    free = tables.free
    N = free.shape[0]

    def assemble(fn):
        K = torch.zeros(N, N, dtype=torch.float64, device=dev)
        fn(K, Hs[0], tables.R_e, tables.gi_e, free)
        fn(K, Hs[1], tables.R_i, tables.gi_i, free)
        return K

    def matvec(fn):
        y = torch.zeros(N, dtype=torch.float64, device=dev)
        vf = v.reshape(-1)
        fn(y, Hs[0], tables.R_e, tables.gi_e, free, vf)
        fn(y, Hs[1], tables.R_i, tables.gi_i, free, vf)
        return y

    return {
        "shell_qp/value_grad": (
            lambda: kl_shell.shell_value_grad(st, d, cp, h, E, nu),
            lambda: kl_shell._value_grad_plain(st, d, cp, h, E, nu)),
        "shell_qp/hess": (
            lambda: kl_shell.shell_hessians(st, d, cp, h, E, nu),
            lambda: kl_shell._hessians_plain(st, d, cp, h, E, nu)),
        "shell_qp/adjoint": (
            lambda: kl_shell.shell_adjoint(st, d, cp, h, E, nu, lam),
            lambda: kl_shell._adjoint_plain(st, d, cp, h, E, nu, lam)),
        "penalty_qp/value_grad": (
            lambda: coupling.penalty_value_grad(ifs, d, cp, h, E),
            lambda: coupling._value_grad_plain(ifs, d, cp, h, E)),
        "penalty_qp/hess": (
            lambda: coupling.penalty_hessians(ifs, d, cp, h, E),
            lambda: coupling._hessians_plain(ifs, d, cp, h, E)),
        "penalty_qp/adjoint": (
            lambda: coupling.penalty_adjoint(ifs, d, cp, h, E, lam),
            lambda: coupling._adjoint_plain(ifs, d, cp, h, E, lam)),
        "jet_assemble": (lambda: assemble(system.jet_assemble),
                         lambda: assemble(system._assemble_plain)),
        "jet_matvec": (lambda: matvec(system.jet_matvec),
                       lambda: matvec(system._matvec_plain)),
    }


def phase_kernels(sys_, reps=5):
    """Compare every kernel with its plain version; returns
    {name: (rel_err, max_abs_err, ms, plain_ms)}."""
    out = {}
    for name, (kern, plain) in kernel_cases(sys_).items():
        a, b = kern(), plain()
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        rel = mx = 0.0
        for x, y in zip(a, b):
            if not bool(torch.isfinite(x).all()):
                raise RuntimeError(f"{name}: non-finite kernel output")
            r, m = rel_err(x, y)
            rel, mx = max(rel, r), max(mx, m)
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, max(1, reps // 2))
        say(f"[kernel] {name:22s} rel {rel:.3e} max_abs {mx:.3e} "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms")
        if not rel <= KERNEL_TOL:
            raise RuntimeError(f"{name}: kernel vs plain rel err {rel:.3e} "
                               f"> {KERNEL_TOL:g}")
        out[name] = (rel, mx, ms, plain_ms)
    return out


def make_iteration(sys_, th, solve):
    from goldfish_tpu_torch.physics import kl_shell

    def opt_iteration(h_ffd, d0):
        hf = h_ffd.clone().requires_grad_(True)
        h = th(hf)
        d = solve(sys_.cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, sys_.cp, h, sys_.E,
                                     sys_.nu)
        J.backward()
        return J.detach(), d.detach(), hf.grad

    def timed(h_ffd, d0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        J, d, g = opt_iteration(h_ffd, d0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ok = (bool(torch.isfinite(J)) and bool(torch.isfinite(d).all())
              and bool(torch.isfinite(g).all()) and d.shape == sys_.cp.shape
              and g.shape == h_ffd.shape)
        if not ok:
            raise RuntimeError("non-finite or misshapen iteration output")
        return J, d, g, dt

    return timed


def phase_main_path(sys_, dev):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    with open(REF) as fh:
        ref = json.load(fh)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    fac = solve.device_factor
    run = make_iteration(sys_, th, solve)
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64,
                      device=dev)

    _cuda.reset_launch_counts()
    J, d, g, t_cold = run(h0, sys_.zero_displacement())
    eJ = abs(float(J) - ref["J"]) / abs(ref["J"])
    g_ref = torch.tensor(ref["dJ_dh_ffd"], dtype=torch.float64)
    eg = rel_err(g.cpu(), g_ref)[0]
    say(f"[main] cold iteration {t_cold:.3f} s  J={float(J)!r} "
        f"(ref {ref['J']!r}, rel {eJ:.2e})  |dJ/dh_ffd| rel {eg:.2e}  "
        f"|d|={float(torch.linalg.norm(d))!r} (ref {ref['d_norm']!r})")
    if not (eJ <= 1e-8 and eg <= 1e-6):
        raise RuntimeError(f"cold iteration disagrees with the JAX CPU "
                           f"reference: J rel {eJ:.2e}, grad rel {eg:.2e}")

    ws = SecantWarmStart()
    ws.update(h0, d)
    warm = []
    for k in range(1, 6):
        hk = h0 * (1.0 + 1e-4 * k)
        Jk, d, gk, dt = run(hk, ws.predict(hk, d))
        ws.update(hk, d)
        warm.append(dt)
        say(f"[main] warm iteration {k}/5 {dt:.3f} s J={float(Jk)!r} "
            f"newton its {solve.solver.last_its}")
    h_big = h0 * (1.0 + 1e-2)
    Jb, db, gb, t_ref = run(h_big, ws.predict(h_big, d))
    counts = dict(_cuda.launch_counts)
    say(f"[main] refactor iteration (1e-2) {t_ref:.3f} s J={float(Jb)!r} "
        f"newton its {solve.solver.last_its}")
    say(f"[main] warm median {float(np.median(warm)):.3f} s; "
        f"n_factor {fac.n_factor} (failed {fac.n_factor_failed})")
    say(f"[main] refactor_log {fac.refactor_log}")
    say(f"[main] cert_log tail {fac.cert_log[-16:]}")
    say(f"[main] launch counts {counts}")
    missing = [k for k, n in counts.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    return counts


def main():
    dev = phase_device()
    phase_build()
    from goldfish_tpu_torch.models import wing

    t0 = time.perf_counter()
    sys_ = wing.build(num_el=6, p=3, device=dev)
    P, C = sys_.stack.n_patches, sys_.stack.max_cp
    say(f"[setup] wing20 built in {time.perf_counter() - t0:.1f} s: "
        f"P={P} C={C} N={P * C * 3} stack {tuple(sys_.stack.R00.shape)} "
        f"ifs {tuple(sys_.ifs.RA00.shape)}")
    checks = phase_kernels(sys_)
    counts = phase_main_path(sys_, dev)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": checks[name][1],
         "ms": checks[name][2], "plain_ms": checks[name][3]}
        for name, src, rep in KERNELS]}
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
