"""GPU smoke run of the PyTorch port's main paths (one NVIDIA card).

    python3 chip_smoke.py

Phases (any failure raises: non-zero exit, no result line):

1. device: a CUDA card must be present; prints its name and power limit
   (nvidia-smi) and turns TF32 off;
2. build: nvcc-compiles goldfish_tpu_torch/csrc/*.cu into
   goldfish_tpu_torch/_build/ (first use) and prints the ptxas summary;
3. wing kernels: at the full 20-patch wing (6600 dofs) on the card, at a
   seeded nonzero d, K1 shell_qp and K2 penalty_qp in their three modes,
   K3 jet_assemble and K4 jet_matvec against their plain PyTorch versions
   (relative error in norm <= 1e-11; f64 atomics sum in a run-dependent
   order), with both times;
4. wing main path: one thickness-optimization iteration of bench.py's
   workload (cold, with the adjoint gradient), checked against the JAX
   package's CPU f64 numbers in tests/data/torch_port_wing20_reference.json
   (J 1e-8, dJ/dh_ffd 1e-6), then 5 warm 1e-4 steps with the secant warm
   start and one 1e-2 refactor step;
5. MI kernels: the moving-intersection T-beam of scripts/bench_mi.py at its
   full size (N = 6072 dofs, one seam of 17 points) on the card, at a
   seeded state (xi moved within its knot spans, d the linear response to
   the tip load, lambda random): K5 traced_rows (also at the unperturbed
   seam that lies on a knot), K6 mi_penalty_xi, K7 c2x_res_jac (both
   modes; also at a seam along an edge of both patches, whose coincidence
   rows take the edge-to-edge variant), K1's geometry-gradient mode, and
   K1-K4 as the MI path runs them (d with seeded noise, as for the wing:
   at the coupled response the seam's displacement jump cancels, and K2
   mode a there is printed beside its own one-ulp sensitivity, not
   gated): K1 and K2 in their three modes on the T-beam stack and on the
   interface stack of K5's rows, K3 for the full MI tangent and through
   the Woodbury seam-slot map, K4 - each against its plain version
   (1e-11), with both times;
6. MI main path: one shape iteration of bench_mi.py (cp(amp) -> xi ->
   warm-started MI Newton with the Woodbury seam correction -> J -> dJ/damp
   through both implicit solves), cold at amp = 0.05 from d = 0, checked
   against tests/data/torch_port_mi_tbeam40_reference.json (J 1e-8,
   dJ/damp 1e-6), then 5 warm steps amp = 0.05 (1 + 1e-3 k) with secant
   warm starts for d, xi and (inside the solve) the adjoint;
7. tube kernels: the pressurized tube at the size and follower pressure of
   tests/data/torch_port_tube16_reference.json (num_el=16, p=3: 4 patches,
   degree (3, 2), 12 qps, N = 8436) on the card, at d = the pressure's linear
   response plus seeded noise, lambda random: K8 pressure_qp in its three
   modes and K1-K4 (K3/K4 with the pressure group) on the fixed-seam
   elliptic tube; K5-K7 and K1-K4 (K3 also through the seam-slot map) on
   the moving-seam tube (four edge seams of 35 points, xi moved inside its
   edges); each against its plain version (1e-11), with both times;
8. fixed-seam tube path (goldfish_tpu_torch/demos/tube_shape_opt.py): J
   and dJ/dp at p0 from d = 0 against tests/data/
   torch_port_tube16_reference.json (J 1e-8, gradient 1e-6), then
   OptProblem.run_slsqp(maxiter=3): it must lower J and keep the pin
   residual <= 1e-10;
9. moving-seam tube path (goldfish_tpu_torch/demos/
   draft_tube_shopt_mi_wffd.py): the same at p_start;
10. plate kernels: the stress-constrained plate of tests/data/
   torch_port_plate32_reference.json (num_el=32, p=2: 2 patches, C = 1190,
   N = 7140, 9 qps, the first L = 9 model on the card) at d = its Newton
   solution plus seeded noise: K9 vm_stress_qp in both modes (top and
   bottom; value 1e-12, VJP 1e-11) and K1-K4 (1e-11) against their plain
   versions, with both times; the smallest stress of a real qp at the
   solution (K9 and its plain version give no derivative at sigma = 0);
11. plate path (goldfish_tpu_torch/demos/plate_var_th_opt_stress.py through
   the port's OpenMDAO graph and om_shim): the cold run_model (KS stress at
   rho = 100 and volume, 1e-8 against the reference), compute_totals of
   the volume and of the KS stress at rho = 50/m w.r.t. the thickness FFD
   (1e-6), then the demo's SLSQP (run_driver, maxiter 30): it must lower
   the volume and meet each of the demo's assertions that the JAX
   reference meets at this size; then the sibling demo
   (om_plate_var_th_opt_wint.py) at the same size: cold run_model and
   totals against the reference's sibling numbers;
12. library calls: cholesky_ex, cholesky_solve, the Woodbury capacitance
   linalg.solve and the batched xi linalg.solve at each path's size, timed
   with CUDA events beside their bounds.

Launch counters, reset just before each main path and read just after,
prove that the path went through its kernels. The line before the last is
the kernels' JSON record; the last line is {"ok": true, "device": {...}}.
Imports nothing of JAX.
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
REF_MI = os.path.join(ROOT, "tests", "data",
                      "torch_port_mi_tbeam40_reference.json")
REF_TUBE = os.path.join(ROOT, "tests", "data",
                        "torch_port_tube16_reference.json")
REF_PLATE = os.path.join(ROOT, "tests", "data",
                         "torch_port_plate32_reference.json")
KERNEL_TOL = 1e-11
STRESS_TOL = {"vm_stress_qp/value": 1e-12, "vm_stress_qp/vjp": 1e-11}
# NVIDIA H100 SXM data sheet: HBM3 bandwidth, the f64 rate outside the
# tensor cores (none of the kernels is a matrix product) and the f64
# tensor-core rate (the bound of the dense factorizations)
PEAK_BYTES = 3.35e12
PEAK_F64 = 34e12
PEAK_F64_TC = 67e12


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


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts
               if isinstance(t, torch.Tensor))


def bound(bytes_, flops):
    """Least time (ms) for the work on the card: the larger of bytes over
    the memory rate and f64 operations over the f64 rate."""
    tb = bytes_ / PEAK_BYTES * 1e3
    tf = flops / PEAK_F64 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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
    ("shell_qp/geom_grad", "goldfish_tpu_torch/csrc/shell_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:142"),
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
    ("traced_rows", "goldfish_tpu_torch/csrc/traced_rows.cu",
     "goldfish_tpu/ops/bspline_jax.py:124"),
    ("mi_penalty_xi", "goldfish_tpu_torch/csrc/mi_penalty_xi.cu",
     "goldfish_tpu/solver/system_mi.py:1038"),
    ("c2x_res_jac/res_jac", "goldfish_tpu_torch/csrc/c2x_res_jac.cu",
     "goldfish_tpu/geometry/cpiga2xi.py:202"),
    ("c2x_res_jac/adjoint", "goldfish_tpu_torch/csrc/c2x_res_jac.cu",
     "goldfish_tpu/geometry/cpiga2xi.py:356"),
    ("pressure_qp/value_grad", "goldfish_tpu_torch/csrc/pressure_qp.cu",
     "goldfish_tpu/physics/loads.py:146"),
    ("pressure_qp/hess", "goldfish_tpu_torch/csrc/pressure_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:198"),
    ("pressure_qp/adjoint", "goldfish_tpu_torch/csrc/pressure_qp.cu",
     "goldfish_tpu/solver/implicit.py:516"),
    ("vm_stress_qp/value", "goldfish_tpu_torch/csrc/vm_stress_qp.cu",
     "goldfish_tpu/physics/kl_shell.py:339"),
    ("vm_stress_qp/vjp", "goldfish_tpu_torch/csrc/vm_stress_qp.cu",
     "goldfish_tpu/physics/objectives.py:97"),
]
WING_KERNELS = ("shell_qp/value_grad", "shell_qp/hess", "shell_qp/adjoint",
                "penalty_qp/value_grad", "penalty_qp/hess",
                "penalty_qp/adjoint", "jet_assemble", "jet_matvec")
MI_PATH_KERNELS = tuple(k[0] for k in KERNELS[:13])
PRESSURE_KERNELS = ("pressure_qp/value_grad", "pressure_qp/hess",
                    "pressure_qp/adjoint")
TUBE_KERNELS = WING_KERNELS + ("shell_qp/geom_grad",) + PRESSURE_KERNELS
TUBE_MI_KERNELS = MI_PATH_KERNELS + PRESSURE_KERNELS
PLATE_KERNELS = WING_KERNELS + ("vm_stress_qp/value", "vm_stress_qp/vjp")

# f64 operations of one density evaluation (counted from the sources); a
# kernel mode's count is that times the dual components it carries
DENS_SHELL, DENS_PEN, DENS_VM = 200, 250, 300


def fixed_cases(data, d, cp, h, lam, v):
    """name -> (kernel fn, plain fn, flops, inputs) of K1-K4 on the card,
    on a SystemData (its stack and interface stack) at state d."""
    from goldfish_tpu_torch.physics import coupling, kl_shell
    from goldfish_tpu_torch.solver import system

    st, ifs = data.stack, data.ifs
    E, nu = data.E, data.nu
    tables = system.jet_tables(data)
    Hs = system.jet_hessians(data, d, cp, h)
    free = tables.free
    N = free.shape[0]
    dev = free.device

    groups = [(Hs[0], tables.R_e, tables.gi_e),
              (Hs[1], tables.R_i, tables.gi_i)]
    if Hs[2] is not None:   # the follower pressure's group
        groups.append((Hs[2], tables.R_p, tables.gi_e))

    def assemble(fn):
        K = torch.zeros(N, N, dtype=torch.float64, device=dev)
        for H, R, gi in groups:
            fn(K, H, R, gi, free)
        return K

    def matvec(fn):
        y = torch.zeros(N, dtype=torch.float64, device=dev)
        vf = v.reshape(-1)
        for H, R, gi in groups:
            fn(y, H, R, gi, free, vf)
        return y

    P, Ne, Q, L = st.R00.shape
    nqp = P * Ne * Q
    I_, Nq, Li = ifs.RA00.shape
    nip = I_ * Nq
    jets_s = 2 * 15 * L * 2 + 2 * L          # X, z jets + h per qp
    jets_p = 2 * (9 * Li * 2 + 2 * Li) * 2    # both sides, X, z, h
    g_e, g_i = tables.R_e.shape[0], tables.R_i.shape[0]
    # K3: 9 FMAs per (local pair, qp, jet pair); K4: gather, H z, scatter
    asm = 18 * (g_e * L * L * Q * 25 + g_i * (2 * Li) ** 2 * 36)
    mv = g_e * Q * (12 * 5 * L + 450) + g_i * (12 * 6 * 2 * Li + 648)
    if Hs[2] is not None:
        asm += 18 * g_e * L * L * Q * 9
        mv += g_e * Q * (12 * 3 * L + 162)
    base = [d, cp, h, E, nu, data.free]
    shell_in = base + list(st)
    pen_in = base + list(ifs)
    jet_in = list(tables) + list(Hs)
    return {
        "shell_qp/value_grad": (
            lambda: kl_shell.shell_value_grad(st, d, cp, h, E, nu),
            lambda: kl_shell._value_grad_plain(st, d, cp, h, E, nu),
            nqp * (jets_s + 17 * DENS_SHELL), shell_in),
        "shell_qp/hess": (
            lambda: kl_shell.shell_hessians(st, d, cp, h, E, nu),
            lambda: kl_shell._hessians_plain(st, d, cp, h, E, nu),
            nqp * 15 * (jets_s + 32 * DENS_SHELL), shell_in),
        "shell_qp/adjoint": (
            lambda: kl_shell.shell_adjoint(st, d, cp, h, E, nu, lam),
            lambda: kl_shell._adjoint_plain(st, d, cp, h, E, nu, lam),
            nqp * (jets_s * 3 // 2 + 34 * DENS_SHELL), shell_in + [lam]),
        "penalty_qp/value_grad": (
            lambda: coupling.penalty_value_grad(ifs, d, cp, h, E),
            lambda: coupling._value_grad_plain(ifs, d, cp, h, E),
            nip * (jets_p + 21 * DENS_PEN), pen_in),
        "penalty_qp/hess": (
            lambda: coupling.penalty_hessians(ifs, d, cp, h, E),
            lambda: coupling._hessians_plain(ifs, d, cp, h, E),
            nip * 18 * (jets_p + 38 * DENS_PEN), pen_in),
        "penalty_qp/adjoint": (
            lambda: coupling.penalty_adjoint(ifs, d, cp, h, E, lam),
            lambda: coupling._adjoint_plain(ifs, d, cp, h, E, lam),
            nip * (jets_p * 3 // 2 + 30 * DENS_PEN), pen_in + [lam]),
        "jet_assemble": (lambda: assemble(system.jet_assemble),
                         lambda: assemble(system._assemble_plain), asm,
                         jet_in),
        "jet_matvec": (lambda: matvec(system.jet_matvec),
                       lambda: matvec(system._matvec_plain), mv,
                       jet_in + [v]),
    }


def pressure_cases(data, d, cp, lam):
    """K8 in its three modes on the stack of `data` (which has a follower
    pressure): name -> (kernel fn, plain fn, flops, inputs)."""
    from goldfish_tpu_torch.physics import loads

    st, pr = data.stack, data.pressure
    P, Ne, Q, L = st.R00.shape
    nqp = P * Ne * Q
    ins = [st.R00, st.R10, st.R01, st.conn, st.wq, d, cp, pr]
    # per qp: 9-jet gathers (36 flops per local and field), the triple
    # products and cross products (~70), the scatter (18 per local); the
    # Hessian applies 9 directional derivatives (~72 each)
    return {
        "pressure_qp/value_grad": (
            lambda: loads.pressure_value_grad(st, d, cp, pr),
            lambda: loads._pressure_value_grad_plain(st, d, cp, pr),
            nqp * (54 * L + 70), ins),
        "pressure_qp/hess": (
            lambda: loads.pressure_hessians(st, d, cp, pr),
            lambda: loads._pressure_hessians_plain(st, d, cp, pr),
            nqp * (36 * L + 9 * 72), ins),
        "pressure_qp/adjoint": (
            lambda: loads.pressure_adjoint(st, d, cp, pr, lam),
            lambda: loads._pressure_adjoint_plain(st, d, cp, pr, lam),
            nqp * (72 * L + 72), ins + [lam]),
    }


def check_kernels(cases, tag, reps=5, tol=None):
    """Compare every kernel with its plain version (relative error in norm
    <= tol[name], default KERNEL_TOL); returns {name: dict} with the
    relative and max abs error, both times and the bound."""
    out = {}
    for name, (kern, plain, flops, inputs) in cases.items():
        a, b = kern(), plain()
        torch.cuda.synchronize()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        rel = mx = 0.0
        for x, y in zip(a, b):
            if x is None:
                continue
            if not bool(torch.isfinite(x.double()).all()):
                raise RuntimeError(f"{name}: non-finite kernel output")
            r, m = rel_err(x, y)
            rel, mx = max(rel, r), max(mx, m)
        ms = cuda_ms(kern, reps)
        plain_ms = cuda_ms(plain, max(1, reps // 2))
        b_ms, b_by = bound(nbytes(*inputs, *a), flops)
        say(f"[{tag}] {name:22s} rel {rel:.3e} max_abs {mx:.3e} "
            f"kernel {ms:.3f} ms plain {plain_ms:.3f} ms "
            f"bound {b_ms:.4f} ms ({b_by})")
        gate = (tol or {}).get(name, KERNEL_TOL)
        if not rel <= gate:
            raise RuntimeError(f"{name}: kernel vs plain rel err {rel:.3e} "
                               f"> {gate:g}")
        out[name] = dict(rel=rel, max_abs_err=mx, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
    return out


def phase_kernels(sys_, reps=5, seed=0):
    """K1-K4 against their plain versions at a seeded state of the wing:
    d random at 1e-3 of the CP scale on free dofs, lam and v random."""
    dev = sys_.cp.device
    rng = np.random.default_rng(seed)
    cp = sys_.cp
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * sys_.data.free
    lam = T(rng.normal(size=tuple(cp.shape)))
    v = T(rng.normal(size=tuple(cp.shape)))
    return check_kernels(fixed_cases(sys_.data, d, cp, sys_.h_init, lam, v),
                         "kernel", reps)


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
    missing = [k for k in WING_KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    return counts, fac


# ------------------------------------------------------------ MI T-beam
def mi_state(sys_, seed=1):
    """A seeded MI state on the card: (cp, h, xi, d, lam). xi is the
    initial seam moved by up to 1e-3 inside its knot spans (clipped to the
    parametric domain), d the linear response to the tip load, lam
    random on free dofs."""
    from goldfish_tpu_torch.solver import system_mi

    dev = sys_.cp.device
    rng = np.random.default_rng(seed)
    cp, h = sys_.cp, sys_.h_init
    xi0 = sys_.c2x.xi0_flat
    xi = (xi0 + torch.tensor(1e-3 * rng.uniform(-1, 1, size=xi0.shape),
                             device=dev)).clamp(0.0, 1.0).contiguous()
    zero = torch.zeros_like(cp)
    K0 = system_mi.assemble_K_mi(*sys_.mi_args, zero, cp, h, xi)
    r0 = system_mi.residual_mi(*sys_.mi_args, zero, cp, h, xi)
    d = torch.linalg.solve(K0, -r0.reshape(-1)).reshape(cp.shape)
    lam = torch.tensor(rng.normal(size=tuple(cp.shape)), device=dev) \
        * sys_.data.free
    return cp, h, xi, d, lam


def edge_seam(dev):
    """A CPIGA2Xi whose seam runs along an edge of both patches
    (both_edges = 1), a stretched cp, a moved xi and a cotangent."""
    from goldfish_tpu_torch.geometry.cpiga2xi import CPIGA2Xi
    from goldfish_tpu_torch.geometry.patch_stack import (
        build_patch_stack,
        stack_control_points,
    )
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.physics.coupling import InterfaceSpec

    L = tbeam.LENGTH
    surfs = [tbeam.create_surf([[-1, 0, 0], [0, 0, 0], [-1, L, 0],
                                [0, L, 0]], 2, 3, 3),
             tbeam.create_surf([[0, 0, 0], [1, 0, 0], [0, L, 0],
                                [1, L, 0]], 2, 4, 3)]
    spec = InterfaceSpec(pair=(0, 1),
                         xi_ends_A=np.array([[1.0, 0.0], [1.0, 1.0]]),
                         xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                         n_mortar_el=6)
    c2x = CPIGA2Xi(surfs, [spec], n_pts_list=[7], device=dev)
    cp = stack_control_points(build_patch_stack(surfs, device=dev)[1],
                              device=dev)
    cp[..., 0] *= 1.02
    x0 = c2x.xi0_flat
    rng = np.random.default_rng(3)
    x = (x0 + torch.tensor(1e-3 * rng.normal(size=tuple(x0.shape)),
                           device=dev)).contiguous()
    g = torch.tensor(rng.normal(size=tuple(x0.shape)), device=dev)
    return c2x, cp, x, g


def mi_kernel_cases(sys_, edge=True):
    """(name, case...) -> (kernel fn, plain fn, flops, inputs) of an MI
    system; the first case of each name is the one the MI path runs.
    `edge` adds K7's edge-to-edge variant on a synthetic seam (for a system
    whose own seams do not take it)."""
    from goldfish_tpu_torch.geometry import cpiga2xi
    from goldfish_tpu_torch.ops import bspline_traced as bt
    from goldfish_tpu_torch.physics import coupling_mi, kl_shell
    from goldfish_tpu_torch.solver import system, system_mi

    cp, h, xi, d, lam = mi_state(sys_)
    mi, co, ss, p, q = sys_.mi, sys_.co, sys_.ss, sys_.pdeg, sys_.qdeg
    data = sys_.data
    I, N = mi.n_int, mi.n_max
    L = (p + 1) * (q + 1)
    xi4 = xi.reshape(I, N, 2, 2)

    def pts_of(x):
        x4 = x.reshape(I, N, 2, 2)
        ip = torch.cat([mi.pairA[:, None].expand(I, N).reshape(-1),
                        mi.pairB[:, None].expand(I, N).reshape(-1)])
        return ip.contiguous(), \
            x4.permute(2, 0, 1, 3).reshape(-1, 2).contiguous()

    ip, pts = pts_of(xi)
    ip0, pts0 = pts_of(sys_.c2x.xi0_flat)
    M = ip.shape[0]

    basis = 2 * 4 * 12 + 16 * 3          # two 1D recursions + the tensor
    dA = coupling_mi._curve_tangents(xi4[:, :, 0], mi.n_pts).contiguous()
    dB = coupling_mi._curve_tangents(xi4[:, :, 1], mi.n_pts).contiguous()
    E = data.E
    gx = torch.tensor(np.random.default_rng(2).normal(size=(I, 4 * N)),
                      device=cp.device)
    st = data.stack
    P_, Ne, Q, Ls = st.R00.shape
    sv = [ss.knots_u, ss.knots_v, ss.span_u_vals, ss.span_u_ids,
          ss.span_v_vals, ss.span_v_ids, ss.w, ss.n_v]
    mi_in = [mi.pairA, mi.pairB, mi.n_pts, mi.end_dir, mi.end_val, mi.xi0,
             mi.both_edges, mi.epin_dir, mi.epin_val]
    cases = {}
    for tag, (ipx, ptx) in (("moved", (ip, pts)), ("on-knot", (ip0, pts0))):
        cases[("traced_rows", tag)] = (
            lambda ipx=ipx, ptx=ptx: bt.traced_rows(ss, p, q, ipx, ptx),
            lambda ipx=ipx, ptx=ptx: bt._rows_plain(ss, p, q, ipx, ptx),
            M * (basis * 3 + L * 6), sv + [ipx, ptx])
    cases[("mi_penalty_xi",)] = (
        lambda: coupling_mi.mi_penalty_xi(ss, p, q, mi, co, xi4, dA, dB, d,
                                          cp, h, E, lam),
        lambda: coupling_mi._xi_grad_plain(ss, p, q, mi, co, xi4, dA, dB, d,
                                           cp, h, E, lam),
        I * N * (2 * basis * 9 + 2 * L * 6 * 9 * 3 + 18 * DENS_PEN),
        sv + [xi4, dA, dB, co.w_s, d, cp, h, lam])
    cases[("c2x_res_jac/res_jac",)] = (
        lambda: cpiga2xi.c2x_res_jac(ss, p, q, mi, cp, xi),
        lambda: cpiga2xi._res_jac_plain(ss, p, q, mi, cp, xi, True),
        I * N * (2 * (basis * 3 + L * 3 * 6) + 4 * 16 * 40),
        sv + mi_in + [cp, xi])
    cases[("c2x_res_jac/adjoint",)] = (
        lambda: cpiga2xi.c2x_res_vjp(ss, p, q, mi, cp, xi, gx),
        lambda: cpiga2xi._res_vjp_plain(ss, p, q, mi, cp, xi, gx),
        I * N * (2 * (basis * 3 + L * 3 * 6) + 4 * 16 * 40),
        sv + mi_in + [cp, xi, gx])
    if edge:
        # K7's edge-to-edge variant, which the T-beam's seam does not take:
        # two flat patches side by side, seam along A's u = 1 and B's u = 0
        ex, ecp, ex_x, eg = edge_seam(cp.device)
        e_in = [ex.mi.pairA, ex.mi.pairB, ex.mi.n_pts, ex.mi.end_dir,
                ex.mi.end_val, ex.mi.xi0, ex.mi.both_edges, ex.mi.epin_dir,
                ex.mi.epin_val, ecp, ex_x]
        cases[("c2x_res_jac/res_jac", "edge")] = (
            lambda: cpiga2xi.c2x_res_jac(ex.ss, p, q, ex.mi, ecp, ex_x),
            lambda: cpiga2xi._res_jac_plain(ex.ss, p, q, ex.mi, ecp, ex_x,
                                            True),
            0, e_in)
        cases[("c2x_res_jac/adjoint", "edge")] = (
            lambda: cpiga2xi.c2x_res_vjp(ex.ss, p, q, ex.mi, ecp, ex_x, eg),
            lambda: cpiga2xi._res_vjp_plain(ex.ss, p, q, ex.mi, ecp, ex_x,
                                            eg),
            0, e_in + [eg])
    cases[("shell_qp/geom_grad",)] = (
        lambda: kl_shell.shell_geom_grad(st, d, cp, h, E, data.nu),
        lambda: kl_shell._geom_grad_plain(st, d, cp, h, E, data.nu),
        P_ * Ne * Q * (2 * 15 * Ls * 2 + 2 * Ls + 16 * DENS_SHELL),
        list(st) + [d, cp, h])
    # K1-K4 as the MI path runs them: the T-beam stack, the interface stack
    # of K5's rows at xi, the full MI tangent. At the coupled response d
    # the displacement jump across the seam nearly cancels and K2's value
    # and gradient are ill-conditioned in d (`seam_conditioning`), so, as
    # for the wing, d gets seeded noise (1e-3 of its largest entry)
    dx = system_mi.data_at(data, mi, co, ss, p, q, xi)
    rng = np.random.default_rng(4)
    T = lambda a: torch.tensor(a, device=cp.device)  # noqa
    dn = d + T(1e-3 * float(d.abs().max())
               * rng.normal(size=tuple(cp.shape))) * data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    for name, case in fixed_cases(dx, dn, cp, h, lam, v).items():
        cases[(name, "mi")] = case
    # K3 through the Woodbury seam-slot map: every dof outside the seam
    # subspace lands in one padding slot whose free entry is 0
    fac = system_mi.PersistentDeviceFactorMI(*sys_.mi_args)
    fac.ensure(cp, h, xi, d, force=True, why="smoke")
    H_i, tab = fac._interface_hessians((cp, h, xi, d))
    cases[("jet_assemble", "seam-slots")] = (
        lambda: fac._compact_K(H_i, tab),
        lambda: fac._compact_K(H_i, tab, system._assemble_plain),
        18 * tab.R_i.shape[0] * tab.R_i.shape[-1] ** 2 * 36,
        [H_i, tab.R_i, tab.gi_i, fac._free_m])
    return cases


def seam_conditioning(sys_):
    """Printed, not gated: K2 mode a at the coupled response d, kernel vs
    plain, beside the plain version's own change when d moves by one ulp
    (relative). The displacement jump across the seam nearly cancels
    there, so two correct f64 evaluations differ by about the latter."""
    from goldfish_tpu_torch.physics import coupling
    from goldfish_tpu_torch.solver import system_mi

    cp, h, xi, d, _ = mi_state(sys_)
    ifs = system_mi.data_at(*sys_.mi_args, xi).ifs
    E = sys_.data.E
    ulp = 1.0 + 2.2e-16 * torch.tensor(
        np.random.default_rng(5).choice([-1.0, 1.0], size=tuple(d.shape)),
        device=d.device)
    plain = coupling._value_grad_plain(ifs, d, cp, h, E)

    def worst(a):
        return max(rel_err(x, y)[0] for x, y in zip(a, plain)
                   if x is not None)

    k = worst(coupling.penalty_value_grad(ifs, d, cp, h, E))
    u = worst(coupling._value_grad_plain(ifs, d * ulp, cp, h, E))
    say(f"[mi-kernel coupled-d] penalty_qp/value_grad kernel vs plain rel "
        f"{k:.3e}; plain vs plain at d moved by one ulp rel {u:.3e} "
        f"(not gated)")


def merge(checks, name, got, suffix=None):
    """Merge one checked case into `checks`: a kernel keeps the worst error
    over its cases and the times of its first case; a case with a suffix
    adds its times as <key>_<suffix>."""
    prev = checks.get(name)
    if prev is None:
        checks[name] = got
        return
    prev["rel"] = max(got["rel"], prev["rel"])
    prev["max_abs_err"] = max(got["max_abs_err"], prev["max_abs_err"])
    if suffix:
        prev.update({f"{k}_{suffix}": got[k]
                     for k in ("ms", "plain_ms", "bound_ms")})


def phase_mi_kernels(sys_, checks, reps=5, tube=False):
    """Check every MI case of `sys_` and merge it into `checks`. On the
    T-beam the MI path's case of K1-K4 adds its times as *_mi; on the tube
    (`tube`) those add *_tube_mi and K5-K7's own cases *_tube."""
    seam_conditioning(sys_)
    tag = "tube-mi-kernel" if tube else "mi-kernel"
    for key, case in mi_kernel_cases(sys_, edge=not tube).items():
        name = key[0]
        got = check_kernels({name: case}, tag + " " + "/".join(
            str(k) for k in key[1:]), reps)[name]
        suffix = None
        if key[1:] == ("mi",):
            suffix = "tube_mi" if tube else "mi"
        elif tube and key[1:] in ((), ("moved",)):
            suffix = "tube"
        merge(checks, name, got, suffix)
    return checks


def make_mi_iteration(sys_, dev):
    """bench_mi.py's opt_iteration on the port: returns (iteration,
    forward); iteration(amp, d0, xi_seed) -> (J, dJ/damp, d, xi, wall)."""
    from goldfish_tpu_torch.physics import kl_shell

    m = sys_.metas[1]
    gv = sys_.surfs[1].greville_points(1)
    bend = torch.tensor(np.tile(np.sin(np.pi * gv)[None, :],
                                (m.n_u, 1)).ravel(), device=dev)
    forward = sys_.build_forward(rtol=1e-9, max_it=30)
    h = sys_.h_init
    xi_start = sys_.c2x.xi0_flat

    def iteration(amp_v, d0, xi_seed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        amp = torch.tensor(amp_v, dtype=torch.float64, device=dev,
                           requires_grad=True)
        cp = sys_.cp.clone()
        cp[1, : m.n_cp, 0] = cp[1, : m.n_cp, 0] + amp * bend
        d, xi = forward(cp, h, d0, xi_seed)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        J.backward()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        J, g = float(J.detach()), float(amp.grad)
        d, xi = d.detach(), xi.detach()
        if not (np.isfinite(J) and np.isfinite(g)
                and bool(torch.isfinite(d).all())
                and bool(torch.isfinite(xi).all())
                and d.shape == sys_.cp.shape and xi.shape == xi_start.shape):
            raise RuntimeError("non-finite or misshapen MI iteration output")
        return J, g, d, xi, dt

    return iteration, forward


def phase_mi_main(sys_, dev):
    """bench_mi.py's iteration: cold at amp = 0.05, then 5 warm steps."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart

    with open(REF_MI) as fh:
        ref = json.load(fh)
    iteration, forward = make_mi_iteration(sys_, dev)
    fac = forward.solve_d.device_factor
    xi_start = sys_.c2x.xi0_flat
    _cuda.reset_launch_counts()
    J, g, d, xi, t_cold = iteration(0.05, sys_.zero_displacement(), None)
    eJ = abs(J - ref["J"]) / abs(ref["J"])
    eg = abs(g - ref["dJ_damp"]) / abs(ref["dJ_damp"])
    say(f"[mi] cold iteration {t_cold:.3f} s  J={J!r} (ref {ref['J']!r}, "
        f"rel {eJ:.2e})  dJ/damp={g!r} (ref {ref['dJ_damp']!r}, rel "
        f"{eg:.2e})  |d|={float(torch.linalg.norm(d))!r} (ref "
        f"{ref['d_norm']!r})  |xi-xi0|="
        f"{float(torch.linalg.norm(xi - xi_start))!r} (ref "
        f"{ref['xi_shift_norm']!r})  newton its "
        f"{forward.solve_d.solver.last_its}, xi-newton its "
        f"{sys_.c2x.last_its}")
    if not (eJ <= 1e-8 and eg <= 1e-6):
        raise RuntimeError(f"MI cold iteration disagrees with the JAX CPU "
                           f"reference: J rel {eJ:.2e}, dJ/damp rel "
                           f"{eg:.2e}")
    ws_d, ws_xi = SecantWarmStart(), SecantWarmStart()
    a0 = torch.tensor(0.05, dtype=torch.float64)
    ws_d.update(a0, d)
    ws_xi.update(a0, xi)
    warm = []
    for k in range(1, 6):
        amp = 0.05 * (1.0 + 1e-3 * k)
        ak = torch.tensor(amp, dtype=torch.float64)
        seed = ws_xi.predict(ak, xi).clamp(0.0, 1.0)
        J, g, d, xi, dt = iteration(amp, ws_d.predict(ak, d), seed)
        ws_d.update(ak, d)
        ws_xi.update(ak, xi)
        warm.append(dt)
        say(f"[mi] warm iteration {k}/5 {dt:.3f} s J={J!r} dJ/damp={g!r} "
            f"newton its {forward.solve_d.solver.last_its} xi-newton its "
            f"{sys_.c2x.last_its}")
    counts = dict(_cuda.launch_counts)
    say(f"[mi] warm median {float(np.median(warm)):.3f} s; n_factor "
        f"{fac.n_factor} (failed {fac.n_factor_failed}); seam subspace M "
        f"{fac._M}")
    say(f"[mi] refactor_log {fac.refactor_log}")
    say(f"[mi] cert_log tail {fac.cert_log[-16:]}")
    say(f"[mi] launch counts {counts}")
    missing = [k for k in MI_PATH_KERNELS if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the MI path: "
                           f"{missing}")
    return counts, fac


# ------------------------------------------------------------ tube
def tube_state(sys_, seed=6):
    """A seeded state of a pressurized tube on the card: (cp, h, d, lam, v)
    with d the linear response to the pressure plus seeded noise (1e-3 of
    its largest entry) on free dofs, lam and v random."""
    from goldfish_tpu_torch.solver import system

    data = sys_.data
    dev = sys_.cp.device
    rng = np.random.default_rng(seed)
    cp, h = sys_.cp, sys_.h_init
    zero = torch.zeros_like(cp)
    K0 = system.assemble_K(data, zero, cp, h)
    r0 = system.residual(data, zero, cp, h)
    d = torch.linalg.solve(K0, -r0.reshape(-1)).reshape(cp.shape)
    del K0
    T = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    d = d + T(1e-3 * float(d.abs().max())
              * rng.normal(size=tuple(cp.shape))) * data.free
    lam = T(rng.normal(size=tuple(cp.shape))) * data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    return cp, h, d, lam, v


def time_library(tag, fac, c2x=None, reps=3):
    """The library calls of a path at its size, with CUDA events: potrf
    (`cholesky_ex` of the equilibrated K at the factor's reference state),
    one-RHS `cholesky_solve`, and on an MI path the Woodbury capacitance
    `linalg.solve` (M x M, M right-hand sides) and the batched xi
    `linalg.solve` (I systems of 4N). Bounds: potrf N^3/3 and LU 2M^3/3 +
    2M^3 (M right-hand sides) f64 operations over the f64 tensor-core rate;
    the substitution two passes over the factor, N^2 8 bytes each, over the
    memory rate; the xi solves the larger of their operations and bytes."""
    K = fac._assemble(fac._ref)
    dsc = torch.rsqrt(K.diagonal().abs() + 1e-300)
    K.mul_(dsc[:, None]).mul_(dsc[None, :])
    N = K.shape[0]
    L, info = torch.linalg.cholesky_ex(K)
    rows = [dict(name="cholesky_ex", path=tag, n=N, info=int(info),
                 ms=cuda_ms(lambda: torch.linalg.cholesky_ex(K), reps),
                 bound_ms=N ** 3 / 3 / PEAK_F64_TC * 1e3,
                 bound_by="operations")]
    del K
    b = torch.randn(N, 1, dtype=torch.float64, device=L.device)
    rows.append(dict(name="cholesky_solve", path=tag, n=N,
                     ms=cuda_ms(lambda: torch.cholesky_solve(b, L), 10),
                     bound_ms=2 * N * N * 8 / PEAK_BYTES * 1e3,
                     bound_by="bytes"))
    del L
    M = getattr(fac, "_M", None)
    if M:
        g = torch.Generator(device="cpu").manual_seed(7)
        Cm = (torch.eye(M, dtype=torch.float64) + 0.01 * torch.randn(
            M, M, dtype=torch.float64, generator=g) / M ** 0.5).to(b.device)
        B = torch.randn(M, M, dtype=torch.float64, generator=g).to(b.device)
        rows.append(dict(name="capacitance linalg.solve", path=tag, n=M,
                         ms=cuda_ms(lambda: torch.linalg.solve(Cm, B), reps),
                         bound_ms=(2 * M ** 3 / 3 + 2 * M ** 3) / PEAK_F64_TC
                         * 1e3, bound_by="operations"))
    if c2x is not None:
        from goldfish_tpu_torch.geometry import cpiga2xi

        r, J = cpiga2xi.c2x_res_jac(c2x.ss, c2x.p, c2x.q, c2x.mi, fac._ref[0],
                                    c2x.xi0_flat)
        I_, n = J.shape[0], J.shape[-1]
        bb, by = bound(I_ * (n * n + 2 * n) * 8,
                       I_ * (2 * n ** 3 / 3 + 2 * n * n))
        rows.append(dict(name="xi batched linalg.solve", path=tag,
                         n=f"{I_}x{n}",
                         ms=cuda_ms(lambda: torch.linalg.solve(
                             J, -r[..., None]), 10),
                         bound_ms=bb, bound_by=by))
    for row in rows:
        say(f"[library] {json.dumps(row)}")
    return rows


def cold_gradient(obj, name, x0, sys_, dev):
    """J and dJ/dx of a demo objective at x0 from d = 0 (one host-timed
    evaluation ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = torch.tensor(x0, dtype=torch.float64, device=dev, requires_grad=True)
    J, d = obj({name: x}, sys_.zero_displacement())
    J.backward()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    J, g = float(J.detach()), x.grad.detach().cpu()
    if not (np.isfinite(J) and bool(torch.isfinite(g).all())
            and bool(torch.isfinite(d).all()) and g.shape == x.shape):
        raise RuntimeError("non-finite or misshapen tube evaluation")
    return J, g, dt


def check_cold(tag, J, g, dt, ref):
    eJ = abs(J - ref["J"]) / abs(ref["J"])
    eg = rel_err(g, torch.tensor(ref["dJ_dp"], dtype=torch.float64))[0]
    say(f"[{tag}] cold evaluation {dt:.3f} s  J={J!r} (ref {ref['J']!r}, "
        f"rel {eJ:.2e})  |dJ/dp| rel {eg:.2e}")
    if not (eJ <= 1e-8 and eg <= 1e-6):
        raise RuntimeError(f"{tag} cold evaluation disagrees with the JAX "
                           f"CPU reference: J rel {eJ:.2e}, grad rel "
                           f"{eg:.2e}")


def report_slsqp(tag, prob, res, fac, J_start, A_pin, p0, x):
    """Print the SLSQP run; raise unless it lowered J and held the pin."""
    wf, wj = prob.eval_wall["fun"], prob.eval_wall["jac"]
    pin = float(np.abs(A_pin @ x - A_pin @ p0).max())
    say(f"[{tag}] slsqp nit {res.nit} nfev {res.nfev} njev {res.njev} "
        f"J per iteration {res.history} final {res.fun!r} (start "
        f"{J_start!r}); {res.message}")
    say(f"[{tag}] wall per fun median {float(np.median(wf)):.3f} s "
        f"(n {len(wf)}, max {max(wf):.3f}); per jac median "
        f"{float(np.median(wj)):.3f} s (n {len(wj)}, max {max(wj):.3f})")
    say(f"[{tag}] n_factor {fac.n_factor} (failed {fac.n_factor_failed}, "
        f"cholesky_ex info {fac.failed_info}); refactor_log "
        f"{fac.refactor_log}")
    say(f"[{tag}] pin residual {pin:.3e}")
    if not (np.isfinite(res.fun) and res.fun < J_start and res.nit >= 1
            and pin <= 1e-10):
        raise RuntimeError(f"{tag}: SLSQP did not lower J ({res.fun!r} vs "
                           f"{J_start!r}) or broke the pin ({pin:.3e})")


def check_counts(tag, counts, needed):
    say(f"[{tag}] launch counts {counts}")
    missing = [k for k in needed if counts[k] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {tag} path: "
                           f"{missing}")


def phase_tube_fixed(dev, checks, ref):
    """K8 and K1-K4 at the fixed-seam tube's shapes, then its optimization:
    cold J and dJ/dp at p0, then run_slsqp(maxiter=3)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import tube_shape_opt as demo
    from goldfish_tpu_torch.physics import kl_shell

    t0 = time.perf_counter()
    ns = demo.setup(num_el=ref["num_el"], p=ref["p"], device=dev,
                    pressure=ref["pressure"])
    s = ns.sys
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] fixed-seam tube built in {time.perf_counter() - t0:.1f} s:"
        f" P={P} C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} ifs "
        f"{tuple(s.ifs.RA00.shape)} design {ns.p0.size}")
    cp, h, d, lam, v = tube_state(s)
    for name, got in check_kernels(pressure_cases(s.data, d, cp, lam),
                                   "tube-kernel").items():
        merge(checks, name, got)
    cases = fixed_cases(s.data, d, cp, h, lam, v)
    cases["shell_qp/geom_grad"] = (
        lambda: kl_shell.shell_geom_grad(s.stack, d, cp, h, s.E, s.nu),
        lambda: kl_shell._geom_grad_plain(s.stack, d, cp, h, s.E, s.nu),
        P * s.stack.R00.shape[1] * s.stack.R00.shape[2]
        * (2 * 15 * s.stack.R00.shape[3] * 2 + 16 * DENS_SHELL),
        list(s.stack) + [d, cp, h])
    for name, got in check_kernels(cases, "tube-kernel").items():
        merge(checks, name, got, "tube")
    del cp, h, d, lam, v, cases
    torch.cuda.empty_cache()

    fac = ns.solve.device_factor
    _cuda.reset_launch_counts()
    J0, g0, dt = cold_gradient(ns.obj, "p_xy", ns.p0, s, dev)
    check_cold("tube", J0, g0, dt, ref["fixed"])
    res = ns.prob.run_slsqp(maxiter=3, tol=1e-14)
    counts = dict(_cuda.launch_counts)
    x = res.x["p_xy"]
    report_slsqp("tube", ns.prob, res, fac, J0, ns.P, ns.p0, x)
    slack = float((ns.D @ x).min() - 1e-3)
    say(f"[tube] min regu slack {slack:.3e}; newton its of the last solve "
        f"{ns.solve.solver.last_its}")
    if slack < -1e-8:
        raise RuntimeError(f"tube: regu constraint broken ({slack:.3e})")
    check_counts("tube", counts, TUBE_KERNELS)
    return counts, fac


def phase_tube_mi(dev, checks, ref):
    """K5-K7 and K1-K4 at the moving-seam tube's shapes, then its
    optimization: cold J and dJ/dp at p_start, then run_slsqp(maxiter=3)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as demo

    t0 = time.perf_counter()
    ns = demo.setup(num_el=ref["num_el"], p=ref["p"], device=dev,
                    pressure=ref["pressure"])
    s = ns.sys
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] moving-seam tube built in {time.perf_counter() - t0:.1f} "
        f"s: P={P} C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} "
        f"seams (I, N)=({s.mi.n_int}, {s.mi.n_max}) degree "
        f"({s.pdeg}, {s.qdeg}) design {ns.p0.size}")
    phase_mi_kernels(s, checks, tube=True)
    torch.cuda.empty_cache()

    fac = ns.forward.solve_d.device_factor
    _cuda.reset_launch_counts()
    J0, g0, dt = cold_gradient(ns.obj, "p_ffd", ns.p_start, s, dev)
    check_cold("tube-mi", J0, g0, dt, ref["mi"])
    say(f"[tube-mi] xi-newton its {s.c2x.last_its}; seam subspace M "
        f"{fac._M}")
    res = ns.prob.run_slsqp(maxiter=3, tol=1e-12)
    counts = dict(_cuda.launch_counts)
    report_slsqp("tube-mi", ns.prob, res, fac, J0, ns.A_pin2, ns.p0,
                 res.x["p_ffd"])
    say(f"[tube-mi] xi-newton its of the last solve {s.c2x.last_its}; "
        f"seam subspace M {fac._M}; newton its "
        f"{ns.forward.solve_d.solver.last_its}")
    check_counts("tube-mi", counts, TUBE_MI_KERNELS)
    return counts, fac, s.c2x


# ------------------------------------------------------------ plate
def stress_cases(st, E, nu, d, cp, h, gbar, through):
    """K9 in both modes at one fiber: name -> (kernel fn, plain fn, flops,
    inputs)."""
    from goldfish_tpu_torch.physics import kl_shell

    z = kl_shell.ZETA[through]
    P, Ne, Q, L = st.R00.shape
    nqp = P * Ne * Q
    jets = 2 * 15 * L * 2 + 2 * L          # X, z jets + h per qp
    ins = [st.R00, st.R10, st.R01, st.R20, st.R11, st.R02, st.conn, d, cp,
           h, E, nu]
    # the VJP: two dual passes of 16 and 15 directions (~(k + 1) x the
    # value's operations each) and the scatter of 31 jet cotangents
    return {
        "vm_stress_qp/value": (
            lambda: kl_shell.vm_stress_value(st, d, cp, h, E, nu, z),
            lambda: kl_shell._stress_plain(st, d, cp, h, E, nu, z),
            nqp * (jets + DENS_VM), ins),
        "vm_stress_qp/vjp": (
            lambda: kl_shell.vm_stress_vjp(st, d, cp, h, E, nu, z, gbar),
            lambda: kl_shell._stress_vjp_plain(st, d, cp, h, E, nu, z, gbar),
            nqp * (jets + 33 * DENS_VM + 62 * L), ins + [gbar]),
    }


def phase_plate_kernels(s, checks, seed=8):
    """K9 (top, then bottom) and K1-K4 at the plate's shapes, at d = the
    Newton solution plus seeded noise (1e-3 of its largest entry)."""
    from goldfish_tpu_torch.physics import kl_shell

    dev = s.cp.device
    rng = np.random.default_rng(seed)
    T = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    cp, h = s.cp, s.h_init
    t0 = time.perf_counter()
    d = s.solve_nonlinear(rtol=1e-10)
    torch.cuda.synchronize()
    real = s.stack.wq > 0
    lo = {th: float(kl_shell.qp_stress_vm(s.stack, d, cp, h, s.E, s.nu,
                                          through=th)[real].min())
          for th in ("top", "bottom")}
    say(f"[plate-kernel] Newton solve {time.perf_counter() - t0:.2f} s; "
        f"smallest sigma of a real qp at the solution: top {lo['top']!r} "
        f"bottom {lo['bottom']!r}")
    if not min(lo.values()) > 0.0:
        raise RuntimeError("a real qp of the plate has sigma = 0 (no "
                           "derivative there)")
    dn = d + T(1e-3 * float(d.abs().max())
               * rng.normal(size=tuple(cp.shape))) * s.data.free
    gbar = T(rng.normal(size=tuple(s.stack.wq.shape)))
    for th in ("top", "bottom"):
        got = check_kernels(stress_cases(s.stack, s.E, s.nu, dn, cp, h, gbar,
                                         th), f"plate-kernel {th}",
                            tol=STRESS_TOL)
        for name, g in got.items():
            merge(checks, name, g)
    lam = T(rng.normal(size=tuple(cp.shape))) * s.data.free
    v = T(rng.normal(size=tuple(cp.shape)))
    for name, got in check_kernels(fixed_cases(s.data, dn, cp, h, lam, v),
                                   "plate-kernel").items():
        merge(checks, name, got, "plate")


def check_rel(tag, what, got, ref, tol):
    e = rel_err(torch.as_tensor(np.asarray(got, dtype=np.float64)),
                torch.as_tensor(np.asarray(ref, dtype=np.float64)))[0]
    say(f"[{tag}] {what} rel {e:.3e} (gate {tol:g})")
    if not e <= tol:
        raise RuntimeError(f"{tag}: {what} disagrees with the JAX CPU "
                           f"reference: rel {e:.3e} > {tol:g}")


def phase_plate(dev, checks, ref):
    """The plate kernels, then the stress demo through its OpenMDAO graph:
    cold run_model and totals against the reference, then run_driver."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo
    from goldfish_tpu_torch.operations.exops import MaxvMStressExOperation

    t0 = time.perf_counter()
    prob, s, th, sigma_allow, sigma0 = demo.build_problem(
        num_el=ref["num_el"], maxiter=ref["maxiter"], device=dev)
    P, C = s.stack.n_patches, s.stack.max_cp
    say(f"[setup] plate built in {time.perf_counter() - t0:.1f} s: P={P} "
        f"C={C} N={P * C * 3} stack {tuple(s.stack.R00.shape)} ifs "
        f"{tuple(s.ifs.RA00.shape)} design {th.n_ffd}; sigma0 {sigma0!r} "
        f"(ref {ref['sigma0']!r}) sigma_allow {sigma_allow!r}")
    check_rel("plate", "sigma0", sigma0, ref["sigma0"], 1e-8)
    phase_plate_kernels(s, checks)
    torch.cuda.empty_cache()

    op = prob.model._subs["disp_states_comp"].op
    fac = op.factor
    comp = prob.model._subs["max_vmstress_comp"]
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.run_model()
    t_cold = time.perf_counter() - t0
    say(f"[plate] cold run_model {t_cold:.3f} s: KS stress "
        f"{float(prob[demo.SIG][0])!r} (ref {ref['sigma_ks']!r}) volume "
        f"{float(prob[demo.VOL][0])!r} (ref {ref['volume']!r}); newton its "
        f"{op.solver.last_its}")
    check_rel("plate", "KS stress (rho 100)", prob[demo.SIG], ref["sigma_ks"],
              1e-8)
    check_rel("plate", "volume", prob[demo.VOL], ref["volume"], 1e-8)
    t0 = time.perf_counter()
    tot = prob.compute_totals([demo.VOL], [demo.FFD])
    check_rel("plate", f"dvolume/dh_ffd ({time.perf_counter() - t0:.3f} s)",
              tot[(demo.VOL, demo.FFD)].ravel(), ref["dvolume_dh_ffd"], 1e-6)
    op100 = comp.op
    comp.op = MaxvMStressExOperation(s, rho=ref["rho_grad"], through="top")
    prob.run_model()
    check_rel("plate", "KS stress (rho 50/m)", prob[demo.SIG],
              ref["sigma_ks_rho_grad"], 1e-8)
    t0 = time.perf_counter()
    tot = prob.compute_totals([demo.SIG], [demo.FFD])
    check_rel("plate", f"dsigma_KS/dh_ffd at rho 50/m "
              f"({time.perf_counter() - t0:.3f} s)",
              tot[(demo.SIG, demo.FFD)].ravel(), ref["dsigma_dh_ffd"], 1e-6)
    comp.op = op100

    t0 = time.perf_counter()
    out = demo.run(prob)
    wall = time.perf_counter() - t0
    counts = dict(_cuda.launch_counts)
    res, log = out.result, out.log
    say(f"[plate] slsqp {wall:.2f} s: nit {res.nit} nfev {res.nfev} njev "
        f"{res.njev}; {res.message}")
    say(f"[plate] (volume, KS stress) per model evaluation "
        f"{log.evaluations}")
    say(f"[plate] volume {out.V0!r} -> {out.V1!r}; KS stress {out.s1!r} "
        f"(allowable {sigma_allow!r}); reference end volume "
        f"{ref['slsqp']['volume_end']!r} stress {ref['slsqp']['sigma_end']!r}"
        f" (nit {ref['slsqp']['nit']} nfev {ref['slsqp']['nfev']} njev "
        f"{ref['slsqp']['njev']})")
    say(f"[plate] wall per fun median {float(np.median(log.fun_wall)):.3f} s "
        f"(n {len(log.fun_wall)}, max {max(log.fun_wall):.3f}); per jac "
        f"median {float(np.median(log.jac_wall)):.3f} s (n "
        f"{len(log.jac_wall)}, max {max(log.jac_wall):.3f})")
    say(f"[plate] n_factor {fac.n_factor} (failed {fac.n_factor_failed}, "
        f"cholesky_ex info {fac.failed_info}); refactor_log "
        f"{fac.refactor_log}")
    held = {"lighter": out.V1 < out.V0,
            "stress_le_1.02_allow": out.s1 <= 1.02 * sigma_allow,
            "stress_ge_0.95_allow": out.s1 >= 0.95 * sigma_allow}
    need = {k for k, v in ref["slsqp"]["assertions"].items() if v}
    need.add("lighter")
    say(f"[plate] demo assertions {held}; the reference meets {need}")
    missed = [k for k in need if not held[k]]
    if missed or not np.isfinite(out.s1):
        raise RuntimeError(f"plate SLSQP misses {missed} (the reference "
                           f"meets them)")
    check_counts("plate", counts, PLATE_KERNELS)
    return counts, fac


def phase_plate_sibling(dev, ref):
    """The sibling demo (minimum W_int at constant volume) at the plate's
    size: cold run_model and compute_totals against the reference."""
    from goldfish_tpu_torch.demos import om_plate_var_th_opt_wint as demo

    prob, s, th = demo.build_problem(num_el=ref["num_el"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prob.run_model()
    t_cold = time.perf_counter() - t0
    w = "int_energy_comp.w_int"
    vol = "volume_comp.volume"
    ffd = "inputs_comp.thickness_FFD"
    say(f"[plate-sibling] cold run_model {t_cold:.3f} s: w_int "
        f"{float(prob[w][0])!r} (ref {ref['w_int']!r})")
    check_rel("plate-sibling", "w_int", prob[w], ref["w_int"], 1e-8)
    t0 = time.perf_counter()
    tot = prob.compute_totals([w, vol], [ffd])
    dt = time.perf_counter() - t0
    check_rel("plate-sibling", f"dw_int/dh_ffd ({dt:.3f} s)",
              tot[(w, ffd)].ravel(), ref["dw_int_dh_ffd"], 1e-6)
    check_rel("plate-sibling", "dvolume/dh_ffd", tot[(vol, ffd)].ravel(),
              ref["dvolume_dh_ffd"], 1e-6)


def main():
    t_start = time.perf_counter()
    dev = phase_device()
    phase_build()
    from goldfish_tpu_torch.models import tbeam, wing

    with open(REF_TUBE) as fh:
        ref_tube = json.load(fh)
    t0 = time.perf_counter()
    sys_ = wing.build(num_el=6, p=3, device=dev)
    P, C = sys_.stack.n_patches, sys_.stack.max_cp
    say(f"[setup] wing20 built in {time.perf_counter() - t0:.1f} s: "
        f"P={P} C={C} N={P * C * 3} stack {tuple(sys_.stack.R00.shape)} "
        f"ifs {tuple(sys_.ifs.RA00.shape)}")
    checks = phase_kernels(sys_)
    counts, fac = phase_main_path(sys_, dev)
    library = time_library("wing20", fac)
    del sys_, fac
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mi_sys = tbeam.build_mi(num_el=40, p=3, n_pts=17, device=dev)
    P, C = mi_sys.stack.n_patches, mi_sys.stack.max_cp
    say(f"[setup] MI T-beam built in {time.perf_counter() - t0:.1f} s: "
        f"P={P} C={C} N={P * C * 3} stack {tuple(mi_sys.stack.R00.shape)} "
        f"seam (I, N)=({mi_sys.mi.n_int}, {mi_sys.mi.n_max})")
    phase_mi_kernels(mi_sys, checks)
    counts_mi, fac = phase_mi_main(mi_sys, dev)
    library += time_library("mi_tbeam40", fac, mi_sys.c2x)
    del mi_sys, fac
    torch.cuda.empty_cache()

    counts_tf, fac = phase_tube_fixed(dev, checks, ref_tube)
    library += time_library("tube16", fac)
    del fac
    torch.cuda.empty_cache()
    counts_tm, fac, c2x = phase_tube_mi(dev, checks, ref_tube)
    library += time_library("tube16_mi", fac, c2x)
    del fac, c2x
    torch.cuda.empty_cache()

    with open(REF_PLATE) as fh:
        ref_plate = json.load(fh)
    t0 = time.perf_counter()
    counts_pl, fac = phase_plate(dev, checks, ref_plate)
    library += time_library("plate32", fac)
    del fac
    torch.cuda.empty_cache()
    phase_plate_sibling(dev, ref_plate["sibling"])
    say(f"[plate] phases 10-11 {time.perf_counter() - t0:.1f} s; script so "
        f"far {time.perf_counter() - t_start:.1f} s")

    paths = {"wing": (counts, WING_KERNELS), "mi": (counts_mi, None),
             "tube": (counts_tf, None), "tube_mi": (counts_tm, None),
             "plate": (counts_pl, None)}
    record = {"kernels": []}
    for name, src, rep in KERNELS:
        per = {f"launches_{p}": (c.get(name, 0) if keep is None
                                 or name in keep else 0)
               for p, (c, keep) in paths.items()}
        record["kernels"].append(
            {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": sum(per.values()), **per,
             "max_abs_err": checks[name]["max_abs_err"],
             "ms": checks[name]["ms"], "plain_ms": checks[name]["plain_ms"],
             "bound_ms": checks[name]["bound_ms"],
             "bound_by": checks[name]["bound_by"], "library_ms": None,
             **{k: v for k, v in checks[name].items()
                if k.startswith(("ms_", "plain_ms_", "bound_ms_"))}})
    say(json.dumps({"library": library}))
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
