"""K1's Hessian mode and K4 at the wing20 main path's shapes, on the GPU.

Times K1 `shell_qp/hess` and K4 `jet_matvec` of one tree's
`goldfish_tpu_torch` on the 20-patch wing (wing.build(num_el=6, p=3), N =
6600, 17,920 shell qps, 992 interface qps) at chip_smoke.py phase 3's
seeded state, two ways: back to back (CUDA events around `--launches`
launches: the inputs may stay in the 50 MB L2) and cold (each launch after
writing a 256 MB scratch tensor outside the timed window: in the solver's
IR loop every K4 call follows a substitution that streams the 348 MB
factor, so its 48.8 MB of jets come from device memory). Each number is the
median of `--repeats` measurements. K4 is timed as chip_smoke.py times it
(y zeroed, then one launch per group: shell and interface) and per group.
Each kernel is also checked against its plain version, and the ptxas
registers and spill bytes of both kernels' entry functions are printed.
Where the tree's K4 source lets a build replace its table of compile-time
shapes, K4's C entry is also built with an empty table (into this
checkout's gitignored `goldfish_tpu_torch/_build/`), so that every group
runs the runtime-shape instantiation, and timed the same ways beside the
compiled one (`jet_matvec[runtime-shape]`).

`--root` names the tree whose package is imported and built (default this
checkout), so that two commits can be compared in one chip call: unpack
the parent with `git archive <commit> | tar -x -C scratch_chip/parent` and
run parent, change, change, parent.

    python scripts/torch_port_kernel_ab.py [--root DIR] [--repeats 5]
        [--launches 20]

The last line is one JSON object with every number.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    """This checkout's chip_smoke.py (its timers, bound and ptxas parser),
    whatever tree `--root` imports."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runtime_shape_matvec(root, cuda):
    """K4's C entry `gf_jet_matvec` of tree `root` built with an empty
    table of compile-time shapes, and nvcc's output (with its ptxas
    summary); (None, "") where the tree's source has no replaceable
    table."""
    src = os.path.join(root, "goldfish_tpu_torch", "csrc", "jet_matvec.cu")
    with open(src) as fh:
        if "#ifndef GF_MATVEC_SHAPES" not in fh.read():
            return None, ""
    out = os.path.join(ROOT, "goldfish_tpu_torch", "_build",
                       "k4_runtime_shape")
    os.makedirs(out, exist_ok=True)
    stub = os.path.join(out, "jet_matvec_runtime_shape.cu")
    with open(stub, "w") as fh:
        fh.write(f'#define GF_MATVEC_SHAPES(X)\n#include "{src}"\n')
    so = os.path.join(out, "libjet_matvec_runtime_shape.so")
    cmd = [cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
           "-shared", "-o", so, stub]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + (res.stdout + res.stderr)[-4000:])
    fn = ctypes.CDLL(so).gf_jet_matvec
    fn.argtypes = cuda._SIGNATURES["gf_jet_matvec"]
    fn.restype = ctypes.c_int
    return fn, res.stdout + res.stderr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs one GPU")
    sm = _smoke()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver import system

    if not os.path.abspath(_cuda.__file__).startswith(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not from {root}")
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    with open(_cuda.build_info["ptxas_log"]) as fh:
        spills = {k: v for k, v in sm.ptxas_spills(fh.read()).items()
                  if "shell_hess" in k or "jet_matvec" in k}
    for name, (regs, st, ld) in spills.items():
        print(f"[ptxas] {name}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B", flush=True)

    dev = torch.device("cuda", 0)
    s = wing.build(num_el=6, p=3, device=dev)
    data, st = s.data, s.stack
    rng = np.random.default_rng(0)
    cp, h = s.cp, s.h_init
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    T = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa
    d = T(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * data.free
    rng.normal(size=tuple(cp.shape))   # phase 3's lambda
    v = T(rng.normal(size=tuple(cp.shape)))
    tab = system.jet_tables(data)
    Hs = system.jet_hessians(data, d, cp, h)
    free, vf = tab.free, v.reshape(-1)
    N = free.shape[0]
    groups = {"shell": (Hs[0], tab.R_e, tab.gi_e),
              "interface": (Hs[1], tab.R_i, tab.gi_i)}

    def matvec(fn):
        y = torch.zeros(N, dtype=torch.float64, device=dev)
        for H, R, gi in groups.values():
            fn(y, H, R, gi, free, vf)
        return y

    y_group = torch.zeros(N, dtype=torch.float64, device=dev)
    cases = {
        "shell_qp/hess": lambda: kl_shell.shell_hessians(
            st, d, cp, h, data.E, data.nu),
        "jet_matvec": lambda: matvec(system.jet_matvec),
        **{f"jet_matvec/{g}": (lambda grp=grp: system.jet_matvec(
            y_group, *grp, free, vf)) for g, grp in groups.items()},
    }
    err = {
        "shell_qp/hess": sm.rel_err(
            cases["shell_qp/hess"](),
            kl_shell._hessians_plain(st, d, cp, h, data.E, data.nu))[0],
        "jet_matvec": sm.rel_err(matvec(system.jet_matvec),
                                 matvec(system._matvec_plain))[0],
    }
    rt, rt_log = runtime_shape_matvec(root, _cuda)
    if rt is not None:
        for name, (regs, st_, ld) in sm.ptxas_spills(rt_log).items():
            print(f"[ptxas runtime-shape build] {name}: {regs} registers, "
                  f"spill stores {st_} B, spill loads {ld} B", flush=True)

        def matvec_rt(y, H, R, gi, free_, v_):
            G, nq, nj, nloc = R.shape
            p = _cuda.ptr
            rc = rt(p(H), p(R), p(gi), p(free_), p(v_), p(y), G, nq, nj,
                    nloc, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"runtime-shape K4: cudaError_t {rc}")
            return y

        cases["jet_matvec[runtime-shape]"] = lambda: matvec(matvec_rt)
        cases.update({f"jet_matvec[runtime-shape]/{g}": (
            lambda grp=grp: matvec_rt(y_group, *grp, free, vf))
            for g, grp in groups.items()})
        err["jet_matvec[runtime-shape]"] = sm.rel_err(
            matvec(matvec_rt), matvec(system._matvec_plain))[0]
    out = {"card": card, "root": root, "build_s": build_s,
           "ptxas": {k: list(v) for k, v in spills.items()},
           "rel_err": err, "bytes": {
               "shell_qp/hess": sm.nbytes(d, cp, h, *st, *Hs[:1]),
               "jet_matvec": sm.nbytes(*[u for g in groups.values()
                                         for u in g], free, vf, vf)}}
    if rt is not None:
        out["bytes"]["jet_matvec[runtime-shape]"] = out["bytes"]["jet_matvec"]
    for name, fn in cases.items():
        warm = [sm.cuda_ms(fn, args.launches) for _ in range(args.repeats)]
        cold = [sm.cuda_ms_cold(fn, args.launches)
                for _ in range(args.repeats)]
        out[name] = {"ms": float(np.median(warm)),
                     "ms_cold": float(np.median(cold)),
                     "ms_all": warm, "ms_cold_all": cold}
        print(f"[ab] {name:34s} back to back {out[name]['ms']:.4f} ms, "
              f"L2 flushed {out[name]['ms_cold']:.4f} ms", flush=True)
    for name, b in out["bytes"].items():
        print(f"[ab] {name:34s} bytes {b / 1e6:.1f} MB, byte bound "
              f"{b / sm.PEAK_BYTES * 1e3:.4f} ms; rel err vs plain "
              f"{err[name]:.2e}", flush=True)
        if not err[name] <= sm.KERNEL_TOL:
            raise RuntimeError(f"{name}: kernel vs plain {err[name]:.3e}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
