"""Build, load and launch the hand-written CUDA kernels of `csrc/`.

The kernels are compiled at first use with nvcc into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds
rather than minutes) and loaded with ctypes. Each source compiles in its
own nvcc process, all started together, then one link:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -Xptxas -v -c -o <src>.o csrc/<src>.cu   (each)
    nvcc ... -shared -o _build/libgoldfish_kernels_<hash>.so *.o

The build directory `goldfish_tpu_torch/_build/` is keyed by a hash of the
sources, so an edited source rebuilds. Nothing here runs at import time.

Every C entry returns a cudaError_t; `launch` raises on anything but 0 and
counts the launch under the wrapper's name in `launch_counts`, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

__all__ = ["library", "launch", "launch_counts", "reset_launch_counts",
           "check", "ptr", "on_cuda", "build_info", "COUNTERS"]

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

# kernel wrapper name -> launches since the last reset
COUNTERS = ("shell_qp/value_grad", "shell_qp/hess", "shell_qp/adjoint",
            "shell_qp/geom_grad", "shell_qp/design_fwd",
            "penalty_qp/value_grad", "penalty_qp/hess", "penalty_qp/adjoint",
            "penalty_qp/design_fwd",
            "jet_assemble", "jet_matvec",
            "traced_rows", "mi_penalty_xi", "mi_penalty_xi/xi_fwd",
            "c2x_res_jac/res_jac", "c2x_res_jac/adjoint",
            "c2x_res_jac/step", "c2x_res_jac/solve_adjoint",
            "c2x_res_jac/cp_fwd",
            "pressure_qp/value_grad", "pressure_qp/hess",
            "pressure_qp/adjoint",
            "vm_stress_qp/value", "vm_stress_qp/vjp", "vm_stress_qp/rows",
            "pair_assemble/pairs", "pair_assemble/patches",
            "vlm_aic/value", "vlm_aic/vjp",
            "contact_pairs/cull", "contact_pairs/value_grad",
            "contact_pairs/hvp", "contact_pairs/hess",
            "contact_pairs/design_fwd",
            "chol_subst/vec", "chol_subst/multi", "chol_subst/diag_inv",
            "chol_factor")
launch_counts: dict[str, int] = {k: 0 for k in COUNTERS}
_lib = None
build_info: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "gf_shell_qp": [_I] + [_P] * 18 + [_I] * 5 + [_P],
    "gf_penalty_qp": [_I] + [_P] * 24 + [_I] * 4 + [_P],
    "gf_jet_assemble": [_P] * 5 + [_I] * 4 + [ctypes.c_longlong, _P],
    "gf_jet_matvec": [_P] * 6 + [_I] * 4 + [_P],
    "gf_jet_matvec_variant": [_I] * 3,
    "gf_traced_rows": [_P] * 12 + [_I] * 8 + [_P],
    "gf_mi_penalty_xi": [_P] * 22 + [_I] * 9 + [_P],
    "gf_mi_penalty_xi_fwd": [_P] * 24 + [_I] * 9 + [_P],
    "gf_c2x_res_jac": [_I] + [_P] * 26 + [_I] * 10 + [_P],
    "gf_pressure_qp": [_I] + [_P] * 11 + [_I] * 5 + [_P],
    "gf_vm_stress_qp": [_I] + [_P] * 20 + [ctypes.c_double] + [_I] * 5 + [_P],
    "gf_patch_assemble": [_P] * 14 + [_I] * 10 + [_P],
    "gf_pair_assemble": [_P] * 13 + [_I] * 8 + [_P],
    "gf_vlm_aic": [_I] + [_P] * 11 + [_I] * 2 + [_P],
    "gf_contact_cull": [_P] * 9 + [_I] * 4 + [_P],
    "gf_contact_pairs": [_I] + [_P] * 18 + [_I] * 5 + [ctypes.c_longlong,
                                                       _P],
    "gf_chol_diag_inv": [_P] * 2 + [_I] * 2 + [_P],
    "gf_chol_subst": [_P] * 6 + [_I] * 2 + [_P],
    "gf_chol_subst_multi": [_P] * 8 + [_I] * 5 + [_P],
    "gf_chol_factor": [_P] * 4 + [ctypes.c_longlong, _P] + [_I] * 3 + [_P],
    "gf_chol_factor_scratch": [_I],
}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _nvcc():
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _compile(sources, so, log):
    """One nvcc per source, all started together, then one link into `so`;
    the ptxas log of every source goes to `log`."""
    nvcc = _nvcc()
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.d"
    os.makedirs(tmp, exist_ok=True)
    arch = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-Xcompiler", "-fPIC"]
    objs, procs = [], []
    for src in sources:
        obj = os.path.join(tmp, os.path.basename(src) + ".o")
        cmd = [nvcc, *arch, "-Xptxas", "-v", "-c", "-o", obj, src]
        objs.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    text, failed = [], []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        text.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        cmd = [nvcc, *arch, "-shared", "-o", so + ".tmp", *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        text.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append(res.stdout + res.stderr)
    with open(log, "w") as fh:
        fh.write("\n".join(text))
    shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed; log in {log}:\n"
                           + "\n".join(failed)[-4000:])
    os.replace(so + ".tmp", so)


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha256()
    for f in sources + headers:
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode() + fh.read())
    tag = h.hexdigest()[:16]
    so = os.path.join(_BUILD, f"libgoldfish_kernels_{tag}.so")
    log = os.path.join(_BUILD, f"ptxas_{tag}.txt")
    t0 = time.perf_counter()
    built = False
    if not os.path.exists(so):
        _compile(sources, so, log)
        built = True
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    build_info.update(path=so, ptxas_log=log, built=built,
                      seconds=time.perf_counter() - t0)
    _lib = lib
    return lib


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device):
    """Raise unless `t` is a tensor of `dtype` and `shape` (None = any) on
    `device`; on a CUDA device it must also be contiguous (the kernels
    index raw pointers)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.is_cuda and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def launch(counter: str, entry: str, *args):
    """Call C entry `entry` on the current stream; raise on a non-zero
    cudaError_t; count one launch under `counter`."""
    fn = getattr(library(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{entry} ({counter}) failed: cudaError_t {rc}")
    launch_counts[counter] += 1


def on_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of every kernel wrapper: True -> launch the kernel
    (or raise); False -> the plain PyTorch version, for CPU tensors only."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")
