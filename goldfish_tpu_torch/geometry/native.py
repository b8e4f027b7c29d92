"""ctypes bridge to the C++ geometry kernel (native/geometry_kernel.cpp).

Port of goldfish_tpu/geometry/native.py: batched NURBS surface evaluation
and closest-point projection on the host (the role OpenCASCADE plays in
the reference stack). Host code, not a device kernel: it is compiled at
first use with g++ into `goldfish_tpu_torch/_build/` (keyed by a hash of
the source), and where no compiler is found `available()` is False and
callers keep the NumPy path (`preprocessing._eval_many`,
`preprocessing.closest_point_projection`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

__all__ = ["available", "surface_eval", "closest_point"]

_LIB = None
_TRIED = False

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "geometry_kernel.cpp")
_BUILD = os.path.join(_PKG, "_build")


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(_BUILD, exist_ok=True)
    so = os.path.join(_BUILD, f"libgoldfish_geom_{tag}.so")
    if os.path.exists(so):
        return so
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC,
           "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.CalledProcessError,
            subprocess.TimeoutExpired):
        return None
    os.replace(tmp, so)
    return so


def _lib():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.gt_surface_eval.restype = ctypes.c_int
        lib.gt_surface_eval.argtypes = [
            dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            dp, ctypes.c_int, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int,
            dp]
        lib.gt_closest_point.restype = ctypes.c_int
        lib.gt_closest_point.argtypes = [
            dp, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            dp, ctypes.c_int, ctypes.c_int, dp, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, dp, dp]
        _LIB = lib
    return _LIB


def available() -> bool:
    return _lib() is not None


def _cptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _surf_args(surf):
    ku = np.ascontiguousarray(surf.knots[0], dtype=np.float64)
    kv = np.ascontiguousarray(surf.knots[1], dtype=np.float64)
    ctrl = np.ascontiguousarray(surf.control.reshape(-1, 4),
                                dtype=np.float64)
    p, q = surf.degree
    n_u, n_v = surf.shape
    return ku, kv, ctrl, p, q, n_u, n_v


def surface_eval(surf, pts, nd=2):
    """Batched rational surface evaluation: pts (m, 2) ->
    dict of (m, 3) arrays for keys up to total derivative order nd."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native geometry kernel is not available")
    ku, kv, ctrl, p, q, n_u, n_v = _surf_args(surf)
    pts = np.ascontiguousarray(pts, dtype=np.float64).reshape(-1, 2)
    m = pts.shape[0]
    stride = {0: 3, 1: 9, 2: 18}[nd]
    out = np.empty((m, stride))
    lib.gt_surface_eval(_cptr(ku), len(ku), _cptr(kv), len(kv), p, q,
                        _cptr(ctrl), n_u, n_v, _cptr(pts), m, nd,
                        _cptr(out))
    keys = [(0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2)][: stride // 3]
    return {k: out[:, 3 * i: 3 * i + 3] for i, k in enumerate(keys)}


def closest_point(surf, X, max_it=30, tol=1e-12):
    """Batched projected-Newton closest point: X (m, 3) -> (uv, dist)."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("the native geometry kernel is not available")
    ku, kv, ctrl, p, q, n_u, n_v = _surf_args(surf)
    X = np.ascontiguousarray(X, dtype=np.float64).reshape(-1, 3)
    m = X.shape[0]
    uv = np.empty((m, 2))
    dist = np.empty(m)
    lib.gt_closest_point(_cptr(ku), len(ku), _cptr(kv), len(kv), p, q,
                         _cptr(ctrl), n_u, n_v, _cptr(X), m, max_it,
                         tol, _cptr(uv), _cptr(dist))
    return uv, dist
