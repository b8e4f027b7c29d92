"""Reference numbers for the PyTorch port's CAD-path demos (the trimmed
plate with a hole, the variable-thickness plate, the eVTOL wing through
IGES and the preprocessor, the curved moving-seam T-beam, the CADDEE
aeroelastic wing).

Runs the JAX package's demos on the CPU in float64, direct linear-solver
mode, and writes tests/data/torch_port_cad_reference.json. For every demo
and size: "start", the scaled objective J and its gradient at the start
design (the demo's OptProblem callables at x0, before any SLSQP step),
and "run", the demo's `main` (SLSQP history, end J, design, nit/nfev/njev
and the demo's own figures). Sizes: "*_small" the JAX tests' reduced runs
(tests/test_demos.py), "*_card" each demo's defaults, which
`chip_smoke.py` runs on the card.

The preprocessor's surface evaluations and closest-point projections go
through the JAX package's own C++ geometry kernel
(goldfish_tpu/geometry/native.py) when it builds: the NumPy path gives the
same intersections to 1e-15 and takes minutes a wing.

The machine with the GPU has no JAX, so `chip_smoke.py` and
tests/test_torch_cad_demos.py check the port against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_cad_reference.py
        [--only plate_hole_small plate_hole_card plate_small plate_card
                evtol_small evtol_card curved_small curved_card
                caddee_small caddee_card]
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_cad_reference.json")

SIZES = {
    "plate_hole_small": dict(num_el=4, maxiter=5),
    "plate_hole_card": dict(num_el=8, maxiter=20),
    "plate_small": dict(num_el=3, maxiter=6),
    "plate_card": dict(num_el=4, maxiter=30),
    "evtol_small": dict(n_sections=2, num_el=2, p=2, maxiter=2),
    "evtol_card": dict(n_sections=3, num_el=3, p=3, maxiter=5),
    "curved_small": dict(num_el=3, p=2, maxiter=3),
    "curved_card": dict(num_el=4, p=3, maxiter=4),
    "caddee_small": dict(n_sections=2, num_el=2, p=2, n_fp=2),
    "caddee_card": dict(n_sections=3, num_el=3, p=3, n_fp=4),
}


def _l(a):
    return np.asarray(a, dtype=np.float64).tolist()


def _write(out):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


@contextlib.contextmanager
def _start_only(got):
    """OptProblem.run_slsqp replaced by one evaluation of the objective
    and its gradient at x0 (recorded in `got`); the demo then goes on from
    x0 as if SLSQP had stopped there."""
    import jax.numpy as jnp

    from goldfish_tpu.opt import problem

    orig = problem.OptProblem.run_slsqp

    def start(self, maxiter=100, tol=1e-9, verbose=False):
        fun, jac, _ = self._build_callables()
        x0 = self._x0()
        g = jac(x0)
        J = fun(x0)
        got.update(J=float(J), grad=_l(g), x0=_l(x0))
        xdict = {k: np.asarray(v)
                 for k, v in self._unflatten(jnp.asarray(x0)).items()}
        return problem.OptResult(x=xdict, fun=J / self._obj_scaler, nit=0,
                                 success=True, message="start",
                                 history=[J])

    problem.OptProblem.run_slsqp = start
    try:
        yield
    finally:
        problem.OptProblem.run_slsqp = orig


@contextlib.contextmanager
def _native_geometry():
    """The preprocessor's evaluations through the JAX package's native
    kernel (same results, minutes faster)."""
    from goldfish_tpu.geometry import native, preprocessing

    if not native.available():
        yield False
        return
    ev, cpp = preprocessing._eval_many, preprocessing.closest_point_projection

    def eval_many(surf, uv, nd=1):
        return native.surface_eval(surf, uv, nd=nd)

    def closest(surf, X, uv0=None, max_it=30, tol=1e-12):
        if uv0 is not None:
            return cpp(surf, X, uv0, max_it, tol)
        return native.closest_point(surf, X, max_it=max_it, tol=tol)

    preprocessing._eval_many = eval_many
    preprocessing.closest_point_projection = closest
    try:
        yield True
    finally:
        preprocessing._eval_many = ev
        preprocessing.closest_point_projection = cpp


def _res(res):
    return dict(history=[float(v) for v in res.history], fun=float(res.fun),
                nit=int(res.nit), nfev=int(res.nfev), njev=int(res.njev),
                x={k: _l(v) for k, v in res.x.items()})


def _opt_part(run, kw):
    """start + run of a demo whose `run(**kw)` returns (res, extra)."""
    got = {}
    with _start_only(got):
        run(**kw)
    t0 = time.perf_counter()
    res, extra = run(**kw)
    return dict(kw=kw, start=got,
                run=dict(_res(res), seconds=time.perf_counter() - t0,
                         **extra))


def plate_hole(kw):
    from demos.plate_hole_thickness_opt import main

    def run(num_el, maxiter):
        res, _, _, (near, far) = main(num_el=num_el, maxiter=maxiter,
                                      results="", verbose=False)
        return res, dict(near=near, far=far)

    return _opt_part(run, kw)


def plate(kw):
    from demos.thickness_opt_plate import main

    def run(num_el, maxiter):
        with tempfile.TemporaryDirectory() as d:
            res, _, _ = main(num_el=num_el, maxiter=maxiter, results=d,
                             verbose=False)
        return res, {}

    return _opt_part(run, kw)


def evtol(kw):
    from demos.evtol_wing_shopt import main

    def run(n_sections, num_el, p, maxiter):
        with tempfile.TemporaryDirectory() as d:
            tempfile.tempdir = d
            try:
                res, _, _, _ = main(n_sections=n_sections, num_el=num_el,
                                    p=p, maxiter=maxiter, verbose=False)
            finally:
                tempfile.tempdir = None
        return res, {}

    return _opt_part(run, kw)


def curved(kw):
    from demos.shape_opt_mint_tbeam_curved import main

    def run(num_el, p, maxiter):
        res, sys_ = main(num_el=num_el, p=p, maxiter=maxiter, verbose=False)
        return res, {}

    return _opt_part(run, kw)


def caddee(kw):
    from demos.caddee_aeroelastic_wing import main

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        tempfile.tempdir = d
        try:
            J0, tip, gh, model = main(verbose=False, **kw)
        finally:
            tempfile.tempdir = None
    pre = model.preprocessor
    return dict(kw=kw, J0=float(J0), tip=_l(tip), gh=_l(gh),
                gh_norm=float(np.linalg.norm(np.asarray(gh))),
                num_intersections=int(pre.num_intersections),
                seconds=time.perf_counter() - t0)


PARTS = {name: (fn, SIZES[name]) for name, fn in (
    ("plate_hole_small", plate_hole), ("plate_hole_card", plate_hole),
    ("plate_small", plate), ("plate_card", plate),
    ("evtol_small", evtol), ("evtol_card", evtol),
    ("curved_small", curved), ("curved_card", curved),
    ("caddee_small", caddee), ("caddee_card", caddee))}


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    sys.path.insert(0, ROOT)
    from goldfish_tpu.solver import linalg

    only = [a for a in sys.argv[sys.argv.index("--only") + 1:]
            if a in PARTS] if "--only" in sys.argv else list(PARTS)
    if os.path.exists(OUT):
        with open(OUT) as fh:
            out = json.load(fh)
    else:
        out = {}
    out.update(solver_mode="direct", platform="cpu", dtype="float64",
               jax_version=jax.__version__)
    try:
        out["commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out["commit"] = None

    linalg.set_mode("direct")
    try:
        with _native_geometry() as nat:
            out["native_geometry"] = nat
            for name in PARTS:
                if name not in only:
                    continue
                fn, kw = PARTS[name]
                t0 = time.perf_counter()
                part = fn(dict(kw))
                part["part_seconds"] = time.perf_counter() - t0
                out[name] = part
                print(f"{name}: {part['part_seconds']:.1f} s", flush=True)
                _write(out)
    finally:
        linalg.set_mode(None)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
