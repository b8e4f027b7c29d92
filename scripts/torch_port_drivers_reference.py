"""Reference numbers for the port's optimizer drivers, demos and CSDL graphs
(JAX package, CPU, float64).

Runs the JAX package's drivers and writes what the port's tests and
`chip_smoke.py` hold the port against to
tests/data/torch_port_drivers_reference.json (the machine with the GPU has
no JAX, and the JAX demos' own tests are slow-marked):

- `wing_small`, `wing_card`: demos/wing_thickness_opt.main at the JAX
  test's size (num_el=2, p=2, maxiter=3) and at its defaults (num_el=6,
  p=3) with maxiter=3: the start J and gradient (the SLSQP surface's, in
  the scaled design; with the displacement the start evaluation reached,
  `d_start`, where the run is recorded), the SLSQP history, end design and
  J;
- `tbeam_small`, `arch_small`, `mint_small`: the fixed-seam T-beam, the
  arch and the moving-seam T-beam demos at the JAX tests' sizes (start,
  run, end); `tbeam_card`, `arch_card`, `mint_card`: their starts at the
  demos' defaults;
- `aero_small`, `aero_card`: the strip-theory aeroelastic demo's J0, tip
  displacement and dJ/dh at the JAX test's size and at its defaults, with
  the fixed point's final state and each pass's stopping residual;
- `csdl_small`: the CSDL plate graph (num_el=2, p=2, 2 patches): w_int,
  vol, the totals of both in both modes, and `main(maxiter=10)`'s end;
  `csdl_card`: the same graph's start at num_el=32, p=2, 3 patches;
- `csdl_mi`: the MI graph of tests/test_csdl_adapters.py at its small
  size: w_int and d(w_int)/d(amp) in both modes;
- `entry`: `__graft_entry__.entry()`'s damped-Newton update at its example
  arguments and at the state that update gives, with K v at both.

    JAX_PLATFORMS=cpu python scripts/torch_port_drivers_reference.py
        [--only PART ...] [--out FILE] [--merge FILE ...]

`--out` writes the parts run to FILE instead (to run parts in parallel
processes); `--merge` folds such files into the JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_drivers_reference.json")
sys.path.insert(0, ROOT)


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    return jax


def _f(a):
    return np.asarray(a, dtype=np.float64).ravel().tolist()


class _Capture:
    """Patches OptProblem.run_slsqp to record, before the run, the start
    J and gradient of the SLSQP surface (scaled objective, scaled design)
    on a separate evaluation whose warm start is then reset, and after it
    the history and counters."""

    def __init__(self):
        from goldfish_tpu.opt.problem import OptProblem

        self.cls = OptProblem
        self.orig = OptProblem.run_slsqp
        self.rec = {}

    def __enter__(self):
        cap = self

        def run_slsqp(prob, *a, **kw):
            state0 = prob.state_box[0]
            fun, jac, _ = prob._build_callables()
            x0 = prob._x0()
            g = jac(x0)
            cap.rec.update(J_start=float(fun(x0)), g_start=_f(g),
                           x0=_f(x0))
            if state0 is not None:
                cap.rec["d_start"] = _f(prob.state_box[0])
            prob.state_box[0] = state0
            res = cap.orig(prob, *a, **kw)
            cap.rec.update(history=[float(v) for v in res.history],
                           nit=int(res.nit), nfev=int(res.nfev),
                           njev=int(res.njev), message=str(res.message))
            return res

        self.cls.run_slsqp = run_slsqp
        return self

    def __exit__(self, *exc):
        self.cls.run_slsqp = self.orig


def _start_only(prob):
    fun, jac, _ = prob._build_callables()
    x0 = prob._x0()
    g = jac(x0)
    return dict(J_start=float(fun(x0)), g_start=_f(g), x0=_f(x0))


class _StartOnly(Exception):
    pass


def _capture_start(run):
    """The start of the problem `run()` builds, without running it."""
    from goldfish_tpu.opt.problem import OptProblem

    orig, rec = OptProblem.run_slsqp, {}

    def stop(prob, *a, **kw):
        rec.update(_start_only(prob))
        raise _StartOnly()

    OptProblem.run_slsqp = stop
    try:
        run()
    except _StartOnly:
        pass
    finally:
        OptProblem.run_slsqp = orig
    return rec


def part_wing(num_el, p, maxiter):
    from demos import wing_thickness_opt

    with tempfile.TemporaryDirectory() as tmp, _Capture() as cap:
        res, sys_, th = wing_thickness_opt.main(
            num_el=num_el, p=p, maxiter=maxiter, results=tmp,
            verbose=False)
        files = sorted(os.listdir(tmp))
    return dict(cap.rec, x_end=_f(res.x["h_ffd"]), fun_end=float(res.fun),
                files=files, n_dofs=int(np.asarray(sys_.cp).size))


def part_tbeam(small):
    from demos import tbeam_shape_opt as m

    if not small:
        return _capture_start(lambda: m.main(verbose=False))
    with _Capture() as cap:
        res, J0, web_x, _, _ = m.main(num_el=3, p=2, maxiter=8, x_web=0.4,
                                      verbose=False)
    return dict(cap.rec, x_end=_f(res.x["p_x"]), fun_end=float(res.fun),
                J0=float(J0), web_x=float(web_x))


def part_arch(small):
    from demos import shape_opt_arch as m

    if not small:
        return _capture_start(lambda: m.main(verbose=False))
    with _Capture() as cap:
        res, J0, _, _ = m.main(num_el=3, p=2, num_patches=3, maxiter=10,
                               verbose=False)
    return dict(cap.rec, x_end=_f(res.x["p_z"]), fun_end=float(res.fun),
                J0=float(J0))


def part_mint(small):
    from demos import shape_opt_mint_tbeam as m

    if not small:
        return _capture_start(lambda: m.main(verbose=False))
    with _Capture() as cap:
        res, J0, _ = m.main(num_el=3, p=2, maxiter=5, verbose=False)
    return dict(cap.rec, x_end=_f(res.x["web_dx"]), fun_end=float(res.fun),
                J0=float(J0))


def part_aero(small):
    """main's J0, tip and dJ/dh; then the same fixed point again (main's
    loop, on main's own build_field_solve) for its final state `d` and the
    residual |r| each pass's solve stopped at (`r_pass`, at that pass's
    load; `r0_pass` the load's |r(0)|)."""
    import jax.numpy as jnp

    from demos.aeroelastic_wing import (
        build_field_solve,
        greville_dy_operator,
        main,
    )
    from goldfish_tpu.models import wing
    from goldfish_tpu.solver.system import residual

    kw = dict(num_el=2, p=2, n_chord=2, n_span=3, n_fp=3) if small else {}
    J0, tip, gh, sys_ = main(verbose=False, **kw)
    n_fp = kw.get("n_fp", 4)
    solve = build_field_solve(sys_)
    G = greville_dy_operator(sys_)
    cp, h = sys_.cp, sys_.h_init
    d = sys_.zero_displacement()
    r_pass, r0_pass = [], []
    for _ in range(n_fp):
        twist = jnp.einsum("pij,pj->pi", G, d[..., 2]) / wing.HALF_SPAN
        lift = 30.0 * 2.0 * jnp.pi * (0.08 - twist)
        f = jnp.zeros_like(d).at[..., 2].set(lift * sys_.stack.cp_mask)
        d = solve(cp, h, f, d)
        data_f = sys_.data._replace(f_field=f)
        r_pass.append(float(jnp.linalg.norm(residual(data_f, d, cp, h))))
        r0_pass.append(float(jnp.linalg.norm(
            residual(data_f, jnp.zeros_like(d), cp, h))))
    return dict(kw=kw, J0=float(J0), tip=_f(tip), dJ_dh=_f(gh),
                gh_shape=list(np.asarray(gh).shape), d=_f(d),
                r_pass=r_pass, r0_pass=r0_pass)


def _totals(rec_v, recorder):
    from goldfish_tpu import csdl_shim as csdl

    sim = csdl.experimental.PySimulator(recorder)
    out = {}
    for name in ("w_int", "vol"):
        of = rec_v[name]
        for mode in ("fwd", "rev"):
            J = sim.compute_totals([of], [rec_v["h_th_design"]], mode=mode)
            out[f"d{name}_{mode}"] = _f(J[of, rec_v["h_th_design"]])
    return out


def part_csdl(num_el, p, num_patches, run):
    from demos.csdl_plate_const_th_opt import build_recorder, main

    recorder, v, sys_ = build_recorder(num_el=num_el, p=p,
                                       num_patches=num_patches)
    out = dict(w_int=float(v["w_int"].value), vol=float(v["vol"].value),
               u_norm=float(np.linalg.norm(np.asarray(v["u"].value))),
               n_dofs=int(np.asarray(v["u"].value).size),
               **_totals(v, recorder))
    recorder.stop()
    if run:
        v2, _ = main(num_el=num_el, p=p, num_patches=num_patches,
                     maxiter=10, verbose=False)
        out.update(w_int_end=float(v2["w_int"].value),
                   vol_end=float(v2["vol"].value),
                   h_end=_f(v2["h_th_design"].value))
    return out


def part_csdl_mi():
    from goldfish_tpu import csdl_shim as csdl

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_csdl_adapters import _mi_graph

    rec, v, _ = _mi_graph()
    sim = csdl.experimental.PySimulator(rec)
    out = dict(amp=float(np.asarray(v["amp"].value)[0]),
               w_int=float(v["w_int"].value))
    for mode in ("fwd", "rev"):
        J = sim.compute_totals([v["w_int"]], [v["amp"]], mode=mode)
        out[f"dw_int_{mode}"] = _f(J[v["w_int"], v["amp"]])
    return out


def part_entry():
    """The update at the example arguments (d = 0) and at the state it
    gives (a second Newton update from a physical state: seeded noise
    makes the thin wing's K indefinite), with K v for a seeded v at both
    states (the update's operator, well conditioned to compare)."""
    import __graft_entry__ as g
    from goldfish_tpu.solver.system import assemble_K

    fn, args = g.entry()
    data, cp, h, d = args
    out = {"shape": list(np.asarray(cp).shape)}
    v = np.random.default_rng(0).normal(size=np.asarray(cp).shape)
    for tag in ("zero", "step1"):
        d_new, rn = fn(data, cp, h, d)
        K = np.asarray(assemble_K(data, d, cp, h))
        out[tag] = dict(d_in=_f(d), d_new=_f(d_new), r_norm=float(rn),
                        v=_f(v), Kv=_f(K @ v.ravel()))
        d = d_new
    return out


PARTS = {
    "wing_small": lambda: part_wing(2, 2, 3),
    "wing_card": lambda: part_wing(6, 3, 3),
    "tbeam_small": lambda: part_tbeam(True),
    "tbeam_card": lambda: part_tbeam(False),
    "arch_small": lambda: part_arch(True),
    "arch_card": lambda: part_arch(False),
    "mint_small": lambda: part_mint(True),
    "mint_card": lambda: part_mint(False),
    "aero_small": lambda: part_aero(True),
    "aero_card": lambda: part_aero(False),
    "csdl_small": lambda: part_csdl(2, 2, 2, True),
    "csdl_card": lambda: part_csdl(32, 2, 3, False),
    "csdl_mi": part_csdl_mi,
    "entry": part_entry,
}


def _load(path):
    if os.path.exists(path):
        with open(path) as fh:
            return json.load(fh)
    return {}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, choices=list(PARTS))
    ap.add_argument("--out", default=None)
    ap.add_argument("--merge", nargs="*", default=None)
    a = ap.parse_args()
    if a.merge:
        doc = _load(OUT)
        for f in a.merge:
            doc.update(_load(f))
        with open(OUT, "w") as fh:
            json.dump(doc, fh)
        print(f"merged {len(a.merge)} files into {OUT}")
        return
    jax = _jax()
    out_path = a.out or OUT
    doc = _load(out_path)
    for name in a.only or list(PARTS):
        t0 = time.perf_counter()
        rec = PARTS[name]()
        rec["seconds"] = time.perf_counter() - t0
        rec["jax_version"] = jax.__version__
        doc[name] = rec
        with open(out_path, "w") as fh:
            json.dump(doc, fh)
        print(f"{name}: {rec['seconds']:.1f} s", flush=True)


if __name__ == "__main__":
    main()
