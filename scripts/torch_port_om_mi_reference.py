"""Reference numbers for the PyTorch port's moving-intersection T-beam
shape optimization through the OpenMDAO graph.

Runs demos/om_tbeam_shopt_mi.py's `build_problem` (design CPs -> order
elevation -> knot refinement -> full CP vector -> CPIGA2XiComp ->
DispMintStatesComp -> IntEnergyComp, with the xi-edge and pin
constraints) with the JAX package on the CPU in float64, direct
linear-solver mode, at two sizes, and writes
tests/data/torch_port_om_mi_reference.json:

- "full": scripts/bench_mi.py's T-beam (num_el=40, p=3, n_pts=17: N = 6072
  padded dofs, one seam of 17 points) with the demo's default design
  (design_nel=(1, 1), degree 2, field 0: 18 design CPs): after the cold
  `run_model`, w_int, xi, |d|, the xi-edge constraint values, the design
  start and the pin target, then `compute_totals` of w_int w.r.t. the
  design CPs (18 numbers);
- "small": the same at num_el=3, p=2, n_pts=7 (the port's CPU test size);
- "small" also holds "ops": the JAX package's CPIGA2XiImOperation and
  DispMintImOperation (rtol 1e-11) on seeded flat inputs (stored beside
  them: cp with the web bent in x by 0.05 sin(pi v), the seam moved by up
  to 1e-3, d ~ 1e-3 on free dofs, standard normal tangents and
  cotangents), every protocol method's output;
- at both sizes, `run_driver` (SLSQP; maxiter 6 at the full size, 3 at the
  small one) from the cold state: the end w_int and design, the largest
  xi-edge and pin-constraint residuals, nit/nfev/njev and SciPy's message.
  SLSQP stops at its first iteration here ("Singular matrix C in LSQ
  subproblem"): the demo's design-variable bounds (+-0.95 of the flange's
  half-width) exclude the pinned flange corners at +-1 of it, so SciPy
  clips the start into the bounds and the pin equality cannot hold, and
  the xi-edge constraint's rows of the totals are exactly zero for an
  x-field design.

The machine with the GPU has no JAX, so `chip_smoke.py` and
tests/test_torch_om_mi.py check the port against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_om_mi_reference.py
        [--only small full]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_om_mi_reference.json")
SIZES = {"full": dict(num_el=40, p=3, n_pts=17),
         "small": dict(num_el=3, p=2, n_pts=7)}
MAXITER = {"full": 6, "small": 3}
W = "int_energy_comp.w_int"
X = "inputs_comp.CPS_design"
XI = "cpiga2xi_comp.int_para_coords"
DISP = "disp_states_comp.displacements"
EDGE = "int_xi_edge_comp.int_xi_edge"
PIN = "cpsurf_pin_comp.cps_pin"


def _write(out):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def cold_part(size):
    """run_model and compute_totals of the demo's graph at one size."""
    from demos import om_tbeam_shopt_mi as demo

    t0 = time.perf_counter()
    prob, sys_, d2a = demo.build_problem(**SIZES[size],
                                         maxiter=MAXITER[size])
    prob.run_model()
    pin = prob.model._subs["cpsurf_pin_comp"]
    x0 = np.asarray(prob[X]).ravel()
    out = dict(SIZES[size], w_int=float(prob[W][0]),
               xi=np.asarray(prob[XI]).ravel().tolist(),
               d_norm=float(np.linalg.norm(np.asarray(prob[DISP]))),
               xi_edge=np.asarray(prob[EDGE]).ravel().tolist(),
               x_design=x0.tolist(), pin_target=(pin.A @ x0).tolist(),
               n_dofs=int(np.asarray(sys_.cp).size))
    t1 = time.perf_counter()
    tot = prob.compute_totals([W], [X])
    out["dw_int_dx"] = np.asarray(tot[(W, X)]).ravel().tolist()
    out["totals_seconds"] = time.perf_counter() - t1
    out["cold_seconds"] = time.perf_counter() - t0
    print(f"{size}: w_int {out['w_int']!r} |d| {out['d_norm']!r} "
          f"|dw/dx| {np.linalg.norm(out['dw_int_dx'])!r} "
          f"({out['cold_seconds']:.1f} s)", flush=True)
    return out, prob


def _flat(jsys, a):
    from goldfish_tpu.design.pipeline import CPLayout

    return np.asarray(CPLayout(jsys.metas, jsys.stack.max_cp).to_flat(
        np.asarray(a))).ravel()


def ops_inputs(jsys, seed=3):
    """Seeded flat inputs of the operations' protocol on the T-beam."""
    rng = np.random.default_rng(seed)
    cp = np.array(jsys.cp, dtype=np.float64)
    m = jsys.metas[1]
    gv = jsys.surfs[1].greville_points(1)
    cp[1, : m.n_cp, 0] += 0.05 * np.tile(np.sin(np.pi * gv)[None, :],
                                         (m.n_u, 1)).ravel()
    xi0 = np.asarray(jsys.c2x.xi0_flat).ravel()
    nx = xi0.size
    cp_f = _flat(jsys, cp)
    n = cp_f.size
    return dict(
        cp=cp_f, h=_flat(jsys, np.asarray(jsys.h_init)[..., None]),
        xi=np.clip(xi0 + 1e-3 * rng.uniform(-1, 1, nx), 0.0, 1.0),
        d=1e-3 * rng.normal(size=n) * _flat(jsys, np.asarray(jsys.data.free)),
        t_cp=rng.normal(size=n), t_h=rng.normal(size=n // 3),
        t_xi=rng.normal(size=nx), t_d=rng.normal(size=n),
        r_xi=rng.normal(size=nx), r_d=rng.normal(size=n))


# apply_linear_fwd's tangent combinations, by the names of `ops_inputs`
XI_FWD = (("d_xi",), ("d_cp",), ("d_cp", "d_xi"))
D_FWD = (("d_d",), ("d_cp",), ("d_h",), ("d_xi",),
         ("d_cp", "d_h", "d_xi", "d_d"))


def ops_part(size):
    """Every protocol method of both operations on `ops_inputs`."""
    from demos.om_tbeam_shopt_mi import build_mi_tbeam
    from goldfish_tpu.operations.disp_mi_imop import (
        CPIGA2XiImOperation,
        DispMintImOperation,
    )

    t0 = time.perf_counter()
    jsys = build_mi_tbeam(**SIZES[size])
    s = ops_inputs(jsys)
    out = {"inputs": {k: v.tolist() for k, v in s.items()}}

    def fwd(op, combo):
        return op.apply_linear_fwd(**{k: s["t" + k[1:]] for k in combo})

    op = CPIGA2XiImOperation(jsys)
    xi = op.solve_nonlinear(s["cp"])
    xo = dict(solve_nonlinear=xi,
              apply_nonlinear=op.apply_nonlinear(s["cp"], s["xi"]),
              vjp=op.vjp(s["cp"], xi, s["r_xi"]))
    op.linearize(s["cp"], s["xi"])
    for combo in XI_FWD:
        xo["fwd_" + "+".join(combo)] = fwd(op, combo)
    xo["rev_cp"], xo["rev_xi"] = op.apply_linear_rev(s["r_xi"])
    for name in ("solve_linear_fwd", "solve_linear_rev"):
        xo[name] = getattr(op, name)(s["r_xi"])
    out["cpiga2xi"] = {k: np.asarray(v).ravel().tolist()
                       for k, v in xo.items()}

    op = DispMintImOperation(jsys, rtol=1e-11)
    d = op.solve_nonlinear(s["cp"], s["h"], xi)
    do = dict(solve_nonlinear=d, apply_nonlinear=op.apply_nonlinear(
        s["cp"], s["h"], s["xi"], s["d"]))
    op.linearize(s["cp"], s["h"], xi, d)
    for combo in D_FWD:
        do["fwd_" + "+".join(combo)] = fwd(op, combo)
    for k, v in zip(("cp", "h", "xi", "d"), op.apply_linear_rev(s["r_d"])):
        do["rev_" + k] = v
    for name in ("solve_linear_fwd", "solve_linear_rev"):
        do[name] = getattr(op, name)(s["r_d"])
    for k, v in zip(("cp", "h", "xi"),
                    op.solve_linear_rev_and_accumulate(s["r_d"])):
        do["accumulate_" + k] = v
    out["disp_mint"] = {k: np.asarray(v).ravel().tolist()
                        for k, v in do.items()}
    out["seconds"] = time.perf_counter() - t0
    print(f"ops: {out['seconds']:.1f} s", flush=True)
    return out


def driver_part(prob):
    """run_driver (SLSQP) from the cold state."""
    t0 = time.perf_counter()
    prob.run_driver()
    res = prob._driver_result
    out = dict(maxiter=int(prob.driver.options["maxiter"]), nit=int(res.nit), nfev=int(res.nfev),
               njev=int(res.njev), message=str(res.message),
               w_int_end=float(prob[W][0]),
               x_end=np.asarray(prob[X]).ravel().tolist(),
               xi_edge_max=float(np.max(np.abs(np.asarray(prob[EDGE])))),
               pin_residual_max=float(np.max(np.abs(
                   np.asarray(prob[PIN]) - np.asarray(
                       prob.model._constraints[PIN]["equals"])))),
               seconds=time.perf_counter() - t0)
    print(f"driver: w_int -> {out['w_int_end']!r}, nit {out['nit']} nfev "
          f"{out['nfev']} njev {out['njev']} ({out['seconds']:.1f} s)",
          flush=True)
    return out


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    sys.path.insert(0, ROOT)
    from goldfish_tpu.solver import linalg

    only = [a for a in sys.argv[sys.argv.index("--only") + 1:]
            if a in SIZES] if "--only" in sys.argv else list(SIZES)
    if os.path.exists(OUT):
        with open(OUT) as fh:
            out = json.load(fh)
    else:
        out = {}
    out.update(solver_mode="direct", platform="cpu", dtype="float64",
               jax_version=jax.__version__,
               workload="demos/om_tbeam_shopt_mi.py build_problem("
                        "num_el, p, n_pts, design_nel=(1, 1), maxiter); "
                        "cold run_model, compute_totals(w_int, CPS_design)")
    try:
        out["commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out["commit"] = None

    linalg.set_mode("direct")
    try:
        for size in ("small", "full"):
            if size not in only:
                continue
            t0 = time.perf_counter()
            part, prob = cold_part(size)
            part["driver"] = driver_part(prob)
            if size == "small":
                part["ops"] = ops_part(size)
            part["seconds"] = time.perf_counter() - t0
            out[size] = part
            _write(out)
    finally:
        linalg.set_mode(None)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
