"""Reference numbers for the PyTorch port's multi-block FFD maps, KS
aggregation components, CP regularization and the two moving-seam
OpenMDAO demos (the 4-patch tube with multi-block FFD, the eVTOL wing
with moving spar and rib seams).

Runs the JAX package on the CPU in float64, direct linear-solver mode,
and writes tests/data/torch_port_om_mi_5b_reference.json:

- "maps": `MultiThicknessFFD` / `MultiShapeFFD` on the 4-patch plate
  (num_el=3, p=2) with the JAX tests' block groups, on seeded designs;
  `align_expansion_operator` (A, reps) on three grids;
- "ks": `MaxIntXiComp`, `MinIntXiComp`, `CPFFDReguCompAgg` on the JAX
  test's seeded inputs (rho 200): values and partials;
- "regu": `cp_regu_energy` (per patch) at a ramp and a seeded CP
  perturbation of the T-beam (num_el=4, p=3), and
  `IntEnergyReguExOperation` (regu_para 1e3) at a seeded state of the
  T-beam (num_el=3, p=2): value and (cp, h, d) gradients;
- "variants": the eVTOL demo's `design_map` (A, offset, x0, lo, up) for
  every variant at build_system(num_el=2, p=2), and four of them at
  s0 = (0.45, 0.20);
- "evtol_small": the eVTOL graph at the JAX tests' size (num_el=3, p=2,
  h_th=0.02): w_int, xi and the analytic totals;
- "evtol_main": `main(num_el=3, p=2, maxiter=8)`: J0, J1, the design, and
  nit/nfev/njev;
- "tube_small": the 4-patch tube at the JAX test's size (num_el=2,
  maxiter 3) and 5e2 Pa: J0, the start designs, the totals there, and the
  SLSQP run's end J, designs, free xi range and nit/nfev/njev. The run's
  third trial design is where this package's warm-started MI Newton
  reaches another equilibrium (J 28.0, where a cold solve there gives
  0.12536 in both packages), so its end is not the port's (ROADMAP C11);
  at the demo's 2e4 Pa the first trial design already parts the two;
- "evtol_card": the eVTOL graph at the demo's own size (num_el=4, p=3,
  variant rspar_rrib): cold w_int, xi, totals, then `run_driver`
  (maxiter 6);
- "tube_card": the 4-patch tube at num_el=16, p=3 and 1e2 Pa (the tube
  phases' size and pressure; the demo's 2e4 Pa has no equilibrium at
  num_el=16): cold int_E, xi, totals, then `run_driver` (maxiter 3).

The machine with the GPU has no JAX, so `chip_smoke.py` and
tests/test_torch_om_mi_5b.py, test_torch_multiffd.py and
test_torch_objectives_regu.py check the port against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_om_mi_5b_reference.py
        [--only maps ks regu variants evtol_small evtol_main tube_small
                evtol_card tube_card]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_om_mi_5b_reference.json")
EW = "int_energy_comp.w_int"
EX = "inputs_comp.spar_rib_design"
EXI = "cpiga2xi_comp.int_para_coords"
EEDGE = "int_xi_edge_comp.int_xi_edge"
TJ = "internal_energy_comp.int_E"
TX = ("inputs_comp.CP_design_FFD0", "inputs_comp.CP_design_FFD1")
TXI = "cpiga2xi_comp.int_para"
EVTOL_CARD = dict(num_el=4, p=3, variant="rspar_rrib", maxiter=6)
TUBE_CARD = dict(num_el=16, p=3, pressure=1.0e2, maxiter=3)
TUBE_SMALL = dict(num_el=2, p=3, pressure=5.0e2, maxiter=3)
THICK_GROUPS = [dict(patches=[0, 1], num_els=(2, 1, 1), p=(2, 1, 1)),
                dict(patches=[2, 3], num_els=(1, 1, 1), p=(1, 1, 1))]
SHAPE_GROUPS = [dict(patches=[0, 1], num_els=(2, 1, 1), p=(2, 1, 1)),
                dict(patches=[2, 3], num_els=(2, 1, 1), p=(2, 1, 1))]
ALIGN_SHAPES = (((4, 4, 3), 2), ((3, 2, 2), 0), ((3, 4, 2), (0, 2)))


def _l(a):
    return np.asarray(a, dtype=np.float64).tolist()


def _write(out):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def maps_part():
    import jax.numpy as jnp

    from goldfish_tpu.design.constraints import align_expansion_operator
    from goldfish_tpu.design.pipeline import MultiShapeFFD, MultiThicknessFFD
    from goldfish_tpu.models import plate

    rng = np.random.default_rng(5)
    sys_ = plate.build(num_el=3, p=2, num_patches=4)
    th = MultiThicknessFFD(sys_, THICK_GROUPS)
    xh = plate.H_TH * (1.0 + 0.1 * rng.uniform(-1, 1, th.n_design))
    out = dict(thick_x=_l(xh), thick=_l(th(jnp.asarray(xh))),
               thick_sizes=[int(n) for n in th.sizes])
    for fields in ((2,), (0, 1)):
        sh = MultiShapeFFD(sys_, SHAPE_GROUPS, opt_fields=fields)
        x = sh.init_p_ffd() + 0.01 * rng.normal(size=sh.n_design)
        key = "shape_" + "".join(map(str, fields))
        out[key + "_x"] = _l(x)
        out[key + "_x0"] = _l(sh.init_p_ffd())
        out[key] = _l(sh(jnp.asarray(x)))
    out["align"] = []
    for shape, axis in ALIGN_SHAPES:
        A, reps = align_expansion_operator(shape, axis)
        out["align"].append(dict(shape=list(shape), axis=axis, A=_l(A),
                                 reps=[int(r) for r in reps]))
    return out


def ks_part():
    try:
        import openmdao.api as om
    except ModuleNotFoundError:
        from goldfish_tpu.om_shim import api as om

    from goldfish_tpu.om_comps.components import (
        CPFFDReguCompAgg,
        MaxIntXiComp,
        MinIntXiComp,
    )

    rng = np.random.default_rng(3)
    xi = rng.uniform(0.05, 0.95, size=24)
    A = np.diff(np.eye(7), axis=0)
    p = np.sort(rng.uniform(0.0, 1.0, size=7))
    out = dict(xi=_l(xi), p=_l(p), rho=200.0)
    for cls, name, x, kw in ((MaxIntXiComp, "max", xi, {}),
                             (MinIntXiComp, "min", xi, {}),
                             (CPFFDReguCompAgg, "regu", p, dict(A=A))):
        c = cls(rho=200.0, **kw) if kw else cls(input_shape=x.size,
                                                 rho=200.0)
        c.init_parameters()
        model = om.Group()
        inp = om.IndepVarComp()
        inp.add_output(c.in_name, shape=x.size, val=x)
        model.add_subsystem("inputs_comp", inp)
        model.add_subsystem("c", c)
        model.connect("inputs_comp." + c.in_name, "c." + c.in_name)
        prob = om.Problem(model=model)
        prob.setup()
        prob.run_model()
        partials = {}
        c.compute_partials({c.in_name: x}, partials)
        out[name] = dict(value=float(np.asarray(prob["c." + c.out_name])
                                     .ravel()[0]),
                         partials=_l(np.asarray(
                             partials[c.out_name, c.in_name]).ravel()))
    return out


def regu_part():
    import jax.numpy as jnp

    from goldfish_tpu.design.pipeline import CPLayout
    from goldfish_tpu.models import tbeam
    from goldfish_tpu.operations.exops import IntEnergyReguExOperation
    from goldfish_tpu.physics.objectives import cp_regu_energy

    sys_ = tbeam.build(num_el=4, p=3)
    cp0 = sys_.cp
    m = sys_.metas[0]
    gv = np.asarray(sys_.surfs[0].greville_points(1))
    ramp = np.tile(gv[None, :], (m.n_u, 1)).ravel()
    rng = np.random.default_rng(7)
    noise = 1e-3 * rng.normal(size=np.asarray(cp0).shape) \
        * np.asarray(sys_.stack.cp_mask)[..., None]
    cp_r = cp0.at[0, : m.n_cp, 2].add(1e-3 * jnp.asarray(ramp))
    out = dict(ramp_amp=1e-3, noise=_l(noise),
               regu_ramp=_l(cp_regu_energy(sys_.data, cp_r, cp0, 1.0)),
               regu_noise=[_l(cp_regu_energy(sys_.data, cp0 + noise, cp0,
                                             1.0, field=f))
                           for f in range(3)])

    sys3 = tbeam.build(num_el=3, p=2)
    op = IntEnergyReguExOperation(sys3, regu_para=1e3)
    lay = CPLayout(sys3.metas, sys3.stack.max_cp)
    cp = np.array(lay.to_flat(sys3.cp), copy=True)
    cp[:, 2] += 1e-3 * np.sin(np.linspace(0, 9, cp.shape[0]))
    free = np.array(lay.to_flat(sys3.data.free), copy=True).ravel()
    d = 1e-3 * rng.normal(size=cp.size) * free
    h = np.array(lay.to_flat(sys3.h_init[..., None]), copy=True).ravel()
    h = h * (1.0 + 0.05 * rng.uniform(-1, 1, h.size))
    gcp, gh, gd = op.gradients(cp.ravel(), h, d)
    out["op"] = dict(cp=_l(cp.ravel()), h=_l(h), d=_l(d),
                     value=op.compute(cp.ravel(), h, d), dcp=_l(gcp),
                     dh=_l(gh), dd=_l(gd))
    return out


def variants_part():
    from demos.evtol_wing_shopt_mi import (
        HALF_SPAN,
        VARIANTS,
        build_system,
        design_map,
    )

    out = {}
    for tag, kw, s0, variants in (
            ("a", {}, (0.30, 0.30), VARIANTS),
            ("b", dict(s_root=0.45, s_tip=0.20), (0.45, 0.20),
             ("rspar_rrib", "sspar_srib", "qspar_rrib", "qspar_srib"))):
        sys_ = build_system(num_el=2, p=2, **kw)
        for v in variants:
            A, offset, x0, lo, up = design_map(
                sys_, y_rib0=0.45 * HALF_SPAN, variant=v, s0=s0)
            out[f"{tag}/{v}"] = dict(A=_l(A), offset=_l(offset), x0=_l(x0),
                                     lower=_l(lo), upper=_l(up))
    return out


def _evtol_cold(prob):
    t0 = time.perf_counter()
    prob.run_model()
    out = dict(w_int=float(prob[EW][0]), xi=_l(np.asarray(prob[EXI])
                                               .ravel()),
               x=_l(np.asarray(prob[EX]).ravel()),
               xi_edge_max=float(np.max(np.abs(np.asarray(prob[EEDGE])))))
    t1 = time.perf_counter()
    out["dw_int_dx"] = _l(np.asarray(
        prob.compute_totals([EW], [EX])[(EW, EX)]).ravel())
    out["totals_seconds"] = time.perf_counter() - t1
    out["cold_seconds"] = time.perf_counter() - t0
    return out


def _driver(prob, j, xs, extra=None):
    t0 = time.perf_counter()
    prob.run_driver()
    res = prob._driver_result
    out = dict(maxiter=int(prob.driver.options["maxiter"]), nit=int(res.nit),
               nfev=int(res.nfev), njev=int(res.njev),
               message=str(res.message), J_end=float(np.asarray(prob[j])
                                                     .ravel()[0]),
               x_end=[_l(np.asarray(prob[x]).ravel()) for x in xs])
    if extra is not None:
        out.update(extra(prob))
    out["seconds"] = time.perf_counter() - t0
    return out


def evtol_small_part():
    from demos.evtol_wing_shopt_mi import build_problem

    prob, _ = build_problem(num_el=3, p=2, maxiter=2, h_th=0.02)
    return _evtol_cold(prob)


def evtol_main_part():
    from demos.evtol_wing_shopt_mi import main

    t0 = time.perf_counter()
    prob, _, J0, J1 = main(num_el=3, p=2, maxiter=8, verbose=False)
    res = prob._driver_result
    return dict(maxiter=8, J0=J0, J1=J1, x=_l(np.asarray(prob[EX]).ravel()),
                nit=int(res.nit), nfev=int(res.nfev), njev=int(res.njev),
                message=str(res.message),
                xi_edge_max=float(np.max(np.abs(np.asarray(prob[EEDGE])))),
                seconds=time.perf_counter() - t0)


def _xi_free(prob):
    xi = np.asarray(prob[TXI]).ravel()
    free = xi[prob.model.xi_free]
    return dict(xi_free_min=float(free.min()), xi_free_max=float(free.max()))


def tube_small_part():
    c = TUBE_SMALL
    t0 = time.perf_counter()
    prob = _tube_problem(c["num_el"], c["p"], c["pressure"], c["maxiter"])
    prob.run_model()
    J0 = float(np.asarray(prob[TJ]).ravel()[0])
    out = dict(c, J0=J0, x0=[_l(np.asarray(prob[x]).ravel()) for x in TX])
    tot = prob.compute_totals([TJ], list(TX))
    out["dJ_dx"] = [_l(np.asarray(tot[(TJ, x)]).ravel()) for x in TX]
    out.update(_driver(prob, TJ, TX, _xi_free))
    out["seconds"] = time.perf_counter() - t0
    return out


def _tube_problem(num_el, p, pressure, maxiter):
    """The JAX demo's `build_problem` at a given follower pressure (the
    demo fixes the tube's 2e4 Pa)."""
    from demos import tube_shopt_mi_4patch_wffd as demo
    from demos.draft_tube_shopt_mi_wffd import build_mi_tube
    from goldfish_tpu.design.pipeline import MultiShapeFFD

    sys_ = build_mi_tube(num_el=num_el, p=p, pressure=pressure)
    mffd = MultiShapeFFD(
        sys_,
        groups=[{"patches": [0, 1], "num_els": (2, 2, 1), "p": 2},
                {"patches": [2, 3], "num_els": (2, 2, 1), "p": 2}],
        opt_fields=(0, 1))
    model = demo.ShapeOptGroup(nonmatching_sys=sys_, mffd=mffd, oval=0.08)
    model.init_parameters()
    prob = demo.om.Problem(model=model)
    prob.driver = demo.om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob


def evtol_card_part():
    from demos.evtol_wing_shopt_mi import build_problem

    c = EVTOL_CARD
    prob, _ = build_problem(num_el=c["num_el"], p=c["p"],
                            maxiter=c["maxiter"], variant=c["variant"])
    out = dict(c, **_evtol_cold(prob))
    out["driver"] = _driver(prob, EW, (EX,), lambda pr: dict(
        xi_edge_max=float(np.max(np.abs(np.asarray(pr[EEDGE]))))))
    return out


def tube_card_part():
    c = TUBE_CARD
    t0 = time.perf_counter()
    prob = _tube_problem(c["num_el"], c["p"], c["pressure"], c["maxiter"])
    prob.run_model()
    out = dict(c, J0=float(np.asarray(prob[TJ]).ravel()[0]),
               xi=_l(np.asarray(prob[TXI]).ravel()),
               x0=[_l(np.asarray(prob[x]).ravel()) for x in TX],
               **_xi_free(prob))
    t1 = time.perf_counter()
    tot = prob.compute_totals([TJ], list(TX))
    out["dJ_dx"] = [_l(np.asarray(tot[(TJ, x)]).ravel()) for x in TX]
    out["totals_seconds"] = time.perf_counter() - t1
    out["cold_seconds"] = time.perf_counter() - t0
    out["driver"] = _driver(prob, TJ, TX, _xi_free)
    return out


PARTS = dict(maps=maps_part, ks=ks_part, regu=regu_part,
             variants=variants_part, evtol_small=evtol_small_part,
             evtol_main=evtol_main_part, tube_small=tube_small_part,
             evtol_card=evtol_card_part, tube_card=tube_card_part)


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
        for name in PARTS:
            if name not in only:
                continue
            t0 = time.perf_counter()
            part = PARTS[name]()
            part["part_seconds"] = time.perf_counter() - t0
            out[name] = part
            print(f"{name}: {part['part_seconds']:.1f} s", flush=True)
            _write(out)
    finally:
        linalg.set_mode(None)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
