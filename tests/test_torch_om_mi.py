"""The moving-intersection T-beam shape optimization through the OpenMDAO
graph in the port (`goldfish_tpu_torch/demos/om_tbeam_shopt_mi.py`, its
operations, components, design pipeline and xi constraints) against the
JAX package's, on the CPU:

- `xi_edge_constraints` / `xi_interior_dofs`: the same dofs and values as
  the JAX functions on the small MI T-beam and the small moving-seam tube;
- `CPSurfDesign2Analysis`: elevation, refinement, composed, align, pin,
  regu and dist matrices 1e-15 against the JAX copy's;
- `CPIGA2XiImOperation` and `DispMintImOperation`: every protocol method
  against the JAX operation's outputs on the same seeded numpy inputs,
  both stored by scripts/torch_port_om_mi_reference.py (the tolerances at
  each test);
- the `test_surf_pipeline_comps` graph of tests/test_om_adapters.py on the
  port's components;
- the demo's graph at num_el=3, p=2, n_pts=7: w_int (1e-8), xi (1e-10) and
  the totals (1e-6) against tests/data/torch_port_om_mi_reference.json
  (scripts/torch_port_om_mi_reference.py), SLSQP (`run_driver`,
  maxiter=3) against the same file, and the JAX test's criteria for
  `check_partials` (rel < 1e-4) and `check_totals` (rel < 1e-5).
  `check_totals` takes the JAX test's central-difference step of 1e-6.
  It holds because every converged Newton solve takes one more step after
  its stop test passes (`implicit._polish`): without it the warm solves
  stopped at the residual floor with the soft (bending) modes' error
  still in d, and the differences reached 2-3e-5 in the columns of the
  web's design CPs.

CPU runs launch no kernel."""

import json
import os

import numpy as np
import pytest

from _torch_port_common import rel

SMALL = dict(num_el=3, p=2, n_pts=7)
REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_om_mi_reference.json")
W = "int_energy_comp.w_int"
X = "inputs_comp.CPS_design"
XI = "cpiga2xi_comp.int_para_coords"
EDGE = "int_xi_edge_comp.int_xi_edge"
PIN = "cpsurf_pin_comp.cps_pin"


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)["small"]


@pytest.fixture(scope="module")
def systems():
    from demos.om_tbeam_shopt_mi import build_mi_tbeam
    from goldfish_tpu_torch.models import tbeam

    return build_mi_tbeam(**SMALL), tbeam.build_mi(**SMALL, device="cpu")


@pytest.fixture(scope="module")
def ops_ref(ref):
    """The JAX operations' outputs on their seeded flat inputs
    (scripts/torch_port_om_mi_reference.py `ops_part`): a JAX rerun only
    recomputes them, at ~3 min of compilation."""
    return {k: {n: np.asarray(v) for n, v in part.items()}
            for k, part in ref["ops"].items() if k != "seconds"}


# ------------------------------------------------------------ constraints
@pytest.fixture(scope="module")
def tubes():
    from demos.draft_tube_shopt_mi_wffd import build_mi_tube
    from goldfish_tpu_torch.demos.draft_tube_shopt_mi_wffd import (
        build_mi_tube as port_build,
    )

    return build_mi_tube(num_el=2, p=2), port_build(num_el=2, p=2,
                                                    device="cpu")


@pytest.mark.parametrize("which", ["tbeam", "tube"])
def test_xi_constraints_match_jax(which, systems, tubes):
    from goldfish_tpu.geometry import cpiga2xi as jx
    from goldfish_tpu_torch.geometry import cpiga2xi as px

    jsys, psys = systems if which == "tbeam" else tubes
    jd, jv = jx.xi_edge_constraints(jsys.mi)
    pd, pv = px.xi_edge_constraints(psys.mi)
    assert np.array_equal(pd, jd) and np.array_equal(pv, jv)
    assert len(pd) > 0
    ji, pi = jx.xi_interior_dofs(jsys.mi), px.xi_interior_dofs(psys.mi)
    assert np.array_equal(pi, ji) and len(pi) > 0


def test_cp_design_matrices_match_jax(systems):
    from goldfish_tpu.design.cp_design import CPSurfDesign2Analysis as JD
    from goldfish_tpu_torch.design.cp_design import CPSurfDesign2Analysis

    jsys, psys = systems
    for kw in (dict(design_nel=(1, 1), design_degree=2),
               dict(design_nel=(1, 1))):
        j, p = JD(jsys.surfs, **kw), CPSurfDesign2Analysis(psys.surfs, **kw)
        assert p.design_shapes == j.design_shapes
        for i in p.surf_inds:
            pairs = [(p.elevation_matrix(i), j.elevation_matrix(i)),
                     (p.refinement_matrix(i), j.refinement_matrix(i)),
                     (p.matrix(i), j.matrix(i)),
                     (p.init_design_cp(i, 0), j.init_design_cp(i, 0)),
                     (p.pin_rows(i, [0, (1, 1)]), j.pin_rows(i, [0, (1, 1)]))]
            pairs += [(p.align_rows(i, a), j.align_rows(i, a))
                      for a in (0, 1)]
            pairs += [(p.regu_rows(i, a), j.regu_rows(i, a)) for a in (0, 1)]
            for a, b in pairs:
                assert a.shape == b.shape
                assert np.max(np.abs(a - b), initial=0.0) <= 1e-15
        assert np.array_equal(p.dist_rows(0, 1), j.dist_rows(0, 1))


# ------------------------------------------------------------ operations
XI_FWD = (("d_xi",), ("d_cp",), ("d_cp", "d_xi"))
D_FWD = (("d_d",), ("d_cp",), ("d_h",), ("d_xi",),
         ("d_cp", "d_h", "d_xi", "d_d"))


def _fwd(op, s, combo):
    return op.apply_linear_fwd(**{k: s["t" + k[1:]] for k in combo})


def test_cpiga2xi_operation_matches_jax(systems, ops_ref):
    from goldfish_tpu_torch.operations import CPIGA2XiImOperation

    s, want = ops_ref["inputs"], ops_ref["cpiga2xi"]
    op = CPIGA2XiImOperation(systems[1])
    xi = op.solve_nonlinear(s["cp"])
    assert rel(xi, want["solve_nonlinear"]) <= 1e-12
    assert rel(op.apply_nonlinear(s["cp"], s["xi"]),
               want["apply_nonlinear"]) <= 1e-10
    assert rel(op.vjp(s["cp"], want["solve_nonlinear"], s["r_xi"]),
               want["vjp"]) <= 1e-10
    op.linearize(s["cp"], s["xi"])
    for combo in XI_FWD:
        assert rel(_fwd(op, s, combo), want["fwd_" + "+".join(combo)]) \
            <= 1e-10, combo
    for got, k in zip(op.apply_linear_rev(s["r_xi"]), ("cp", "xi")):
        assert rel(got, want["rev_" + k]) <= 1e-10, k
    for name in ("solve_linear_fwd", "solve_linear_rev"):
        assert rel(getattr(op, name)(s["r_xi"]), want[name]) <= 1e-10, name


@pytest.fixture(scope="module")
def disp_op(systems, ops_ref):
    """The port's operation after its solve at the JAX xi, linearized at
    the JAX package's d (the inputs of the stored products)."""
    from goldfish_tpu_torch.operations import DispMintImOperation

    s, want = ops_ref["inputs"], ops_ref
    xi = want["cpiga2xi"]["solve_nonlinear"]
    op = DispMintImOperation(systems[1], rtol=1e-11)
    d = op.solve_nonlinear(s["cp"], s["h"], xi)
    op.linearize(s["cp"], s["h"], xi, want["disp_mint"]["solve_nonlinear"])
    return op, d


def test_disp_mi_solve_and_residual_match_jax(disp_op, ops_ref):
    op, d = disp_op
    s, want = ops_ref["inputs"], ops_ref["disp_mint"]
    assert rel(d, want["solve_nonlinear"]) <= 1e-8
    assert rel(op.apply_nonlinear(s["cp"], s["h"], s["xi"], s["d"]),
               want["apply_nonlinear"]) <= 1e-12


def test_disp_mi_linear_products_match_jax(disp_op, ops_ref):
    from goldfish_tpu_torch import _cuda

    op, _ = disp_op
    s, want = ops_ref["inputs"], ops_ref["disp_mint"]
    for combo in D_FWD:
        assert rel(_fwd(op, s, combo), want["fwd_" + "+".join(combo)]) \
            <= 1e-10, combo
    for got, k in zip(op.apply_linear_rev(s["r_d"]), ("cp", "h", "xi", "d")):
        assert rel(got, want["rev_" + k]) <= 1e-10, k
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_disp_mi_solves_match_jax(disp_op, ops_ref):
    op, _ = disp_op
    s, want = ops_ref["inputs"], ops_ref["disp_mint"]
    for name in ("solve_linear_fwd", "solve_linear_rev"):
        assert rel(getattr(op, name)(s["r_d"]), want[name]) <= 1e-8, name
    for got, k in zip(op.solve_linear_rev_and_accumulate(s["r_d"]),
                      ("cp", "h", "xi")):
        assert rel(got, want["accumulate_" + k]) <= 1e-6, k


# ------------------------------------------------------------ graphs
def test_surf_pipeline_comps():
    """tests/test_om_adapters.py's CPSurf* graph on the port's components:
    design -> elevation -> refinement reproduces the analysis CPs, and the
    components' partials are clean."""
    from goldfish_tpu_torch.design.cp_design import CPSurfDesign2Analysis
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.om_comps.components import (
        CPSurfAlignComp,
        CPSurfKnotRefienmentComp,
        CPSurfKnotRefinementComp,
        CPSurfOrderElevationComp,
        CPSurfPinComp,
        CPSurfReguComp,
    )
    from goldfish_tpu_torch.om_shim import api as om

    assert CPSurfKnotRefinementComp is CPSurfKnotRefienmentComp
    sys_ = tbeam.build(num_el=4, p=3, device="cpu")
    d2a = CPSurfDesign2Analysis(sys_.surfs, design_nel=(1, 1),
                                design_degree=2)
    model = om.Group()
    inp = om.IndepVarComp()
    x = np.concatenate([d2a.init_design_cp(i, 0) for i in d2a.surf_inds])
    inp.add_output("cp_design", shape=x.size, val=x)
    model.add_subsystem("inputs_comp", inp)
    for cls, name, src, out, kw in [
            (CPSurfOrderElevationComp, "elev_comp", "cp_design",
             "cp_elevated", {}),
            (CPSurfKnotRefienmentComp, "refine_comp", "cp_elevated",
             "cp_analysis", {}),
            (CPSurfAlignComp, "align_comp", "cp_design", "align_comp_out",
             dict(align_axis=1)),
            (CPSurfReguComp, "regu_comp", "cp_design", "regu_comp_out",
             dict(regu_axis=0)),
            (CPSurfPinComp, "pin_comp", "cp_design", "pin_comp_out",
             dict(pinned={0: [0], 1: [0]}))]:
        c = cls(design2analysis=d2a, fields=(0,), input_name=src,
                output_name=out, **kw)
        c.init_parameters()
        model.add_subsystem(name, c)
    for name in ("elev_comp", "align_comp", "regu_comp", "pin_comp"):
        model.connect("inputs_comp.cp_design", name + ".cp_design")
    model.connect("elev_comp.cp_elevated", "refine_comp.cp_elevated")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()

    got = np.asarray(prob["refine_comp.cp_analysis"])
    want = np.concatenate([d2a.matrix(i) @ d2a.init_design_cp(i, 0)
                           for i in d2a.surf_inds])
    assert np.allclose(got, want, atol=1e-12)
    exact = np.concatenate([np.asarray(sys_.surfs[i].points).reshape(-1, 3)
                            [:, 0] for i in d2a.surf_inds])
    assert np.allclose(got, exact, atol=1e-12)
    report = prob.check_partials(step=1e-7)
    for comp, pairs in report.items():
        for key, entry in pairs.items():
            if np.linalg.norm(entry["J_fd"]) < 1e-14:
                assert entry["abs error"] < 1e-8, (comp, key)
            else:
                assert entry["rel error"] < 1e-6, (comp, key)


@pytest.fixture(scope="module")
def demo_prob():
    from goldfish_tpu_torch.demos.om_tbeam_shopt_mi import build_problem

    prob = build_problem(**SMALL, maxiter=3, device="cpu")[0]
    prob.run_model()
    return prob


def test_demo_graph_matches_reference(demo_prob, ref):
    from goldfish_tpu_torch import _cuda

    prob = demo_prob
    assert abs(float(prob[W][0]) - ref["w_int"]) <= 1e-8 * ref["w_int"]
    assert np.linalg.norm(prob[XI] - np.asarray(ref["xi"])) <= 1e-10
    assert np.array_equal(prob[X], np.asarray(ref["x_design"]))
    assert np.max(np.abs(prob[EDGE])) <= 1e-12
    tot = prob.compute_totals([W], [X])
    assert rel(tot[(W, X)].ravel(), ref["dw_int_dx"]) <= 1e-6
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_demo_check_partials_and_totals(demo_prob):
    """The JAX test's criteria (tests/test_om_adapters.py:172-201)."""
    prob = demo_prob
    report = prob.check_partials(step=1e-7)
    checked = 0
    for comp, pairs in report.items():
        for key, entry in pairs.items():
            if np.linalg.norm(entry["J_fd"]) < 1e-10:
                continue
            checked += 1
            assert entry["rel error"] < 1e-4, (comp, key,
                                               entry["rel error"])
    assert checked >= 10
    report = prob.check_totals(of=[W], wrt=[X], step=1e-6)
    for key, entry in report.items():
        assert entry["rel error"] < 1e-5, (key, entry["rel error"])


def test_demo_driver_matches_reference(ref):
    """SLSQP from the cold state ends where the JAX demo's does: at its
    first iteration (ROADMAP C9), w_int lower through the clipped start,
    the xi-edge residual 0 and the pin residual the clip (0.05)."""
    from goldfish_tpu_torch.demos.om_tbeam_shopt_mi import build_problem

    want = ref["driver"]
    prob = build_problem(**SMALL, maxiter=want["maxiter"], device="cpu")[0]
    prob.run_model()
    prob.run_driver()
    res = prob._driver_result
    assert (res.nit, res.nfev, res.njev, str(res.message)) == (
        want["nit"], want["nfev"], want["njev"], want["message"])
    assert abs(float(prob[W][0]) - want["w_int_end"]) \
        <= 1e-8 * want["w_int_end"]
    assert want["w_int_end"] < ref["w_int"]
    assert np.max(np.abs(prob[X] - np.asarray(want["x_end"]))) <= 1e-12
    assert np.max(np.abs(prob[EDGE])) <= 1e-6
    pin = np.max(np.abs(prob[PIN] - prob.model._constraints[PIN]["equals"]))
    assert abs(pin - want["pin_residual_max"]) <= 1e-12
