"""The KS aggregation components and the eVTOL wing with moving spar and
rib seams through the OpenMDAO graph in the port (`om_comps/components.py`: `MaxIntXiComp`,
`MinIntXiComp`, `CPFFDReguCompAgg`; `demos/evtol_wing_shopt_mi.py`),
against the JAX package's numbers
in tests/data/torch_port_om_mi_5b_reference.json
(scripts/torch_port_om_mi_5b_reference.py), on the CPU:

- the KS comps: the JAX test's brackets and `check_partials` (rel < 1e-6),
  and the JAX comps' values and partials to 1e-14;
- the eVTOL variant design maps: every variant's (A, offset, x0, lo, up)
  to 1e-12, the geometry at x0, and the outer variant's exact seam
  coincidence (the JAX test's criteria);
- the eVTOL graph at the JAX tests' size (num_el=3, p=2, h_th=0.02):
  w_int 1e-8, xi 1e-10, totals 1e-6, and `check_totals` at the JAX test's
  step of 1e-6 with rel < 1e-5; SLSQP (maxiter 8, the demo's 4 mm skins)
  drops w_int by more than 25% and moves the spar by more than 0.05.

The 4-patch tube's reduced run is in test_torch_tube_om_mi.py (this file
and that one each stay within 40 s on one worker).

CPU runs launch no kernel."""

import json
import os

import numpy as np
import pytest

from _torch_port_common import rel

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_om_mi_5b_reference.json")
EW = "int_energy_comp.w_int"
EX = "inputs_comp.spar_rib_design"
EXI = "cpiga2xi_comp.int_para_coords"
EEDGE = "int_xi_edge_comp.int_xi_edge"


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)


# ------------------------------------------------------------ KS comps
def test_ks_aggregation_comps(ref):
    from goldfish_tpu_torch.om_comps.components import (
        CPFFDReguCompAgg,
        MaxIntXiComp,
        MinIntXiComp,
    )
    from goldfish_tpu_torch.om_shim import api as om

    want = ref["ks"]
    xi, p = np.asarray(want["xi"]), np.asarray(want["p"])
    A = np.diff(np.eye(7), axis=0)  # first-difference rows
    model = om.Group()
    inp = om.IndepVarComp()
    inp.add_output("int_para_coords", shape=xi.size, val=xi)
    inp.add_output("p_ffd", shape=p.size, val=p)
    model.add_subsystem("inputs_comp", inp)
    for cls, name in [(MaxIntXiComp, "max_xi"), (MinIntXiComp, "min_xi")]:
        c = cls(input_shape=xi.size, rho=200.0)
        c.init_parameters()
        model.add_subsystem(name, c)
        model.connect("inputs_comp.int_para_coords",
                      name + ".int_para_coords")
    regu = CPFFDReguCompAgg(A=A, rho=200.0)
    regu.init_parameters()
    model.add_subsystem("regu_agg", regu)
    model.connect("inputs_comp.p_ffd", "regu_agg.p_ffd")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()

    mx = float(np.asarray(prob["max_xi.max_int_xi"]).ravel()[0])
    mn = float(np.asarray(prob["min_xi.min_int_xi"]).ravel()[0])
    rg = float(np.asarray(prob["regu_agg.cpffd_regu_agg"]).ravel()[0])
    assert xi.max() <= mx <= xi.max() + np.log(xi.size) / 200.0
    assert xi.min() - np.log(xi.size) / 200.0 <= mn <= xi.min()
    rows = A @ p
    assert rows.min() - np.log(len(rows)) / 200.0 <= rg <= rows.min()
    report = prob.check_partials(step=1e-7)
    for comp_name, pairs in report.items():
        for key, entry in pairs.items():
            assert entry["rel error"] < 1e-6, (comp_name, key,
                                               entry["rel error"])

    subs = prob.model._subs
    for name, comp, x, val in (("max", subs["max_xi"], xi, mx),
                               ("min", subs["min_xi"], xi, mn),
                               ("regu", subs["regu_agg"], p, rg)):
        assert abs(val - want[name]["value"]) <= 1e-14, name
        partials = {}
        comp.compute_partials({comp.in_name: x}, partials)
        got = np.asarray(partials[comp.out_name, comp.in_name]).ravel()
        assert np.abs(got - np.asarray(want[name]["partials"])).max() \
            <= 1e-14, name


# ------------------------------------------------------------ eVTOL maps
@pytest.fixture(scope="module")
def evtol_systems():
    from goldfish_tpu_torch.demos.evtol_wing_shopt_mi import build_system

    return (build_system(num_el=2, p=2, device="cpu"),
            build_system(s_root=0.45, s_tip=0.20, num_el=2, p=2,
                         device="cpu"))


def _cp_flat(s):
    from goldfish_tpu_torch.design.pipeline import CPLayout

    return CPLayout(s.metas, s.stack.max_cp, s.device).to_flat(
        s.cp).reshape(-1).numpy()


def test_evtol_variant_design_maps(ref, evtol_systems):
    from goldfish_tpu_torch.demos.evtol_wing_shopt_mi import (
        HALF_SPAN,
        design_map,
    )

    n_dv = {"rspar_rrib": 3, "rspar_srib": 4, "sspar_srib": 6,
            "qspar_rrib": 7, "qspar_srib": 8, "rspar_rrib_outer": 5}
    checked = 0
    for key, want in ref["variants"].items():
        if "/" not in key:
            continue
        tag, v = key.split("/")
        s = evtol_systems[0 if tag == "a" else 1]
        s0 = (0.30, 0.30) if tag == "a" else (0.45, 0.20)
        got = design_map(s, y_rib0=0.45 * HALF_SPAN, variant=v, s0=s0)
        for g, k in zip(got, ("A", "offset", "x0", "lower", "upper")):
            assert np.abs(g - np.asarray(want[k])).max() <= 1e-12, (key, k)
        A, offset, x0, lo, up = got
        assert x0.size == n_dv[v]
        assert np.abs(A @ x0 + offset - _cp_flat(s)).max() < 1e-12, key
        assert np.all(lo <= x0) and np.all(x0 <= up)
        checked += 1
    assert checked == 10


def test_evtol_outer_variant_keeps_seams_coincident(evtol_systems):
    from goldfish_tpu_torch.demos.evtol_wing_shopt_mi import (
        BOX_H,
        HALF_SPAN,
        design_map,
    )
    from goldfish_tpu_torch.ops.bspline import rational_basis_2d

    s = evtol_systems[0]
    A, offset, x0, lo, up = design_map(s, y_rib0=0.45 * HALF_SPAN,
                                       variant="rspar_rrib_outer")
    x = x0.copy()
    x[:2] = [0.35, 0.42]
    x[3:] = BOX_H * np.array([1.3, 0.9])     # dof 2 (the root) pinned
    cp_new = (A @ x + offset).reshape(-1, 3)
    offs = np.concatenate([[0], np.cumsum([m.n_cp for m in s.metas])])

    def surf_eval(ip, uv):
        sf = s.surfs[ip]
        p, q = sf.degree
        conn, tab = rational_basis_2d(
            sf.knots[0], sf.knots[1], p, q, sf.weights,
            np.asarray(uv, float)[None, :], nd=0)
        return tab[(0, 0)][0] @ cp_new[offs[ip]:offs[ip + 1]][conn[0]]

    for v in np.linspace(0.0, 1.0, 7):
        pt_spar = surf_eval(2, [1.0, v])         # the spar's top edge
        pt_skin = surf_eval(0, [0.5, pt_spar[1] / HALF_SPAN])
        assert abs(pt_spar[2] - pt_skin[2]) < 1e-12
    for u in np.linspace(0.0, 1.0, 7):
        pt_rib = surf_eval(3, [u, 1.0])          # the rib's top edge
        pt_skin = surf_eval(0, [0.3, pt_rib[1] / HALF_SPAN])
        assert abs(pt_rib[2] - pt_skin[2]) < 1e-12


# ------------------------------------------------------------ eVTOL graph
def test_evtol_full_chain_parity(ref):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos.evtol_wing_shopt_mi import build_problem

    want = ref["evtol_small"]
    prob, _ = build_problem(num_el=3, p=2, maxiter=2, h_th=0.02,
                            device="cpu")
    prob.run_model()
    assert abs(float(prob[EW][0]) - want["w_int"]) <= 1e-8 * want["w_int"]
    assert np.linalg.norm(prob[EXI] - np.asarray(want["xi"])) <= 1e-10
    assert np.max(np.abs(prob[EEDGE])) <= 1e-12
    tot = prob.compute_totals([EW], [EX])
    assert rel(tot[(EW, EX)].ravel(), want["dw_int_dx"]) <= 1e-6
    report = prob.check_totals(of=[EW], wrt=[EX], step=1e-6)
    for key, entry in report.items():
        assert entry["rel error"] < 1e-5, (key, entry["rel error"])
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_evtol_converges(ref):
    from goldfish_tpu_torch.demos.evtol_wing_shopt_mi import main

    want = ref["evtol_main"]
    prob, _, J0, J1 = main(num_el=3, p=2, maxiter=8, verbose=False,
                           device="cpu")
    x = np.asarray(prob[EX])
    assert J1 < 0.75 * J0            # a large physical improvement
    assert abs(x[0] - 0.30) > 0.05   # the spar moved
    assert abs(J0 - want["J0"]) <= 1e-8 * want["J0"]
    assert abs(J1 - want["J1"]) <= 1e-6 * want["J1"]
    assert np.abs(x - np.asarray(want["x"])).max() <= 1e-5
