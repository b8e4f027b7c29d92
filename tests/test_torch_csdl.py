"""The port's CSDL layer on the CPU (the port's csdl_shim; csdl_alpha is
not installed): the four non-slow cases of tests/test_csdl_adapters.py on
the port's plate graph (num_el=2, p=2, 2 patches), the graph's w_int and
totals in both modes against the JAX package's (stored by
`JAX_PLATFORMS=cpu python scripts/torch_port_drivers_reference.py` in
tests/data/torch_port_drivers_reference.json), the MI graph of
tests/test_csdl_adapters.py at its small size (its totals in both modes
against the JAX ones, check_totals), and the CSDL plate demo's driver."""

import json
import os

import numpy as np
import pytest
from _torch_port_common import rel

from goldfish_tpu_torch import csdl_shim as csdl
from goldfish_tpu_torch.demos.csdl_plate_const_th_opt import build_recorder

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_drivers_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def plate_graph():
    return build_recorder(num_el=2, p=2, num_patches=2, device="cpu")


def _val(v):
    return float(np.asarray(v.value).ravel()[0])


def test_csdl_graph_matches_direct_evaluation(plate_graph):
    """Inline graph evaluation == direct evaluation on the port."""
    import torch

    from goldfish_tpu_torch.design.pipeline import CPLayout
    from goldfish_tpu_torch.physics import objectives

    _, v, sys_ = plate_graph
    lay = CPLayout(sys_.metas, sys_.stack.max_cp, "cpu")
    u = torch.tensor(np.asarray(v["u"].value))
    d = lay.to_padded(u.reshape(-1, 3))
    h = lay.to_padded(torch.tensor(np.asarray(v["h_th"].value)))
    J_direct = float(objectives.internal_energy(sys_.data, d, sys_.cp, h))
    assert abs(_val(v["w_int"]) - J_direct) / abs(J_direct) < 1e-12
    d_direct = sys_.solve_nonlinear(h=h, rtol=1e-10)
    err = np.linalg.norm(lay.to_flat(d_direct).reshape(-1).numpy()
                         - np.asarray(v["u"].value))
    assert err / np.linalg.norm(np.asarray(v["u"].value)) < 1e-8


def test_csdl_check_totals(plate_graph):
    """d(w_int, vol)/d(h_th_design) through the whole graph vs FD."""
    recorder, v, _ = plate_graph
    sim = csdl.experimental.PySimulator(recorder)
    report = sim.check_totals([v["w_int"], v["vol"]], [v["h_th_design"]],
                              step_size=1e-7, compact_print=False)
    for key, entry in report.items():
        assert entry["rel error"] < 1e-6, (key, entry["rel error"])


def test_csdl_fwd_rev_totals_agree(plate_graph):
    """Forward totals (the operations' apply_linear_fwd and
    solve_linear_fwd) vs reverse totals through the multi-consumer graph:
    h_th feeds the implicit solve and both objectives, so reverse mode
    matches only if d_inputs contributions accumulate."""
    recorder, v, _ = plate_graph
    sim = csdl.experimental.PySimulator(recorder)
    for of in (v["w_int"], v["vol"]):
        Jf = sim.compute_totals([of], [v["h_th_design"]], mode="fwd")
        Jr = sim.compute_totals([of], [v["h_th_design"]], mode="rev")
        a = Jf[of, v["h_th_design"]]
        b = Jr[of, v["h_th_design"]]
        assert np.linalg.norm(a - b) / np.linalg.norm(a) < 1e-6


def test_csdl_implicit_diamond_accumulation():
    """An implicit op whose input feeds it twice along different paths,
    with hand-computable totals, on the port's shim."""

    class Square(csdl.CustomExplicitOperation):
        def evaluate(self, x):
            self.declare_input("x", x)
            return self.create_output("y", x.shape)

        def compute(self, inputs, outputs):
            outputs["y"] = inputs["x"] ** 2

        def compute_derivatives(self, inputs, outputs, derivs):
            derivs["y", "x"] = np.diag(2.0 * inputs["x"])

    class ImplicitScale(csdl.experimental.CustomImplicitOperation):
        # R(u; a, b) = 3u - a - 2b = 0  ->  u = (a + 2b)/3
        def evaluate(self, a, b):
            self.declare_input("a", a)
            self.declare_input("b", b)
            return self.create_output("u", a.shape)

        def solve_residual_equations(self, inputs, outputs):
            outputs["u"] = (inputs["a"] + 2.0 * inputs["b"]) / 3.0

        def compute_jacvec_product(self, inputs, outputs, d_inputs,
                                   d_outputs, d_residuals, mode):
            if mode == "fwd":
                r = np.zeros_like(inputs["a"])
                if d_inputs.get("a") is not None:
                    r = r - d_inputs["a"]
                if d_inputs.get("b") is not None:
                    r = r - 2.0 * d_inputs["b"]
                if d_outputs.get("u") is not None:
                    r = r + 3.0 * d_outputs["u"]
                d_residuals["u"] = r
            else:
                rb = d_residuals["u"]
                if "a" in d_inputs:
                    d_inputs["a"] = d_inputs["a"] - rb
                if "b" in d_inputs:
                    d_inputs["b"] = d_inputs["b"] - 2.0 * rb

        def apply_inverse_jacobian(self, inputs, outputs, d_outputs,
                                   d_residuals, mode):
            if mode == "fwd":
                d_outputs["u"] = d_residuals["u"] / 3.0
                return
            d_residuals["u"] = d_outputs["u"] / 3.0

    rec = csdl.Recorder(inline=True)
    rec.start()
    x = csdl.Variable(value=np.array([1.5, -2.0, 0.5]), name="x")
    y = Square().evaluate(x)
    u = ImplicitScale().evaluate(x, y)
    rec.stop()
    sim = csdl.experimental.PySimulator(rec)
    want = np.diag((1.0 + 4.0 * np.asarray(x.value)) / 3.0)
    for mode in ("fwd", "rev"):
        J = sim.compute_totals([u], [x], mode=mode)[u, x]
        assert np.allclose(J, want, atol=1e-12), (mode, J, want)


def test_csdl_plate_graph_against_jax(plate_graph, ref):
    """w_int and vol (1e-10) and their totals in each mode against the JAX
    graph's in the same mode: 1e-8 plus the JAX graph's own spread between
    its two modes (3.6e-9 for dw_int/dh: its state sits at the residual
    floor, where the totals move by ~1e-8; the port's two modes agree to
    ~1e-12)."""
    recorder, v, _ = plate_graph
    want = ref["csdl_small"]
    assert int(np.asarray(v["u"].value).size) == want["n_dofs"]
    for name in ("w_int", "vol"):
        assert abs(_val(v[name]) - want[name]) <= 1e-10 * abs(want[name])
    sim = csdl.experimental.PySimulator(recorder)
    for name in ("w_int", "vol"):
        spread = rel(want[f"d{name}_fwd"], want[f"d{name}_rev"])
        got = {}
        for mode in ("fwd", "rev"):
            J = sim.compute_totals([v[name]], [v["h_th_design"]], mode=mode)
            got[mode] = J[v[name], v["h_th_design"]]
            assert rel(got[mode], want[f"d{name}_{mode}"]) <= 1e-8 + spread, \
                (name, mode)
        assert rel(got["fwd"], got["rev"]) <= 1e-10, name


def _mi_graph():
    """tests/test_csdl_adapters.py's `_mi_graph` on the port: CP -> xi ->
    u -> w_int on the small MI T-beam with a 1-dof amplitude bending the
    web."""
    import torch

    from goldfish_tpu_torch.csdl_models.models import (
        CPIGA2XiModel,
        DispMintStatesModel,
        IntEnergyModel,
    )
    from goldfish_tpu_torch.design.pipeline import CPLayout
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.physics.coupling import InterfaceSpec
    from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
            [0, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, 2, 3, 2)
    srf1 = tbeam.create_surf(pts1, 2, 4, 2)
    specs = [InterfaceSpec(pair=(0, 1),
                           xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
                           xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                           n_mortar_el=8)]
    sys_ = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU, tbeam.H_TH,
                               specs=specs, n_pts_list=[9], device="cpu")
    sys_.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys_.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys_.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])

    lay = CPLayout(sys_.metas, sys_.stack.max_cp, "cpu")
    cp0_flat = lay.to_flat(sys_.cp).reshape(-1).numpy()
    m = sys_.metas[1]
    gv = sys_.surfs[1].greville_points(1)
    bend = np.tile(np.sin(np.pi * np.asarray(gv))[None, :],
                   (m.n_u, 1)).ravel()
    B = np.zeros((cp0_flat.size, 1))
    off = lay.offsets[1]
    for i in range(m.n_cp):
        B[(off + i) * 3 + 0, 0] = bend[i]

    class CPFromAmp(csdl.CustomExplicitOperation):
        def evaluate(self, amp):
            self.declare_input("amp", amp)
            return self.create_output("cp", (cp0_flat.size,))

        def compute(self, inputs, outputs):
            outputs["cp"] = cp0_flat + B @ inputs["amp"]

        def compute_derivatives(self, inputs, outputs, derivs):
            derivs["cp", "amp"] = B

    rec = csdl.Recorder(inline=True)
    rec.start()
    amp = csdl.Variable(value=np.array([0.01]), name="amp")
    cp = CPFromAmp().evaluate(amp)
    xi = CPIGA2XiModel(sys_).evaluate(cp)
    h = csdl.Variable(value=np.full(lay.n_flat, tbeam.H_TH), name="h")
    u = DispMintStatesModel(sys_, rtol=1e-11).evaluate(cp, h, xi)
    w_int = IntEnergyModel(sys_).evaluate(cp, h, u)
    w_int.add_name("w_int")
    rec.stop()
    assert isinstance(sys_.cp, torch.Tensor)
    return rec, dict(amp=amp, w_int=w_int)


def test_csdl_mi_graph_totals(ref):
    """The MI graph's w_int (1e-10) and d(w_int)/d(amp) in both modes
    (1e-7) against the JAX graph's and each other (1e-8), and against FD
    (check_totals, rel < 1e-5, the JAX test's bar)."""
    rec, v = _mi_graph()
    want = ref["csdl_mi"]
    assert abs(_val(v["w_int"]) - want["w_int"]) <= 1e-10 * abs(
        want["w_int"])
    sim = csdl.experimental.PySimulator(rec)
    got = {}
    for mode in ("fwd", "rev"):
        J = sim.compute_totals([v["w_int"]], [v["amp"]], mode=mode)
        got[mode] = J[v["w_int"], v["amp"]]
        assert rel(got[mode], want[f"dw_int_{mode}"]) <= 1e-7
    # the operations' solves to `disp_imop.LINEAR_TOL`: forward and reverse
    # totals agree (at the adjoint gate of 1e-6 they were 3.8e-7 apart at
    # num_el=4, n_pts=17)
    assert rel(got["fwd"], got["rev"]) <= 1e-8
    report = sim.check_totals([v["w_int"]], [v["amp"]], step_size=1e-6,
                              compact_print=False)
    for key, entry in report.items():
        assert entry["rel error"] < 1e-5, (key, entry["rel error"])


def test_csdl_driver_slsqp(ref):
    """The CSDL plate demo's driver (its own assertions: w_int lowered,
    the volume held to 1e-6) against the JAX run's end (1e-6)."""
    from goldfish_tpu_torch.demos.csdl_plate_const_th_opt import main

    v, _ = main(num_el=2, p=2, num_patches=2, maxiter=10, verbose=False,
                device="cpu")
    want = ref["csdl_small"]
    assert _val(v["w_int"]) > 0
    assert abs(_val(v["w_int"]) - want["w_int_end"]) <= 1e-6 * abs(
        want["w_int_end"])
    assert rel(np.asarray(v["h_th_design"].value), want["h_end"]) <= 1e-6
