"""The CP-smoothness regularization of the port
(`physics/objectives.py`: `cp_regu_energy`, `internal_energy_regu`;
`operations/exops.py`: `IntEnergyReguExOperation`;
`om_comps/components.py`: `IntEnergyReguComp`), on the CPU:

- the JAX tests' criteria (tests/test_objectives.py `test_cp_regu_energy`,
  `test_int_energy_regu_exop_and_comp`): zero at the initial design, a
  rigid shift free, exactly quadratic in the amplitude, the autograd
  gradient of W_int + regu against central differences, the comp's
  partials;
- the per-patch energies, the operation's value and its (cp, h, d)
  gradients against the JAX package's on the same seeded inputs, from
  tests/data/torch_port_om_mi_5b_reference.json (part "regu").

CPU runs launch no kernel."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_port_common import rel

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_om_mi_5b_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)["regu"]


@pytest.fixture(scope="module")
def tbeam4():
    from goldfish_tpu_torch.models import tbeam

    return tbeam.build(num_el=4, p=3, device="cpu")


def _ramp(s):
    m = s.metas[0]
    gv = np.asarray(s.surfs[0].greville_points(1))
    return m, torch.tensor(np.tile(gv[None, :], (m.n_u, 1)).ravel())


def test_cp_regu_energy(tbeam4):
    from goldfish_tpu_torch.physics.objectives import (
        cp_regu_energy,
        internal_energy_regu,
    )

    s = tbeam4
    data, cp0 = s.data, s.cp
    assert float(cp_regu_energy(data, cp0, cp0, 1.0).abs().sum()) == 0.0
    m, ramp = _ramp(s)
    amp = 1e-3

    def moved(v):
        cp = cp0.clone()
        cp[0, : m.n_cp, 2] += v
        return float(cp_regu_energy(data, cp, cp0, 1.0).sum())

    r_shift, r1, r2 = moved(amp), moved(amp * ramp), moved(2 * amp * ramp)
    assert r_shift < 1e-12 * r1
    assert r1 > 0
    assert abs(r2 - 4.0 * r1) / r1 < 1e-10

    cp_s = cp0.clone()
    cp_s[0, : m.n_cp, 2] += amp * ramp
    d = s.solve_nonlinear(rtol=1e-10)
    f = lambda cp: internal_energy_regu(data, d, cp, s.h_init, cp0,  # noqa
                                        regu_para=1e3)
    x = cp_s.clone().requires_grad_(True)
    g = torch.autograd.grad(f(x), x)[0]
    rng = np.random.default_rng(0)
    v = torch.tensor(rng.normal(size=tuple(cp0.shape))) \
        * s.stack.cp_mask[..., None]
    eps = 1e-6
    with torch.no_grad():
        fd = (f(cp_s + eps * v) - f(cp_s - eps * v)) / (2 * eps)
    ad = float((g * v).sum())
    assert abs(ad - float(fd)) / abs(float(fd)) < 1e-6


def test_cp_regu_energy_matches_jax(tbeam4, ref):
    from goldfish_tpu_torch.physics.objectives import cp_regu_energy

    s = tbeam4
    m, ramp = _ramp(s)
    cp = s.cp.clone()
    cp[0, : m.n_cp, 2] += ref["ramp_amp"] * ramp
    got = cp_regu_energy(s.data, cp, s.cp, 1.0)
    assert rel(got, ref["regu_ramp"]) <= 1e-12
    noise = torch.tensor(ref["noise"], dtype=torch.float64)
    for f in range(3):
        got = cp_regu_energy(s.data, s.cp + noise, s.cp, 1.0, field=f)
        assert rel(got, ref["regu_noise"][f]) <= 1e-12, f


@pytest.fixture(scope="module")
def tbeam3():
    from goldfish_tpu_torch.models import tbeam

    return tbeam.build(num_el=3, p=2, device="cpu")


def test_regu_operation_matches_jax(tbeam3, ref):
    from goldfish_tpu_torch.operations import IntEnergyReguExOperation

    op = IntEnergyReguExOperation(tbeam3, regu_para=1e3)
    want = ref["op"]
    args = [np.asarray(want[k]) for k in ("cp", "h", "d")]
    assert abs(op.compute(*args) - want["value"]) <= 1e-12 \
        * abs(want["value"])
    for got, k in zip(op.gradients(*args), ("dcp", "dh", "dd")):
        assert rel(got, want[k]) <= 1e-11, k


def test_int_energy_regu_comp(tbeam3):
    """The JAX test's graph: the comp at a solved state with the CPs
    moved, its value positive and its partials against differences."""
    from goldfish_tpu_torch.om_comps.components import IntEnergyReguComp
    from goldfish_tpu_torch.om_shim import api as om

    s = tbeam3
    comp = IntEnergyReguComp(nonmatching_sys=s,
                             op_kwargs=dict(regu_para=1e3))
    comp.init_parameters()
    model = om.Group()
    model.add_subsystem("regu", comp)
    prob = om.Problem(model=model)
    prob.setup()
    lay = comp.op.layout
    d = s.solve_nonlinear(rtol=1e-10)
    prob["regu.displacements"] = lay.to_flat(d).reshape(-1).numpy()
    cp = lay.to_flat(s.cp).numpy().copy()
    cp[:, 2] += 1e-3 * np.sin(np.linspace(0, 9, cp.shape[0]))
    prob["regu.CP_IGA"] = cp.ravel()
    prob.run_model()
    val = float(prob["regu.w_int_regu"][0])
    assert np.isfinite(val) and val > 0
    report = prob.check_partials(step=1e-7)
    for comp_name, pairs in report.items():
        for key, entry in pairs.items():
            if np.linalg.norm(entry["J_fd"]) < 1e-12:
                continue
            assert entry["rel error"] < 5e-5, (comp_name, key,
                                               entry["rel error"])
