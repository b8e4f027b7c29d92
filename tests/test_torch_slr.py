"""The port's Scordelis-Lo roof (goldfish_tpu_torch/models/slr.py) against
goldfish_tpu/models/slr.py: the 9-patch stack and interfaces bit for bit,
Pi, r and K v at a seeded state at num_el=4 (1e-12), and the QoI at
num_el=6 against the published 0.3006 (5e-3, the bar of the reference's
tests/test_slr.py) and against the JAX package's value in
tests/data/torch_port_vlm_reference.json (1e-8), with the interface
continuity check of tests/test_slr.py:33-37."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_common import rel, t

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_vlm_reference.json")


@pytest.fixture(scope="module")
def roofs():
    from goldfish_tpu.models import slr as js
    from goldfish_tpu_torch.models import slr as ps

    j = js.build(num_el=4)
    j.data
    return j, ps.build(num_el=4, device="cpu")


def _same(a, b):
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("part", ["stack", "ifs"])
def test_roof_tables_bit_identical(roofs, part):
    j, p = (getattr(s, part) for s in roofs)
    for field in j._fields:
        if hasattr(p, field):
            assert _same(getattr(p, field), getattr(j, field)), field


def test_roof_system_bit_identical(roofs):
    """cp, thickness, material, the diaphragm BCs and the z-pin, the dead
    load, and the interface list."""
    j, p = roofs
    for name in ("cp", "h_init", "E", "nu"):
        assert _same(getattr(p, name), getattr(j, name)), name
    assert _same(p.data.free, j.data.free)
    assert _same(p.data.f_areal, j.data.f_areal)
    assert p.num_splines == j.num_splines == 9
    assert [s.pair for s in p.specs] == [s.pair for s in j.specs]


def test_roof_potential_residual_tangent(roofs):
    """Pi, r and K v at a seeded state (the rational 9-patch roof's shell
    and penalty terms and its dead load)."""
    from goldfish_tpu.solver import system as jsys
    from goldfish_tpu_torch.solver import system as psys

    j, p = roofs
    cp, h = np.asarray(j.cp), np.asarray(j.h_init)
    rng = np.random.default_rng(31)
    d = 1e-3 * rng.normal(size=cp.shape) * np.asarray(j.data.free)
    v = rng.normal(size=cp.shape)
    data = j.data

    @jax.jit
    def refs(d, cp, h, v):
        return (jsys.total_potential(data, d, cp, h),
                jsys.residual(data, d, cp, h),
                jsys.tangent_matvec(data, d, cp, h, v))

    Pi_ref, r_ref, Kv_ref = jax.device_get(refs(*map(jnp.asarray,
                                                     (d, cp, h, v))))
    Pi = float(psys.total_potential(p.data, t(d), t(cp), t(h)))
    assert abs(Pi - float(Pi_ref)) <= 1e-12 * abs(float(Pi_ref))
    assert rel(psys.residual(p.data, t(d), t(cp), t(h)), r_ref) <= 1e-12
    assert rel(psys.tangent_matvec(p.data, t(d), t(cp), t(h), t(v)),
               Kv_ref) <= 1e-12


def test_roof_qoi():
    """The linear-regime QoI at num_el=6 on the CPU, and the displacement
    jump across the patch 0 | patch 1 interface."""
    from goldfish_tpu_torch.models import slr

    with open(REF) as fh:
        ref = json.load(fh)["slr"]
    qoi, d, s = slr.solve_qoi(num_el=ref["num_el"],
                              load_scale=ref["load_scale"], device="cpu")
    assert abs(qoi - slr.QOI_REF) / slr.QOI_REF < 5e-3
    assert abs(qoi - ref["qoi"]) <= 1e-8 * ref["qoi"]
    scale = ref["load_scale"]
    uA = s.evaluate_displacement(d, 0, [1.0, 0.7]) / scale
    uB = s.evaluate_displacement(d, 1, [0.0, 0.7]) / scale
    assert np.linalg.norm(uA - uB) < 1e-5 * max(np.linalg.norm(uA), 1e-12)
