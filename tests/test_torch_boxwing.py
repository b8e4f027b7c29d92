"""The port's box-wing builder (models/boxwing.py) and the per-patch
thickness map (design/pipeline.PatchConstantThickness) against the JAX
package's, on the small box wing `boxwing.build(n_sections=2, num_el=2,
p=2)` (11 patches, 24 interfaces): the host arrays arrive bit for bit,
through the builder and through the bridge."""

import numpy as np
import pytest
import torch

BW_SMALL = dict(n_sections=2, num_el=2, p=2)


@pytest.fixture(scope="module")
def jax_bw():
    from goldfish_tpu.models import boxwing

    s = boxwing.build(**BW_SMALL)
    s.data
    return s


@pytest.fixture(scope="module")
def port_bw():
    from goldfish_tpu_torch.models import boxwing

    return boxwing.build(**BW_SMALL, device="cpu")


def _same(a, b):
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("part", ["stack", "ifs"])
def test_boxwing_tables_bit_identical(jax_bw, port_bw, part):
    j, p = getattr(jax_bw, part), getattr(port_bw, part)
    for field in j._fields:
        if hasattr(p, field):
            assert _same(getattr(p, field), getattr(j, field)), field


def test_boxwing_system_bit_identical(jax_bw, port_bw):
    """cp, thickness, material, the clamped root rib, the upper-skin load,
    the patch names and the interface list."""
    j, p = jax_bw, port_bw
    for name in ("cp", "h_init", "E", "nu"):
        assert _same(getattr(p, name), getattr(j, name)), name
    assert _same(p.data.free, j.data.free)
    assert _same(p.data.f_areal, j.data.f_areal)
    assert p.ids == j.ids and p.num_splines == j.num_splines == 11
    assert [s.pair for s in p.specs] == [s.pair for s in j.specs]
    rib0 = p.ids["rib0"]
    assert float(p.data.free[rib0].sum()) == 0.0


def test_boxwing_bridge_round_trip(jax_bw, port_bw):
    from goldfish_tpu_torch.bridge import from_numpy_tree

    b = from_numpy_tree(jax_bw.data, device="cpu")
    for field in ("free", "E", "nu", "f_areal"):
        assert _same(getattr(b, field), getattr(port_bw.data, field)), field
    assert _same(b.ifs.connB, port_bw.ifs.connB)
    assert _same(b.stack.R11, port_bw.stack.R11)


def test_patch_constant_thickness_matches_jax(jax_bw, port_bw):
    from goldfish_tpu.design.pipeline import PatchConstantThickness as JPC
    from goldfish_tpu_torch.design.pipeline import PatchConstantThickness

    jt, pt = JPC(jax_bw), PatchConstantThickness(port_bw)
    assert pt.n == jt.n == 11
    assert np.array_equal(pt.init_h(3e-3), jt.init_h(3e-3))
    per = np.linspace(1e-3, 5e-3, pt.n)
    assert np.array_equal(pt.init_h(per), jt.init_h(per))
    h = np.random.default_rng(0).uniform(1e-3, 5e-3, size=pt.n)
    assert _same(pt(torch.from_numpy(h)), jt(h))
    # padded CP slots carry 0, as CPLayout.to_padded makes them
    out = pt(torch.from_numpy(h)).numpy()
    assert np.all(out[port_bw.stack.cp_mask.numpy() == 0] == 0.0)


def test_pegasus_thickness_ffd_bit_identical(jax_bw, port_bw):
    from goldfish_tpu.design.pipeline import ThicknessFFD as JTF
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD

    kw = dict(num_els=(1, 6, 1), p=(1, 2, 1))
    jt, pt = JTF(jax_bw, **kw), ThicknessFFD(port_bw, **kw)
    assert _same(pt.F, jt.F) and pt.shape == jt.shape
    h = np.random.default_rng(1).uniform(1e-3, 5e-3, size=pt.n_ffd)
    a, b = pt(torch.from_numpy(h)).numpy(), np.asarray(jt(h))
    assert np.linalg.norm(a - b) <= 1e-14 * np.linalg.norm(b)


def test_full_size_shapes():
    """The full box wing of the pegasus demo: 91 patches, 216 interfaces,
    C = 42 (N = 11466 padded dofs), up to 12 elements of 16 qps with 16
    locals, 16 qps per interface."""
    from goldfish_tpu_torch.models import boxwing

    s = boxwing.build(n_sections=18, num_el=3, p=3, device="cpu")
    assert s.num_splines == 91 and len(s.specs) == 216
    assert s.stack.max_cp == 42
    assert s.num_splines * s.stack.max_cp * 3 == 11466
    assert tuple(s.stack.R00.shape) == (91, 12, 16, 16)
    assert tuple(s.ifs.RA00.shape) == (216, 16, 16)
    assert int(s.data.free.sum()) == 8100
