"""The port's CAD I/O against the JAX package: IGES surfaces, curves and
trims written by either package read the same in the other (control nets
and knots bit for bit, the files themselves byte for byte), STEP surfaces
and assemblies with product structure round trip, `reparametrize_surfaces`
/ `refine_surfaces` agree, and the C++ geometry kernel (built with g++
into goldfish_tpu_torch/_build/) matches the NumPy path where a compiler
exists; where none does, the NumPy path is the one taken."""

import numpy as np
import pytest

from goldfish_tpu.geometry import igs_io as jigs
from goldfish_tpu.geometry import step_io as jstep
from goldfish_tpu_torch.geometry import igs_io, native, step_io
from goldfish_tpu_torch.geometry.cadkit import circle, extrude, line
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.models import tbeam


def _same_surfs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x.control), np.asarray(y.control))
        for kx, ky in zip(x.knots, y.knots):
            assert np.array_equal(np.asarray(kx), np.asarray(ky))


def _parts():
    s0 = tbeam.create_surf([[-1, 0, 0], [1, 0, 0], [-1, 4, 0],
                            [1, 4, 0]], 2, 3, 3)
    s1 = extrude(circle(center=[0, 0, 0], radius=1.0, angle=(0.0, 0.5)),
                 [0.0, 0.0, 2.0])   # rational
    return s0, s1


def test_igs_cross_package(tmp_path):
    """Surfaces, model-space curves and trim loops: the port's file is the
    JAX package's byte for byte, and each package reads the other's."""
    s0, s1 = _parts()
    arc = circle(radius=2.0, angle=(0.0, np.pi / 2))
    seg = line([0, 0, 0], [1, 2, 3])
    hole = [NURBS([np.array([0.0, 0.0, 1.0, 1.0])],
                  np.array([[a[0], a[1], 0.0], [b[0], b[1], 0.0]]))
            for a, b in (((0.3, 0.3), (0.7, 0.3)), ((0.7, 0.3), (0.7, 0.7)),
                         ((0.7, 0.7), (0.3, 0.7)), ((0.3, 0.7), (0.3, 0.3)))]
    pp, pj = str(tmp_path / "port.igs"), str(tmp_path / "jax.igs")
    kw = dict(curves=[arc, seg], trims=[(None, [hole]), None])
    igs_io.write_igs_file(pp, [s0, s1], **kw)
    jigs.write_igs_file(pj, [s0, s1], **kw)
    with open(pp, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    with pytest.warns(UserWarning, match="non-trivial trim"):
        _same_surfs(igs_io.read_igs_file(pj), [s0, s1])
    with pytest.warns(UserWarning, match="non-trivial trim"):
        _same_surfs(jigs.read_igs_file(pp), igs_io.read_igs_file(pp))
    _same_surfs(igs_io.read_igs_curves(pj), jigs.read_igs_curves(pp))
    got, ref = igs_io.read_igs_trimmed(pj), jigs.read_igs_trimmed(pp)
    assert len(got) == len(ref) == 2
    _same_surfs([g.surf for g in got], [r.surf for r in ref])
    assert got[0].outer is None and ref[0].outer is None
    _same_surfs(got[0].inner[0], ref[0].inner[0])
    assert got[1].inner == ref[1].inner == []


def test_igs_wing_roundtrip(tmp_path):
    from goldfish_tpu_torch.models import boxwing

    surfs = boxwing.build(n_sections=2, num_el=2, p=2, device="cpu").surfs
    path = str(tmp_path / "wing.igs")
    igs_io.write_igs_file(path, surfs)
    back = igs_io.read_igs_file(path)
    assert len(back) == len(surfs)
    for a, b in zip(surfs, back):
        assert np.allclose(a.control, b.control, atol=1e-12)
        for ka, kb in zip(a.knots, b.knots):
            assert np.allclose(ka, kb)
    _same_surfs(jigs.read_igs_file(path), back)


def test_step_cross_package(tmp_path):
    s0, s1 = _parts()
    path = str(tmp_path / "t.stp")
    step_io.write_step_file(path, [s0, s1])
    back = step_io.read_step_file(path)
    _same_surfs(back, jstep.read_step_file(path))
    for a, b in zip([s0, s1], back):
        assert np.allclose(a.control, b.control, atol=1e-12)
    r = step_io.refine_surfaces(back, num_el=(4, 4), degree=3)
    _same_surfs(r, jstep.refine_surfaces(back, num_el=(4, 4), degree=3))
    u = np.linspace(0, 1, 7)
    assert np.allclose(s1.evaluate(u, u), r[1].evaluate(u, u), atol=1e-10)
    _same_surfs(step_io.reparametrize_surfaces(back),
                jstep.reparametrize_surfaces(back))


def test_step_assembly_product_structure(tmp_path):
    s0, s1 = _parts()
    th = 0.4
    Rz = np.array([[np.cos(th), -np.sin(th), 0.0],
                   [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    instances = [(0, np.eye(3), np.zeros(3)),
                 (1, Rz, np.array([3.0, -1.0, 2.0])),
                 (0, Rz.T, np.array([0.0, 0.0, 7.0]))]
    path = str(tmp_path / "asm.stp")
    step_io.write_step_assembly(path, [[s0], [s1]], instances,
                                part_names=["skin", "spar"],
                                assembly_name="wing",
                                instance_names=["skin_1", "spar_1",
                                                "skin_2"])
    surfs, meta = step_io.read_step_assembly(path, with_structure=True)
    jsurfs, jmeta = jstep.read_step_assembly(path, with_structure=True)
    _same_surfs(surfs, jsurfs)
    assert meta == jmeta
    u = np.linspace(0, 1, 5)
    for pi, R, t in instances:
        e = step_io.transform_surface([s0, s1][pi], R, t).evaluate(u, u)
        assert any(np.allclose(e, g.evaluate(u, u), atol=1e-10)
                   for g in surfs)
    assert {m["product"] for m in meta} == {"skin", "spar"}
    assert len(step_io.read_step_file(path)) == 2


def test_native_matches_numpy():
    from goldfish_tpu_torch.geometry import preprocessing as pre
    from goldfish_tpu_torch.models.slr import roof_patch

    if not native.available():
        pytest.skip("no C++ compiler: the NumPy path is the only one")
    assert native._BUILD.endswith("_build")
    s = roof_patch(5, 3, [50, 100], [0, 25])  # rational
    rng = np.random.default_rng(0)
    pts = rng.uniform(0.0, 1.0, size=(40, 2))
    out = native.surface_eval(s, pts, nd=2)
    ref = pre._eval_many_numpy(s, pts, nd=2)
    assert set(out) == set(ref)
    for k in out:
        assert np.allclose(out[k], ref[k], rtol=1e-12, atol=1e-10), k
    uv_true = rng.uniform(0.05, 0.95, size=(30, 2))
    X = pre._eval_many_numpy(s, uv_true, nd=0)[(0, 0)]
    for P in (X, X + rng.normal(scale=0.3, size=X.shape)):
        uv_n, d_n = native.closest_point(s, P)
        uv_p, d_p = pre.closest_point_projection_numpy(s, P)
        assert np.allclose(d_n, d_p, atol=1e-8)
        assert np.array_equal(pre.closest_point_projection(s, P)[0], uv_n)


def test_numpy_route_without_compiler(monkeypatch):
    """Where the kernel does not build (no g++), `available()` is False,
    the kernel's entry points raise, and the preprocessor's evaluation and
    projection take the NumPy path."""
    from goldfish_tpu_torch.geometry import preprocessing as pre
    from goldfish_tpu_torch.models.slr import roof_patch

    monkeypatch.setattr(native, "_lib", lambda: None)
    assert not native.available()
    s = roof_patch(5, 3, [50, 100], [0, 25])
    rng = np.random.default_rng(1)
    pts = rng.uniform(0.0, 1.0, size=(20, 2))
    with pytest.raises(RuntimeError, match="not available"):
        native.surface_eval(s, pts)
    got, ref = pre._eval_many(s, pts, nd=2), pre._eval_many_numpy(s, pts, 2)
    assert set(got) == set(ref)
    for k in got:
        assert np.array_equal(got[k], ref[k]), k
    X = ref[(0, 0)] + rng.normal(scale=0.3, size=(20, 3))
    for a, b in zip(pre.closest_point_projection(s, X),
                    pre.closest_point_projection_numpy(s, X)):
        assert np.array_equal(a, b)
