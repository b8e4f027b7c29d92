"""Trimmed patches in the port: the cases of tests/test_trim.py on
goldfish_tpu_torch (point-in-polygon, composite loops, cut-cell coverage
areas, outer loops, void-element compression, the IGES trim round trip
and arc entities, zero-support CPs pinned, a trimmed solve), and the
trimmed plate of the hole demo against the JAX package: the stack's
tables and the free mask bit for bit, Pi, r and K v at a seeded state to
1e-12 relative.

CPU runs launch no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port_common import rel, t

from goldfish_tpu_torch.geometry.cadkit import bilinear
from goldfish_tpu_torch.geometry.igs_io import (
    read_igs_curves,
    read_igs_file,
    read_igs_trimmed,
    write_igs_file,
)
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.geometry.patch_stack import (
    build_patch_stack,
    stack_control_points,
)
from goldfish_tpu_torch.geometry.trim import (
    apply_trim,
    compress_voided,
    points_in_polygon,
    sample_loop,
    support_weights,
    trim_mask,
)
from goldfish_tpu_torch.ops.quadrature import build_patch_quadrature
from goldfish_tpu_torch.physics.kl_shell import volume


def _plate(nel=8):
    s = bilinear([0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0])
    s = s.elevate(0, 2).elevate(1, 2)
    r = np.linspace(0, 1, nel + 1)[1:-1]
    return s.refine(0, r).refine(1, r)


def _circle_poly(cx, cy, r, n=512):
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(th), cy + r * np.sin(th)], axis=-1)


def _area(surf, trims, subdiv):
    stack, metas = build_patch_stack([surf], trims=trims, device="cpu",
                                     trim_subdiv=subdiv)
    cp = stack_control_points(metas, device="cpu")
    return float(volume(stack, cp, cp.new_ones(1, cp.shape[1])))


def test_points_in_polygon_and_loops():
    sq = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    pts = np.array([[0.5, 0.5], [1.5, 0.5], [-0.1, 0.2], [0.99, 0.01],
                    [0.5, 1.2]])
    assert points_in_polygon(pts, sq).tolist() == [True, False, False,
                                                   True, False]
    L = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]],
                 dtype=float)
    pts = np.array([[1.5, 0.5], [1.5, 1.5], [0.5, 1.5]])
    assert points_in_polygon(pts, L).tolist() == [True, False, True]
    # a composite loop of 4 degree-1 curves as a hole
    corners = [(0.2, 0.2), (0.8, 0.2), (0.8, 0.8), (0.2, 0.8)]
    segs = [NURBS([np.array([0.0, 0.0, 1.0, 1.0])],
                  np.array([[a[0], a[1], 0.0], [b[0], b[1], 0.0]]))
            for a, b in zip(corners, corners[1:] + corners[:1])]
    poly = sample_loop(segs)
    on = ((np.isclose(poly[:, 0], 0.2) | np.isclose(poly[:, 0], 0.8))
          | (np.isclose(poly[:, 1], 0.2) | np.isclose(poly[:, 1], 0.8)))
    assert on.all()
    m = trim_mask(np.array([[0.5, 0.5], [0.1, 0.1]]), None, [segs])
    assert m.tolist() == [0.0, 1.0]
    with pytest.raises(ValueError):
        sample_loop(np.zeros(4))


def test_trimmed_areas():
    """Circular hole: coverage-corrected cut cells reach the polygon's
    chord error, far below binary masking; a centered square outer loop
    on sub-cell lines keeps a quarter exactly."""
    r = 0.25
    surf = _plate(nel=8)
    hole = _circle_poly(0.5, 0.5, r)
    exact = 1.0 - np.pi * r ** 2
    area = _area(surf, [(None, [hole])], 3)
    assert abs(area - exact) / exact < 1e-4
    p, q = surf.degree
    quad = build_patch_quadrature(surf.knots[0], surf.knots[1], p, q,
                                  surf.weights, subdiv=3)
    binary = apply_trim(quad, None, [hole], coverage=0)
    assert abs(area - exact) < 0.1 * abs(float(np.sum(binary.wq)) - exact)
    outer = np.array([[0.25, 0.25], [0.75, 0.25], [0.75, 0.75],
                      [0.25, 0.75]])
    assert abs(_area(_plate(nel=6), [(outer, [])], 4) - 0.25) < 1e-12


def test_compress_voided_and_coverage_convergence():
    s = _plate(nel=8)
    p, q = s.degree
    quad = build_patch_quadrature(s.knots[0], s.knots[1], p, q, s.weights,
                                  subdiv=3)
    masked = apply_trim(quad, None, [_circle_poly(0.5, 0.5, 0.3)])
    comp = compress_voided(masked)
    assert comp.n_el < masked.n_el
    np.testing.assert_allclose(np.sum(comp.wq), np.sum(masked.wq),
                               rtol=1e-14)
    r = 0.3
    surf = _plate(nel=6)
    hole = _circle_poly(0.5, 0.5, r, n=2048)
    exact = 1.0 - np.pi * r ** 2
    err_bin, err_cov = [], []
    for subdiv in (1, 2, 4):
        quad = build_patch_quadrature(surf.knots[0], surf.knots[1], p, q,
                                      surf.weights, subdiv=subdiv)
        err_bin.append(abs(float(np.sum(
            apply_trim(quad, None, [hole], coverage=0).wq)) - exact))
        err_cov.append(abs(float(np.sum(
            apply_trim(quad, None, [hole]).wq)) - exact))
    assert err_bin[2] < 0.5 * err_bin[0], err_bin
    assert all(c < 0.2 * b for b, c in zip(err_bin, err_cov))
    assert err_cov[0] < 5e-5, err_cov


def test_igs_trim_roundtrip_and_arc(tmp_path):
    from goldfish_tpu_torch.geometry.igs_io import _resolve_pcurve

    surf = _plate(nel=4)
    corners = [(0.3, 0.3), (0.7, 0.3), (0.7, 0.7), (0.3, 0.7)]
    segs = [NURBS([np.array([0.0, 0.0, 1.0, 1.0])],
                  np.array([[a[0], a[1], 0.0], [b[0], b[1], 0.0]]))
            for a, b in zip(corners, corners[1:] + corners[:1])]
    outer = _circle_poly(0.5, 0.5, 0.45, n=16)
    opts = np.concatenate([outer, outer[:1]])
    n = len(opts)
    knots = np.concatenate([[0.0], np.linspace(0, 1, n), [1.0]])
    ocurve = NURBS([knots], np.concatenate([opts, np.zeros((n, 1))], 1))
    model_curve = NURBS([np.array([0.0, 0.0, 1.0, 1.0])],
                        np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]))
    path = str(tmp_path / "trimmed.igs")
    write_igs_file(path, [surf, _plate(nel=2)], curves=[model_curve],
                   trims=[([ocurve], [segs]), None])
    back = read_igs_curves(path)
    assert len(back) == 1
    np.testing.assert_allclose(back[0].points, model_curve.points,
                               atol=1e-12)
    got = read_igs_trimmed(path)
    assert len(got) == 2
    np.testing.assert_allclose(got[0].surf.points, surf.points, atol=1e-12)
    assert len(got[0].outer) == 1 and len(got[0].inner[0]) == 4
    np.testing.assert_allclose(sample_loop(got[0].outer),
                               sample_loop([ocurve]), atol=1e-12)
    np.testing.assert_allclose(sample_loop(got[0].inner[0]),
                               sample_loop(segs), atol=1e-12)
    assert got[1].outer is None and got[1].inner == []
    with pytest.warns(UserWarning, match="non-trivial trim"):
        assert len(read_igs_file(path)) == 2
    # IGES type-100 arcs resolve to exact rational arcs
    ents = {1: (100, ["100", "0", "0.5", "0.5",
                      "0.75", "0.5", "0.75", "0.5"])}
    (c,) = _resolve_pcurve(1, ents)
    rr = np.linalg.norm(sample_loop([c], n_per_span=32) - [0.5, 0.5], axis=1)
    np.testing.assert_allclose(rr, 0.25, atol=1e-12)
    m = trim_mask(np.array([[0.5, 0.5], [0.05, 0.05]]), [c], [])
    assert m.tolist() == [1.0, 0.0]


def test_zero_support_cps_pinned_and_trimmed_solve():
    """A CP whose whole support is trimmed away is pinned (its stiffness
    row is zero); a cantilever with a hole deflects more than the solid
    plate."""
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    sys_ = NonMatchingSystem([_plate(nel=10)], 1e7, 0.3, 0.05,
                             trims=[(None, [_circle_poly(0.5, 0.5, 0.3)])],
                             device="cpu")
    w = support_weights(sys_.stack)
    n_cp = sys_.metas[0].n_cp
    dead = w[0, :n_cp] == 0.0
    assert dead.sum() > 0
    assert np.all(sys_._free[0, :n_cp][dead] == 0.0)
    tips = []
    for trims in (None, [(None, [_circle_poly(0.5, 0.5, 0.25)])]):
        s = NonMatchingSystem([_plate(nel=6)], 1e7, 0.3, 0.05, trims=trims,
                              device="cpu")
        s.add_side_bc(0, direction=0, side=0, n_layers=2)
        s.set_dead_load([0, 0, -1e-4])
        d = s.solve_nonlinear()
        assert bool(d.isfinite().all())
        tips.append(float(s.evaluate_displacement(d, 0, [1.0, 0.5])[2]))
    solid, holed = tips
    assert holed < 0 and abs(holed) > 1.05 * abs(solid)


@pytest.fixture(scope="module")
def holes():
    """The hole demo's trimmed plate (num_el=4, trim_subdiv=4) in both
    packages."""
    from demos.plate_hole_thickness_opt import build_system as jbuild

    from goldfish_tpu_torch.demos.plate_hole_thickness_opt import (
        build_system,
    )

    j, _ = jbuild(num_el=4)
    j.data
    p, _ = build_system(num_el=4, device="cpu")
    return j, p


def test_trimmed_stack_bit_identical(holes):
    j, p = holes
    for field in j.stack._fields:
        a = getattr(p.stack, field).cpu().numpy()
        b = np.asarray(getattr(j.stack, field))
        assert a.shape == b.shape and np.array_equal(a, b), field
    assert np.array_equal(p.data.free.numpy(), np.asarray(j.data.free))
    # cut cells carry coverage weights in (0, 1) of the full rule's
    wq = p.stack.wq.numpy()
    assert ((wq > 0) & (wq < wq.max())).any() and (wq == 0).any()


def test_trimmed_potential_residual_tangent(holes):
    from goldfish_tpu.solver import system as jsys

    from goldfish_tpu_torch.solver import system as psys

    j, p = holes
    cp, h = np.asarray(j.cp), np.asarray(j.h_init)
    rng = np.random.default_rng(17)
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
