"""The port's intersection preprocessor against the JAX package's:

- on the small box wing (n_sections=2, num_el=2, p=2, the edge-type seams
  of an IGES round trip) the same mapping_list, types and mortar element
  counts, and the parametric and physical points to 1e-10;
- on the curved T-beam (the transversal seam: marching Newton, then the
  equal-arc-length polish by the port's CPIGA2Xi on the CPU) the same;
- the name1..name6 npz cache written by either package loads in the
  other, and `interface_specs` agree;
- the NumPy closest-point projection agrees with the JAX package's.

Both packages evaluate surfaces through their C++ geometry kernel (the JAX
package's NumPy path takes minutes a wing; the port's NumPy path is held
against the kernel in test_torch_cad_io.py); without a compiler the tests
skip."""

import numpy as np
import pytest

from goldfish_tpu.geometry import native as jnative
from goldfish_tpu.geometry import preprocessing as jpre
from goldfish_tpu_torch.geometry import preprocessing as ppre


@pytest.fixture
def jax_native(monkeypatch, tmp_path_factory):
    """Both packages on their C++ evaluators, never one on C++ and the
    other on NumPy (whose results differ in the last bits). Where the JAX
    package's kernel is unavailable while the port's builds (a parallel
    worker may lose the race on the shared cache's one `.tmp` file, and
    the module then keeps the kernel off for its lifetime), it is built
    again into a private cache; if that fails too the test fails."""
    from goldfish_tpu_torch.geometry import native as pnative

    def jax_available():
        try:
            return jnative.available()
        except OSError:
            return False

    if not pnative.available():
        if not jax_available():
            pytest.skip("no C++ compiler: neither package builds its "
                        "geometry kernel")
        pytest.fail("the JAX package's geometry kernel builds but the "
                    "port's does not: the two would compare C++ against "
                    "NumPy")
    if not jax_available():
        monkeypatch.setenv("GOLDFISH_TPU_NATIVE_CACHE",
                           str(tmp_path_factory.mktemp("jax_native")))
        monkeypatch.setattr(jnative, "_TRIED", False)
        monkeypatch.setattr(jnative, "_LIB", None)
        if not jax_available():
            pytest.fail("the JAX package's geometry kernel did not build "
                        "in a private cache (GOLDFISH_TPU_NATIVE=0?) while "
                        "the port's did: the two would compare NumPy "
                        "against C++")
    cpp = jpre.closest_point_projection
    monkeypatch.setattr(jpre, "_eval_many", lambda s, uv, nd=1:
                        jnative.surface_eval(s, uv, nd=nd))
    monkeypatch.setattr(
        jpre, "closest_point_projection",
        lambda s, X, uv0=None, max_it=30, tol=1e-12:
        cpp(s, X, uv0, max_it, tol) if uv0 is not None
        else jnative.closest_point(s, X, max_it=max_it, tol=tol))


def _same(jp, pp):
    assert pp.num_intersections == jp.num_intersections > 0
    assert pp.mapping_list == jp.mapping_list
    assert pp.intersections_type == jp.intersections_type
    assert pp.mortar_nels == jp.mortar_nels
    for (a0, a1), (b0, b1) in zip(pp.intersections_para_coords,
                                  jp.intersections_para_coords):
        assert a0.shape == b0.shape and a1.shape == b1.shape
        assert np.abs(a0 - b0).max() <= 1e-10
        assert np.abs(a1 - b1).max() <= 1e-10
    for a, b in zip(pp.intersections_phy_coords, jp.intersections_phy_coords):
        assert np.abs(a - b).max() <= 1e-10


def _wing_surfs(tmp_path):
    from goldfish_tpu_torch.geometry.igs_io import (
        read_igs_file,
        write_igs_file,
    )
    from goldfish_tpu_torch.models import boxwing

    base = boxwing.build(n_sections=2, num_el=2, p=2, device="cpu")
    path = str(tmp_path / "wing.igs")
    write_igs_file(path, base.surfs)
    return read_igs_file(path)


def test_box_wing_intersections_match_jax(tmp_path, jax_native):
    surfs = _wing_surfs(tmp_path)
    jp = jpre.Preprocessor(surfs).compute_intersections(rtol=2e-4,
                                                        mortar_refine=2)
    pp = ppre.Preprocessor(surfs, device="cpu").compute_intersections(
        rtol=2e-4, mortar_refine=2)
    _same(jp, pp)
    assert set(pp.intersections_type) == {"edge"}
    # the caches interchange
    fp, fj = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    pp.save_intersections_data(fp)
    jp.save_intersections_data(fj)
    _same(jp, ppre.Preprocessor(surfs).load_intersections_data(fj))
    _same(jpre.Preprocessor(surfs).load_intersections_data(fp), pp)
    for a, b in zip(pp.interface_specs(), jp.interface_specs()):
        assert a.pair == b.pair and a.n_mortar_el == b.n_mortar_el
        for f in ("xi_ends_A", "xi_ends_B", "xi_pts_A", "xi_pts_B"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_curved_seam_matches_jax(jax_native):
    """The transversal seam of the curved T-beam demo: traced, then
    polished by CPIGA2Xi (the port's on the CPU)."""
    from demos.shape_opt_mint_tbeam_curved import build_curved_mi

    from goldfish_tpu_torch.demos import shape_opt_mint_tbeam_curved as pc

    _, jp = build_curved_mi(num_el=3, p=2)
    _, pp = pc.build_curved_mi(num_el=3, p=2, device="cpu")
    _same(jp, pp)
    assert pp.intersections_type == ["surf"]
    xiA = pp.intersections_para_coords[0][0]
    chord = np.linspace(xiA[0], xiA[-1], xiA.shape[0])
    assert np.abs(xiA - chord).max() > 1e-3   # the seam is curved


def test_numpy_projection_matches_jax():
    from goldfish_tpu_torch.models.slr import roof_patch

    s = roof_patch(5, 3, [50, 100], [0, 25])
    rng = np.random.default_rng(2)
    X = ppre._eval_many_numpy(s, rng.uniform(0.05, 0.95, (25, 2)),
                              nd=0)[(0, 0)]
    X = X + rng.normal(scale=0.2, size=X.shape)
    a = ppre.closest_point_projection_numpy(s, X)
    b = jpre.closest_point_projection(s, X)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
