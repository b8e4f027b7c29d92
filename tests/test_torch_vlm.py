"""The port's vortex lattice (goldfish_tpu_torch/physics/vlm.py) against
goldfish_tpu/physics/vlm.py: the lattice layout bit for bit, the deformed
corners on the 2 x 3 wing at a seeded d (1e-13), the plain AIC (K11's plain
version) on the flat AR-8 half wing and on a seeded bent, cambered lattice
(1e-13), Gamma, F and the lift (1e-12), the AIC Function's backward against
jax.vjp (1e-11) and d(lift)/d(corners) against jax.grad (1e-10); then
port-only mirrors of the reference's Helmbold and linearity tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import rel, t

WING = dict(n_chord=2, n_span=3, num_el=2, p=2)
LAT = dict(mc=5, ns=8)


def _flat_halfwing(Mc=8, Ns=16, half_span=4.0, chord=1.0):
    x = np.linspace(0, chord, Mc + 1)
    y = np.linspace(0, half_span, Ns + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    return np.stack([X, Y, np.zeros_like(X)], -1)


def _bent_lattice(Mc=6, Ns=10, seed=3):
    """A cambered, bent, twisted half wing with seeded node noise."""
    c = _flat_halfwing(Mc, Ns)
    rng = np.random.default_rng(seed)
    X, Y = c[..., 0], c[..., 1]
    c[..., 2] = (0.06 * np.sin(np.pi * X) + 0.02 * (Y / 4.0) ** 2
                 - 0.05 * (Y / 4.0) * (X - 0.25))
    c += 1e-3 * rng.normal(size=c.shape)
    c[:, 0, 1] = 0.0    # the root stays on the symmetry plane
    return c


CASES = {"flat": _flat_halfwing(), "bent": _bent_lattice()}


def _jax_aic(corners):
    from goldfish_tpu.physics.vlm import _horseshoe_induced

    A, B, colloc, nhat = _jax_geometry(corners)
    wake = jnp.array([1.0, 0.0, 0.0])
    mir = jnp.array([1.0, -1.0, 1.0])
    vind = _horseshoe_induced(colloc, A, B, wake) \
        + _horseshoe_induced(colloc, B * mir, A * mir, wake)
    return jnp.sum(vind * nhat[:, None, :], -1)


def _jax_geometry(corners):
    c00, c10 = corners[:-1, :-1], corners[1:, :-1]
    c01, c11 = corners[:-1, 1:], corners[1:, 1:]
    A = (c00 + 0.25 * (c10 - c00)).reshape(-1, 3)
    B = (c01 + 0.25 * (c11 - c01)).reshape(-1, 3)
    colloc = (0.5 * (c00 + c01)
              + 0.75 * (0.5 * (c10 + c11) - 0.5 * (c00 + c01))).reshape(-1, 3)
    nvec = jnp.cross(c11 - c00, c01 - c10)
    area = 0.5 * jnp.linalg.norm(nvec, axis=-1)
    nhat = (nvec / (2.0 * area[..., None] + 1e-300)).reshape(-1, 3)
    return A, B, colloc, nhat


@pytest.fixture(scope="module")
def wings():
    """(JAX wing, port wing, JAX surf set, port surf set, (p, q), cp_uv)."""
    from goldfish_tpu.models import wing as jw
    from goldfish_tpu.ops.bspline_jax import make_surf_set as jmss
    from goldfish_tpu_torch.demos.vlm_aeroelastic_wing import (
        cp_parametric_locations,
    )
    from goldfish_tpu_torch.models import wing as pw
    from goldfish_tpu_torch.ops.bspline_traced import make_surf_set as pmss

    js = jw.build(**WING, load_scale=0.0)
    ps = pw.build(**WING, load_scale=0.0, device="cpu")
    jss, pq = jmss(js.surfs)
    pss, _ = pmss(ps.surfs, device="cpu")
    cp_uv = cp_parametric_locations(ps, WING["n_chord"], WING["n_span"])
    return js, ps, jss, pss, pq, cp_uv


def test_lattice_param_bit_identical(wings):
    from goldfish_tpu.physics import vlm as jv
    from goldfish_tpu_torch.physics import vlm as pv

    cp_uv = wings[-1]
    for mc, ns in ((LAT["mc"], LAT["ns"]), (16, 64)):
        j = jv.build_lattice_param(2, 3, mc, ns, cp_uv=cp_uv)
        p = pv.build_lattice_param(2, 3, mc, ns, cp_uv=cp_uv, device="cpu")
        for f in ("ip", "xi", "panel_cp"):
            a, b = getattr(p, f).numpy(), np.asarray(getattr(j, f))
            assert a.shape == b.shape and np.array_equal(a, b), f
        assert (p.n_chord, p.n_span) == (j.n_chord, j.n_span)


def test_lattice_points_match(wings):
    """Deformed corners at a seeded d; the lattice's corners lie on patch
    seams (xi = 0) and on the last patch's far edges (xi = 1)."""
    from goldfish_tpu.physics import vlm as jv
    from goldfish_tpu_torch.physics import vlm as pv

    js, ps, jss, pss, (p, q), _ = wings
    jl = jv.build_lattice_param(2, 3, **LAT)
    pl = pv.build_lattice_param(2, 3, **LAT, device="cpu")
    xi = pl.xi.numpy()
    assert (xi == 0.0).any() and (xi == 1.0).any()
    rng = np.random.default_rng(11)
    d = 1e-2 * rng.normal(size=np.asarray(js.cp).shape) \
        * np.asarray(js.stack.cp_mask)[..., None]
    ref = jv.lattice_points(jss, p, q, jl, js.cp, jnp.asarray(d))
    got = pv.lattice_points(pss, p, q, pl, ps.cp, t(d))
    assert rel(got, ref) <= 1e-13


@pytest.mark.parametrize("case", ["flat", "bent"])
def test_plain_aic_matches(case):
    from goldfish_tpu_torch.physics import vlm as pv

    c = CASES[case]
    A, B, colloc, nhat, _ = pv.panel_geometry(t(c))
    got = pv.aic_plain(colloc, nhat, A, B, pv.wake_direction("cpu"))
    assert rel(got, _jax_aic(jnp.asarray(c))) <= 1e-13


@pytest.mark.parametrize("case", ["flat", "bent"])
def test_panel_forces_match(case):
    from goldfish_tpu.physics import vlm as jv
    from goldfish_tpu_torch.physics import vlm as pv

    c = CASES[case]
    Fj, aj = jv.solve_panel_forces(jnp.asarray(c), jnp.asarray(0.06),
                                   V_inf=1.0, rho=80.0)
    Fp, ap = pv.solve_panel_forces(t(c), 0.06, V_inf=1.0, rho=80.0)
    assert rel(Fp, Fj) <= 1e-12
    assert rel(ap["gamma"], aj["gamma"]) <= 1e-12
    assert rel(ap["area"], aj["area"]) <= 1e-12
    assert abs(float(ap["lift"]) - float(aj["lift"])) \
        <= 1e-12 * abs(float(aj["lift"]))


def test_aic_backward_matches_jax_vjp():
    """The AIC Function's backward (K11 mode 1's plain version on the CPU)
    against jax.vjp of the reference's AIC, in the corners."""
    from goldfish_tpu_torch.physics import vlm as pv

    c = CASES["bent"]
    N = (c.shape[0] - 1) * (c.shape[1] - 1)
    gbar = np.random.default_rng(5).normal(size=(N, N))
    _, vjp = jax.vjp(_jax_aic, jnp.asarray(c))
    (ref,) = vjp(jnp.asarray(gbar))
    ct = t(c).requires_grad_(True)
    A, B, colloc, nhat, _ = pv.panel_geometry(ct)
    M = pv.aic(colloc, nhat, A, B, pv.wake_direction("cpu"))
    (got,) = torch.autograd.grad(M, ct, t(gbar))
    assert rel(got, ref) <= 1e-11


def test_lift_gradient_matches_jax_grad():
    from goldfish_tpu.physics import vlm as jv
    from goldfish_tpu_torch.physics import vlm as pv

    c = CASES["bent"]
    ref = jax.grad(lambda x: jv.solve_panel_forces(
        x, jnp.asarray(0.05))[1]["lift"])(jnp.asarray(c))
    ct = t(c).requires_grad_(True)
    (got,) = torch.autograd.grad(pv.solve_panel_forces(ct, 0.05)[1]["lift"],
                                 ct)
    assert rel(got, ref) <= 1e-10


def test_lift_slope_vs_helmbold():
    """Rectangular AR-8 wing: CL_alpha within 10% of the Helmbold estimate
    2 pi AR / (2 + sqrt(AR^2 + 4)) (the reference's test_vlm.py:17-32)."""
    from goldfish_tpu_torch.physics.vlm import solve_panel_forces

    alpha = 0.05
    _, aux = solve_panel_forces(t(_flat_halfwing()), alpha, V_inf=1.0,
                                rho=1.0)
    CLa = 2 * float(aux["lift"]) / (0.5 * 2 * 4.0 * 1.0) / alpha
    AR = 8.0
    helmbold = 2 * np.pi * AR / (2 + np.sqrt(AR ** 2 + 4))
    assert abs(CLa - helmbold) / helmbold < 0.10, (CLa, helmbold)


def test_lift_scales_linearly_and_points_up():
    from goldfish_tpu_torch.physics.vlm import solve_panel_forces

    corners = t(_flat_halfwing(Mc=4, Ns=8))
    L1 = float(solve_panel_forces(corners, 0.03)[1]["lift"])
    L2 = float(solve_panel_forces(corners, 0.06)[1]["lift"])
    assert L1 > 0
    assert abs(L2 / L1 - 2.0) < 0.05
