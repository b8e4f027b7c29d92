"""Shell-shell contact in the port (physics/contact.py, kernel K12's plain
versions on the CPU) against the JAX package.

- At tests/test_contact.py's press at num_el=3, at a seeded contact-active
  d (the upper plate moved into range plus noise), on identical inputs
  (`from_numpy_tree`): W_c and its d- and cp-gradients against
  `contact_energy` with `jax.grad` (1e-12), the hvp against `jax.jvp` of
  that gradient (1e-12), the assembled K with contact against the JAX
  `assemble_K` (1e-12), Pi, r and `residual_vjp` against `jax.vjp` of the
  JAX residual (1e-11); padded qps contribute nothing.
- The press path at num_el=4 (continuation, then the warm adjoint of W_int
  in h) against tests/data/torch_port_contact_reference.json (written by
  scripts/torch_port_contact_reference.py: d and W_c 1e-8, dJ/dh 1e-6) and
  the JAX test's own criteria, FD included.
- `scale_loads` on every load type and the bridge's ContactPairs against the
  JAX package; continuation levels never rerun from d = 0. (The
  moving-seam and Newton-Krylov routes with contact: test_torch_mi_contact.py
  and test_torch_krylov_contact.py.)

CPU runs launch no kernel."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import port_press, press_state, rel, t

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_contact_reference.json")


@pytest.fixture(scope="module")
def press3():
    """(JAX system, port SystemData, numpy state) at num_el=3."""
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from test_contact import _press_problem

    s = _press_problem(num_el=3)
    s.data
    return s, from_numpy_tree(s.data, device="cpu"), press_state(s)


def test_contact_energy_and_gradients_match_jax(press3):
    from goldfish_tpu.physics.contact import contact_energy as jax_energy
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics.contact import contact_energy

    s, data, (cp, _, d, _, _) = press3
    _cuda.reset_launch_counts()
    W_ref, (gd_ref, gc_ref) = jax.value_and_grad(
        lambda dd, cc: jax_energy(s.data.contact, s.stack, dd, cc),
        argnums=(0, 1))(jnp.asarray(d), jnp.asarray(cp))
    dt, cpt = t(d).requires_grad_(True), t(cp).requires_grad_(True)
    W = contact_energy(data.contact, data.stack, dt, cpt)
    W.backward()
    assert float(W_ref) > 0.0
    assert abs(float(W) - float(W_ref)) <= 1e-12 * float(W_ref)
    assert rel(dt.grad, gd_ref) <= 1e-12
    assert rel(cpt.grad, gc_ref) <= 1e-12
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_contact_hvp_matches_jax_jvp(press3):
    from goldfish_tpu.physics.contact import contact_energy as jax_energy
    from goldfish_tpu_torch.physics import contact

    s, data, (cp, _, d, _, v) = press3
    grad = jax.grad(lambda dd: jax_energy(s.data.contact, s.stack, dd,
                                          jnp.asarray(cp)))
    ref = jax.jvp(grad, (jnp.asarray(d),), (jnp.asarray(v),))[1]
    x, w = contact.contact_qps(data.stack, t(d), t(cp))
    Y, _ = contact.contact_hvp(data.contact, x, w,
                               contact.qp_field(data.stack, t(v)))
    assert rel(contact.qp_scatter(data.stack, Y, cp.shape[1]), ref) <= 1e-12


def test_assembled_K_with_contact_matches_jax(press3):
    from goldfish_tpu.solver import system as jsys
    from goldfish_tpu_torch.solver import system

    s, data, (cp, h, d, _, v) = press3
    K_ref = np.asarray(jax.jit(jsys.assemble_K)(
        s.data, jnp.asarray(d), jnp.asarray(cp), jnp.asarray(h)))
    K = system.assemble_K(data, t(d), t(cp), t(h))
    assert rel(K, K_ref) <= 1e-12
    free = np.asarray(s.data.free).reshape(-1)
    Kv = system.tangent_matvec(data, t(d), t(cp), t(h), t(v))
    assert rel(Kv.reshape(-1), (K_ref @ (v.reshape(-1) * free)) * free) \
        <= 1e-12


def test_residual_and_vjp_with_contact_match_jax(press3):
    from goldfish_tpu.solver import system as jsys
    from goldfish_tpu_torch.solver import system

    s, data, (cp, h, d, lam, _) = press3
    args = (jnp.asarray(d), jnp.asarray(cp), jnp.asarray(h))

    @jax.jit
    def refs(dd, cc, hh, ll):
        r, vjp = jax.vjp(lambda c2, h2: jsys.residual(s.data, dd, c2, h2),
                         cc, hh)
        return jsys.total_potential(s.data, dd, cc, hh), r, vjp(-ll)

    Pi_ref, r_ref, (dcp_ref, dh_ref) = refs(*args, jnp.asarray(lam))
    Pi_ref = float(Pi_ref)
    Pi, r = system.potential_and_residual(data, t(d), t(cp), t(h))
    assert abs(float(Pi) - Pi_ref) <= 1e-11 * abs(Pi_ref)
    assert rel(r, r_ref) <= 1e-11
    dcp, dh = system.residual_vjp(data, t(d), t(cp), t(h), t(lam))
    assert rel(dcp, dcp_ref) <= 1e-11
    assert rel(dh, dh_ref) <= 1e-11


def test_padded_qps_contribute_zero():
    """Plates of 3 and 2 elements a side: the coarse one's stack is padded
    (zero qp weights). W_c, its forces and U equal a brute-force sum over
    the real qps only, and the padded qps get no force."""
    from goldfish_tpu_torch.geometry.cadkit import bilinear
    from goldfish_tpu_torch.physics import contact
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    def plate(z, n):
        srf = bilinear([0, 0, z], [1, 0, z], [0, 1, z], [1, 1, z])
        nk = np.linspace(0, 1, n + 1)[1:-1]
        return srf.elevate(0, 1).elevate(1, 1).refine(0, nk).refine(1, nk)

    s = NonMatchingSystem([plate(0.05, 3), plate(0.0, 2)], E=1e7, nu=0.3,
                          h_th=0.01, device="cpu")
    s.set_contact([(0, 1)], k_pen=1e7, r_max=0.1)
    x, w = contact.contact_qps(s.stack, s.zero_displacement(), s.cp)
    pad = w[1] == 0.0
    assert bool(pad.any()) and not bool((w[0] == 0.0).any())
    W, G, _ = contact.contact_value_grad(s.data.contact, x, w)
    xa, xb = x[0].numpy(), x[1][~pad].numpy()
    wa, wb = w[0].numpy(), w[1][~pad].numpy()
    dx = xa[:, None] - xb[None]
    r = np.sqrt((dx ** 2).sum(-1) + 1e-30)
    gap = np.maximum(0.1 - r, 0.0)
    ww = wa[:, None] * wb[None]
    W_ref = (1e7 / 6.0 * gap ** 3 * ww).sum()
    gA = ((ww * -0.5e7 * gap ** 2 / r)[..., None] * dx).sum(1)
    assert W_ref > 0.0 and abs(float(W) - W_ref) <= 1e-12 * W_ref
    assert rel(G[0], gA) <= 1e-12
    assert bool((G[1][pad] == 0.0).all())


def test_design_jvp_plain_matches_torch_jvp_of_the_force():
    """K12 mode 3's plain version, the force's tangent along (dx, dw),
    against torch.func.jvp of the plain force G = dW_c/dx in (x, w), on the
    padded two-plate system (the coarse plate's padded qps have w = 0 and
    get dw = 0): along a seeded (dx, dw) and with dx = 0 (the weights' term
    alone), 1e-12."""
    from goldfish_tpu_torch.geometry.cadkit import bilinear
    from goldfish_tpu_torch.physics import contact
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    def plate(z, n):
        srf = bilinear([0, 0, z], [1, 0, z], [0, 1, z], [1, 1, z])
        nk = np.linspace(0, 1, n + 1)[1:-1]
        return srf.elevate(0, 1).elevate(1, 1).refine(0, nk).refine(1, nk)

    s = NonMatchingSystem([plate(0.05, 3), plate(0.0, 2)], E=1e7, nu=0.3,
                          h_th=0.01, device="cpu")
    s.set_contact([(0, 1)], k_pen=1e7, r_max=0.1)
    c = s.data.contact
    x, w = contact.contact_qps(s.stack, s.zero_displacement(), s.cp)
    rng = np.random.default_rng(12)
    dw = t(rng.normal(size=tuple(w.shape))) * (w != 0) * 1e-3
    dx = t(rng.normal(size=tuple(x.shape))) * 1e-3

    def force(xx, ww):
        return torch.func.grad(contact.energy_plain, argnums=1)(c, xx, ww)

    for tx in (dx, torch.zeros_like(dx)):
        want = torch.func.jvp(force, (x, w), (tx, dw))[1]
        got = contact._design_jvp_plain(c, x, w, tx, dw)
        assert float(want.norm()) > 0.0
        assert rel(got, want) <= 1e-12
        assert bool((got[1][w[1] == 0.0] == 0.0).all())


def test_press_matches_reference():
    """The press path at num_el=4 against the JAX package's numbers, and
    tests/test_contact.py's criteria: |r|/|r(0)| < 1e-8, W_c > 0, midspan
    deflection past first touch, FD of dJ/dh < 1e-5."""
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.physics.contact import contact_energy
    from goldfish_tpu_torch.solver.implicit import (
        build_solve_fn,
        continuation_solve,
    )
    from goldfish_tpu_torch.solver.system import residual

    with open(REF) as fh:
        ref = json.load(fh)["press4"]
    s = port_press(num_el=4)
    data = s.data
    d, _, rn = continuation_solve(data, s.cp, s.h_init, s.zero_displacement(),
                                  n_steps=4, rtol=1e-9, max_it=40)
    r0 = float(torch.linalg.norm(residual(data, torch.zeros_like(d), s.cp,
                                          s.h_init)))
    assert float(rn) / r0 < 1e-8
    Wc = float(contact_energy(data.contact, s.stack, d, s.cp))
    assert Wc > 0.0 and abs(Wc - ref["W_c"]) <= 1e-8 * ref["W_c"]
    assert rel(d, ref["d"]) <= 1e-8
    assert s.evaluate_displacement(d, 0, [0.5, 0.5])[2] < -0.02

    solve = build_solve_fn(data, rtol=1e-10, max_it=60)

    def J_of_h(h):
        return kl_shell.internal_energy(s.stack, solve(s.cp, h, d), s.cp, h,
                                        s.E, s.nu)

    h0 = s.h_init.clone().requires_grad_(True)
    J_of_h(h0).backward()
    assert rel(h0.grad, ref["dJ_dh"]) <= 1e-6
    v = torch.tensor(np.random.default_rng(3).normal(size=tuple(h0.shape))) \
        * s.stack.cp_mask
    with torch.no_grad():
        fd = (float(J_of_h(s.h_init + 1e-6 * v))
              - float(J_of_h(s.h_init - 1e-6 * v))) / 2e-6
    assert abs(float((h0.grad * v).sum()) - fd) <= 1e-5 * abs(fd)


def test_scale_loads_and_bridge_match_jax():
    """Every load type scaled by the same factor in both packages; the
    contact pairs cross the bridge unchanged."""
    from goldfish_tpu.solver.system import scale_loads as jax_scale
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.physics.contact import ContactPairs
    from goldfish_tpu_torch.solver.system import scale_loads
    from test_contact import _press_problem

    s = _press_problem(num_el=2)
    s.add_point_load(0, [0.3, 0.6], [1.0, -2.0, 3.0])
    s.add_edge_load(1, direction=0, side=1, force=[0.0, 5.0, -1.0])
    s.set_pressure([7.0, -3.0])
    s.set_areal_field(np.random.default_rng(2).normal(
        size=np.asarray(s.cp).shape))
    data = s.data
    port = from_numpy_tree(data, device="cpu")
    assert isinstance(port.contact, ContactPairs)
    for f in port.contact._fields:
        assert np.array_equal(getattr(port.contact, f).numpy(),
                              np.asarray(getattr(data.contact, f)))
    a, b = jax_scale(data, 0.37), scale_loads(port, 0.37)
    for got, want in ((b.f_areal, a.f_areal), (b.pressure, a.pressure),
                      (b.f_field, a.f_field),
                      (b.point_loads.F, a.point_loads.F),
                      (b.edge_loads.F, a.edge_loads.F)):
        assert np.array_equal(got.numpy(), np.asarray(want))
    assert b.contact is port.contact and b.stack is port.stack


def test_continuation_levels_never_rerun_from_zero(monkeypatch):
    """A level that ends outside the Newton basin stays at its warm start:
    continuation passes rerun_cold=False, so each level runs one Newton
    loop (a standalone warm solve runs a second one from d = 0)."""
    from goldfish_tpu_torch.solver import implicit

    starts = []

    def fake_loop(d0, *args):
        starts.append(bool(d0.any()))
        return d0 + 1.0, 3, 1.0, 1.0       # |r| = |r(0)|: outside the basin

    monkeypatch.setattr(implicit, "_newton_loop", fake_loop)
    s = port_press(num_el=3)
    implicit.continuation_solve(s.data, s.cp, s.h_init,
                                s.zero_displacement(), n_steps=3)
    assert starts == [False, True, True]
    starts.clear()
    fac = implicit.PersistentDeviceFactor(s.data)
    implicit.newton_solve_host(s.data, fac, s.cp, s.h_init,
                               s.zero_displacement() + 1.0)
    assert starts == [True, False]
