"""The follower pressure and the edge load of the port against the JAX
package, on the small tube (`tube.build(num_el=3, p=3)`: 4 patches of
degree (3, 2), N = 792) at a seeded state: the pressure's work and
d-gradient, K8's plain Hessian (inside `element_hessians(pressure=)`, the
JAX 18-jet blocks) and adjoint, the system's residual, tangent product,
dense tangent and residual VJP (cp, h), all at 1e-12 relative; the edge
load of a tip force likewise. CPU tensors launch no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import PRESSURE, TUBE_SMALL, jax_tube, rel, \
    seeded_state, t

TIP = (0.0, 0.0, 50.0)
TOL = 1e-12


@pytest.fixture(scope="module", params=["pressure", "edge"])
def case(request):
    from goldfish_tpu_torch.bridge import from_numpy_tree

    s = jax_tube() if request.param == "pressure" else jax_tube(TIP)
    return request.param, s, from_numpy_tree(s.data, device="cpu"), \
        seeded_state(0, s)


def _pressure_state():
    from goldfish_tpu_torch.bridge import from_numpy_tree

    s = jax_tube()
    return s, from_numpy_tree(s.data, device="cpu"), seeded_state(0, s)


def test_pressure_work_and_force():
    from goldfish_tpu.physics import loads as jl
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import loads

    s, pd, (cp, h, d, lam, v) = _pressure_state()
    pr = np.asarray(s.data.pressure)
    W_ref, f_ref = jax.value_and_grad(jl.follower_pressure_work, argnums=1)(
        s.stack, d, cp, pr)
    _cuda.reset_launch_counts()
    W = loads.follower_pressure_work(pd.stack, t(d), t(cp), pd.pressure)
    W_e, f = loads.pressure_value_grad(pd.stack, t(d), t(cp), pd.pressure)
    assert abs(float(W) - float(W_ref)) <= TOL * abs(float(W_ref))
    assert W_e.shape == pd.stack.wq.shape[:2]
    assert rel(f, f_ref) <= TOL
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_pressure_adjoint_matches_mixed_derivative():
    """K8 mode (c) = -d/dcp of lam^T r_p, r_p = -dW_p/dd: the JAX mixed
    second derivative of the pressure work."""
    from goldfish_tpu.physics import loads as jl
    from goldfish_tpu_torch.physics import loads

    s, pd, (cp, h, d, lam, v) = _pressure_state()
    pr = np.asarray(s.data.pressure)

    def grad_d(c):
        return jax.grad(jl.follower_pressure_work, argnums=1)(s.stack, d, c,
                                                              pr)

    ref = jax.vjp(grad_d, jnp.asarray(cp))[1](jnp.asarray(lam))[0]
    got = loads.pressure_adjoint(pd.stack, t(d), t(cp), pd.pressure, t(lam))
    assert rel(got, ref) <= TOL


def test_pressure_hessian_is_minus_d2w():
    """K8 mode (b)'s plain version: -d2w/dz2 per qp, symmetric, linear in
    the current jet (w is trilinear)."""
    from goldfish_tpu_torch.physics import loads

    s, pd, (cp, h, d, lam, v) = _pressure_state()
    H = loads.pressure_hessians(pd.stack, t(d), t(cp), pd.pressure)
    assert H.shape == pd.stack.wq.shape + (9, 9)
    assert float((H - H.transpose(-1, -2)).abs().max()) \
        <= 1e-14 * float(H.abs().max())
    H2 = loads.pressure_hessians(pd.stack, 2.0 * t(d), t(cp), pd.pressure)
    H0 = loads.pressure_hessians(pd.stack, 0.0 * t(d), t(cp), pd.pressure)
    assert rel(H2 - H0, 2.0 * (H - H0)) <= 1e-12


def test_element_hessians_with_pressure_match_jax_18_jet():
    from goldfish_tpu.physics import kl_shell as jk
    from goldfish_tpu_torch.physics import kl_shell

    s, pd, (cp, h, d, lam, v) = _pressure_state()
    ref = jk.element_hessians(s.stack, d, cp, h, s.E, s.nu,
                              pressure=s.data.pressure)
    got = kl_shell.element_hessians(pd.stack, t(d), t(cp), t(h), pd.E,
                                    pd.nu, pressure=pd.pressure)
    assert rel(got, ref) <= TOL


@pytest.mark.parametrize("what", ["potential", "residual", "tangent_matvec",
                                  "assemble_K", "residual_vjp"])
def test_system_matches_jax(case, what):
    from goldfish_tpu.solver import system as jsys
    from goldfish_tpu_torch.solver import system

    name, s, pd, (cp, h, d, lam, v) = case
    args = (t(d), t(cp), t(h))
    if what == "potential":
        ref = jsys.total_potential(s.data, d, cp, h)
        got = system.total_potential(pd, *args)
        assert abs(float(got) - float(ref)) <= TOL * abs(float(ref))
    elif what == "residual":
        assert rel(system.residual(pd, *args),
                   jsys.residual(s.data, d, cp, h)) <= TOL
    elif what == "tangent_matvec":
        assert rel(system.tangent_matvec(pd, *args, t(v)),
                   jsys.tangent_matvec(s.data, d, cp, h, v)) <= TOL
    elif what == "assemble_K":
        assert rel(system.assemble_K(pd, *args),
                   jsys.assemble_K(s.data, d, cp, h)) <= TOL
    else:
        _, vjp = jax.vjp(lambda c, hh: jsys.residual(s.data, d, c, hh),
                         jnp.asarray(cp), jnp.asarray(h))
        gc, gh = vjp(jnp.asarray(lam))
        dcp, dh = system.residual_vjp(pd, *args, t(lam))
        assert rel(dcp, -np.asarray(gc)) <= TOL
        assert rel(dh, -np.asarray(gh)) <= TOL


def test_volume_and_its_gradients_match_jax():
    from goldfish_tpu.physics import kl_shell as jk
    from goldfish_tpu_torch.physics import kl_shell

    s, pd, (cp, h, d, lam, v) = _pressure_state()
    V, (gc, gh) = jax.value_and_grad(jk.volume, argnums=(1, 2))(
        s.stack, jnp.asarray(cp), jnp.asarray(h))
    cpt, ht = t(cp).requires_grad_(True), t(h).requires_grad_(True)
    Vp = kl_shell.volume(pd.stack, cpt, ht)
    Vp.backward()
    assert abs(float(Vp) - float(V)) <= TOL * abs(float(V))
    assert rel(cpt.grad, gc) <= TOL and rel(ht.grad, gh) <= TOL


def test_facade_loads_and_solve():
    """The port's own tube facade: pressure and edge loads are live, the
    host builders reproduce the JAX arrays, and `solve_nonlinear`
    converges to an equilibrium whose energy is `internal_energy`."""
    from goldfish_tpu_torch.models import tube
    from goldfish_tpu_torch.solver import system

    s = tube.build(**TUBE_SMALL, pressure=PRESSURE, tip_force=TIP,
                   device="cpu")
    j = jax_tube(TIP)
    for f in j.data.edge_loads._fields:
        assert np.array_equal(getattr(s.data.edge_loads, f).numpy(),
                              np.asarray(getattr(j.data.edge_loads, f))), f
    assert np.array_equal(s.data.pressure.numpy(), np.full(4, PRESSURE))
    d = s.solve_nonlinear(rtol=1e-9)
    r = system.residual(s.data, d, s.cp, s.h_init)
    r0 = system.residual(s.data, torch.zeros_like(d), s.cp, s.h_init)
    assert float(r.norm()) <= 1e-8 * float(r0.norm())
    u = s.evaluate_displacement(d, 1, [1.0, 0.5])
    assert u.shape == (3,) and np.isfinite(u).all()
    assert float(s.internal_energy(d)) > 0.0
    assert abs(float(s.volume()) - 2 * np.pi * tube.RADIUS * tube.LENGTH
               * tube.H_TH) <= 1e-9
