"""Port's system layer (plain K3 jet_assemble / K4 jet_matvec paths on CPU)
against the JAX package, relative error in norm <= 1e-12, and the
persistent factor's solves."""

import warnings

import jax
import numpy as np
import pytest
import torch

from _torch_port_common import jax_wing, port_data, rel, seeded_state, t

TOL = 1e-12


@pytest.fixture(scope="module")
def state():
    return seeded_state(2)


def test_total_potential_and_residual(state):
    from goldfish_tpu.solver import system as js
    from goldfish_tpu_torch.solver import system as ts

    cp, h, d, _, _ = state
    jd, data = jax_wing().data, port_data()
    Pi, r = ts.potential_and_residual(data, t(d), t(cp), t(h))
    assert rel(Pi, js.total_potential(jd, d, cp, h)) <= TOL
    assert rel(r, js.residual(jd, d, cp, h)) <= TOL
    assert rel(ts.total_potential(data, t(d), t(cp), t(h)), Pi.numpy()) == 0
    assert rel(ts.residual(data, t(d), t(cp), t(h)), r.numpy()) == 0


def test_tangent_matvec(state):
    from goldfish_tpu.solver import system as js
    from goldfish_tpu_torch.solver import system as ts

    cp, h, d, _, v = state
    jd, data = jax_wing().data, port_data()
    Kv = ts.tangent_matvec(data, t(d), t(cp), t(h), t(v))
    assert rel(Kv, js.tangent_matvec(jd, d, cp, h, v)) <= TOL


def test_assemble_K_and_matvec_consistency(state):
    from goldfish_tpu.solver import system as js
    from goldfish_tpu_torch.solver import system as ts

    cp, h, d, _, v = state
    jd, data = jax_wing().data, port_data()
    K = ts.assemble_K(data, t(d), t(cp), t(h))
    assert rel(K, js.assemble_K(jd, d, cp, h)) <= TOL
    # the K4 product from jet Hessians equals the assembled K on free dofs
    free = data.free.reshape(-1)
    Kv = ts.tangent_matvec(data, t(d), t(cp), t(h), t(v)).reshape(-1)
    assert rel(Kv, (K @ (t(v).reshape(-1) * free)) * free) <= TOL


def test_global_dof_maps():
    from goldfish_tpu.solver import system as js
    from goldfish_tpu_torch.solver import system as ts

    s, data = jax_wing(), port_data()
    assert np.array_equal(ts.element_global_dofs(data.stack).numpy(),
                          np.asarray(js.element_global_dofs(s.stack)))
    C = data.stack.max_cp
    assert np.array_equal(ts._interface_global_dofs(data.ifs, C).numpy(),
                          np.asarray(js._interface_global_dofs(s.ifs, C)))


def test_residual_vjp(state):
    from goldfish_tpu.solver import system as js
    from goldfish_tpu_torch.solver import system as ts

    cp, h, d, lam, _ = state
    jd, data = jax_wing().data, port_data()
    _, vjp = jax.vjp(lambda c, hh: js.residual(jd, d, c, hh), cp, h)
    dcp, dh = vjp(-lam)
    dcpt, dht = ts.residual_vjp(data, t(d), t(cp), t(h), t(lam))
    assert rel(dcpt, dcp) <= TOL
    assert rel(dht, dh) <= TOL


def test_stale_factor_solve_is_exact(state):
    """A factor taken at another state still solves K(d) x = b through the
    certificate-gated IR: the certificate passes, the backward error is at
    roundoff, and x agrees with a fresh-factor solve to the adjoint gate.
    (Random-noise states make this thin shell's K indefinite, so the test
    uses the physical linear response d_lin = K(0)^-1 f.)"""
    from goldfish_tpu_torch.solver import system as ts
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor

    cp, h, _, lam, _ = (t(a) for a in state)
    data = port_data()
    zero = torch.zeros_like(cp)
    K0 = ts.assemble_K(data, zero, cp, h)
    r0 = ts.residual(data, zero, cp, h)
    d_lin = torch.linalg.solve(K0, -r0.reshape(-1)).reshape(r0.shape)
    b = lam * data.free

    stale = PersistentDeviceFactor(data)
    stale.ensure(cp, h, 0.9 * d_lin, why="test")
    x = stale.exact_solve(cp, h, d_lin, b)
    assert stale.factor_ok and stale.n_factor == 1
    assert stale.last_ratio <= 1e-6 and not stale.nonconverged

    K = ts.assemble_K(data, d_lin, cp, h)
    res = b.reshape(-1) - K @ x.reshape(-1)
    # normwise backward error |b - K x| / (|K|_2 |x|) at roundoff (the
    # forward error is cond(K) ~ 1e10 times larger by nature)
    backward_err = res.norm() / (torch.linalg.matrix_norm(K, 2) * x.norm())
    assert float(backward_err) <= 1e-12
    fresh = PersistentDeviceFactor(data)
    fresh.ensure(cp, h, d_lin, why="test")
    x_fresh = fresh.exact_solve(cp, h, d_lin, b)
    assert rel(x, x_fresh.numpy()) <= 1e-6


def test_indefinite_factor_is_never_silent(state, monkeypatch):
    """cholesky_ex info != 0 poisons the factor with NaN: the certificate
    is non-finite, the failure is logged, and exact_solve warns."""
    from goldfish_tpu_torch.solver import devicechol

    cp, h, d, lam, _ = state
    data = port_data()
    N = data.free.numel()
    monkeypatch.setattr(
        devicechol, "assemble_K_from",
        lambda tables, Hs: -torch.eye(N, dtype=torch.float64))
    fac = devicechol.PersistentDeviceFactor(data)
    fac.ensure(t(cp), t(h), t(d))
    assert not fac.factor_ok and fac.n_factor_failed == 1
    assert fac.refactor_log[-1][0].endswith("/indefinite")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        x = fac.exact_solve(t(cp), t(h), t(d), t(lam) * data.free)
    assert fac.nonconverged and not np.isfinite(fac.last_ratio)
    assert any(issubclass(x_.category, RuntimeWarning) for x_ in w)
    assert not bool(torch.isfinite(x).all())
