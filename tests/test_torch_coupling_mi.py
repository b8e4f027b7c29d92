"""Moving-intersection penalty of the port (physics/coupling_mi on K5's
plain rows, K2's plain version, K6's plain version) against
goldfish_tpu/physics/coupling_mi and system_mi on the small MI T-beam, at
a bent design, a moved xi and a seeded d: the penalty energy, its
d-gradient, the per-point stiffness blocks and their conn, and the (cp, h,
xi) cotangents of the residual's vjp, all to 1e-12 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import jax_mi_tbeam, mi_state, port_mi_tbeam, rel

TOL = 1e-12


@pytest.fixture(scope="module")
def systems():
    return jax_mi_tbeam(), port_mi_tbeam()


def _args(s):
    return s.ss, s.pdeg, s.qdeg, s.mi, s.co


def test_penalty_energy_and_gradient(systems):
    from goldfish_tpu.physics import coupling_mi as jcm
    from goldfish_tpu_torch.physics import coupling, coupling_mi as pcm

    js, ps = systems
    cp, h, xi, d, _ = mi_state(0)
    J = jnp.asarray
    W_j, g_j = jax.value_and_grad(
        lambda dd: jcm.penalty_energy_mi(*_args(js), J(xi), dd, J(cp),
                                         J(h), js.E))(J(d))
    t = torch.from_numpy
    W_p = pcm.penalty_energy_mi(*_args(ps), t(xi), t(d), t(cp), t(h), ps.E)
    ifs = pcm.interface_stack_mi(*_args(ps), t(xi))
    g_p = coupling.penalty_value_grad(ifs, t(d), t(cp), t(h), ps.E)[1]
    assert abs(float(W_p) - float(W_j)) <= TOL * abs(float(W_j))
    assert rel(g_p, g_j) <= TOL


def test_interface_hessians_and_conn(systems):
    from goldfish_tpu.physics import coupling_mi as jcm
    from goldfish_tpu_torch.physics import coupling_mi as pcm

    js, ps = systems
    cp, h, xi, d, _ = mi_state(1)
    J = jnp.asarray
    Ki_j, cA_j, cB_j = jcm.interface_hessians_mi(
        *_args(js), J(xi), J(d), J(cp), J(h), js.E)
    t = torch.from_numpy
    Ki_p, cA_p, cB_p = pcm.interface_hessians_mi(
        *_args(ps), t(xi), t(d), t(cp), t(h), ps.E)
    assert np.array_equal(cA_p.numpy(), np.asarray(cA_j))
    assert np.array_equal(cB_p.numpy(), np.asarray(cB_j))
    assert rel(Ki_p, Ki_j) <= TOL


def test_residual_vjp_cotangents(systems):
    """-lam^T dR/d(cp, h, xi): K1/K2 adjoint mode on the rows at xi and K6
    chained through the curve tangents, against jax.vjp of residual_mi."""
    from goldfish_tpu.solver.system_mi import _jit_res_vjp_mi
    from goldfish_tpu_torch.solver import system_mi as psm

    js, ps = systems
    cp, h, xi, d, lam = mi_state(2)
    J = jnp.asarray
    ref = _jit_res_vjp_mi(js.data, js.mi, js.co, js.ss, js.pdeg, js.qdeg,
                          J(d), J(cp), J(h), J(xi), J(lam))
    t = torch.from_numpy
    got = psm._res_vjp_mi(*ps.mi_args, t(d), t(cp), t(h), t(xi), t(lam))
    for name, a, b in zip(("dcp", "dh", "dxi"), got, ref):
        assert rel(a, b) <= TOL, name
