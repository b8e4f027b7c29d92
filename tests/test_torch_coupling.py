"""Port's penalty coupling (K2 penalty_qp, plain path on CPU) against the
JAX package: energy, gradients, interface Hessians and the penalty VJP,
relative error in norm <= 1e-12."""

import jax
import numpy as np
import pytest

from _torch_port_common import jax_wing, port_data, rel, seeded_state, t

TOL = 1e-12


@pytest.fixture(scope="module")
def state():
    return seeded_state(1)


def test_penalty_energy(state):
    from goldfish_tpu.physics import coupling as jc
    from goldfish_tpu_torch.physics import coupling as tc

    cp, h, d, _, _ = state
    s = jax_wing()
    data = port_data()
    P = jc.penalty_energy(s.ifs, d, cp, h, s.E)
    Pt = tc.penalty_energy(data.ifs, t(d), t(cp), t(h), data.E)
    assert rel(Pt, P) <= TOL


def test_penalty_gradients(state):
    from goldfish_tpu.physics import coupling as jc
    from goldfish_tpu_torch.physics import coupling as tc

    cp, h, d, _, _ = state
    s = jax_wing()
    data = port_data()
    gd, gh = jax.grad(jc.penalty_energy, argnums=(1, 3))(s.ifs, d, cp, h,
                                                         s.E)
    W_i, r, dh = tc.penalty_value_grad(data.ifs, t(d), t(cp), t(h), data.E)
    assert W_i.shape == (data.ifs.n_interfaces,)
    assert rel(r, gd) <= TOL
    assert rel(dh, gh) <= TOL


def test_interface_hessians(state):
    from goldfish_tpu.physics import coupling as jc
    from goldfish_tpu_torch.physics import coupling as tc

    cp, h, d, _, _ = state
    s = jax_wing()
    data = port_data()
    Ki = jc.interface_hessians(s.ifs, d, cp, h, s.E)
    Kit = tc.interface_hessians(data.ifs, t(d), t(cp), t(h), data.E)
    assert tuple(Kit.shape) == Ki.shape
    assert rel(Kit, Ki) <= TOL


def test_penalty_vjp(state):
    from goldfish_tpu.physics import coupling as jc
    from goldfish_tpu_torch.physics import coupling as tc

    cp, h, d, lam, _ = state
    s = jax_wing()
    data = port_data()

    def r_pen(cp_, h_):
        return jax.grad(jc.penalty_energy, argnums=1)(s.ifs, d, cp_, h_,
                                                      s.E)

    _, vjp = jax.vjp(r_pen, cp, h)
    dcp, dh = vjp(-lam)
    dcpt, dht = tc.penalty_adjoint(data.ifs, t(d), t(cp), t(h), data.E,
                                   t(lam))
    assert rel(dcpt, dcp) <= TOL
    assert rel(dht, dh) <= TOL


def test_padded_interface_qps_are_exact_zeros(state):
    from goldfish_tpu_torch.physics import coupling as tc

    cp, h, d, _, _ = state
    data = port_data()
    pad = data.ifs.w == 0
    H = tc.penalty_hessians(data.ifs, t(d), t(cp), t(h), data.E)
    assert bool(np.isfinite(H.numpy()).all())
    if bool(pad.any()):
        assert bool((H[pad] == 0).all())
