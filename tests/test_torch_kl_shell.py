"""Port's shell physics (K1 shell_qp, plain path on CPU) against the JAX
package: energy, residual, element Hessians and the residual VJP, at a
seeded nonzero state, relative error in norm <= 1e-12 (f64 roundoff of
two differently ordered but identical formulas)."""

import jax
import numpy as np
import pytest

from _torch_port_common import jax_wing, port_data, rel, seeded_state, t

TOL = 1e-12


@pytest.fixture(scope="module")
def state():
    return seeded_state(0)


def _jax_args():
    s = jax_wing()
    return s.stack, s.E, s.nu


def test_internal_energy(state):
    from goldfish_tpu.physics import kl_shell as jk
    from goldfish_tpu_torch.physics import kl_shell as tk

    cp, h, d, _, _ = state
    st, E, nu = _jax_args()
    data = port_data()
    W = jk.internal_energy(st, d, cp, h, E, nu)
    Wt = tk.internal_energy(data.stack, t(d), t(cp), t(h), data.E, data.nu)
    assert rel(Wt, W) <= TOL


def test_residual_and_thickness_gradient(state):
    from goldfish_tpu.physics import kl_shell as jk
    from goldfish_tpu_torch.physics import kl_shell as tk

    cp, h, d, _, _ = state
    st, E, nu = _jax_args()
    data = port_data()
    gd, gh = jax.grad(jk.internal_energy, argnums=(1, 3))(st, d, cp, h, E,
                                                          nu)
    W_e, r, dh = tk.shell_value_grad(data.stack, t(d), t(cp), t(h), data.E,
                                     data.nu)
    assert W_e.shape == data.stack.wq.shape[:2]
    assert rel(r, gd) <= TOL
    assert rel(dh, gh) <= TOL


def test_autograd_of_internal_energy(state):
    from goldfish_tpu_torch.physics import kl_shell as tk

    cp, h, d, _, _ = state
    data = port_data()
    dt, ht = t(d).requires_grad_(True), t(h).requires_grad_(True)
    tk.internal_energy(data.stack, dt, t(cp), ht, data.E, data.nu).backward()
    _, r, dh = tk.shell_value_grad(data.stack, t(d), t(cp), t(h), data.E,
                                   data.nu)
    assert rel(dt.grad, r.numpy()) == 0.0
    assert rel(ht.grad, dh.numpy()) == 0.0
    # dW/dcp (K1's geometry-gradient mode) against the JAX package's AD
    from goldfish_tpu.physics import kl_shell as jk

    st, E, nu = _jax_args()
    cpt = t(cp).requires_grad_(True)
    W = tk.internal_energy(data.stack, t(d), cpt, t(h), data.E, data.nu)
    W.backward()
    g_ref = jax.grad(jk.internal_energy, argnums=2)(st, d, cp, h, E, nu)
    assert rel(cpt.grad, g_ref) <= 1e-12


def test_element_hessians(state):
    from goldfish_tpu.physics import kl_shell as jk
    from goldfish_tpu_torch.physics import kl_shell as tk

    cp, h, d, _, _ = state
    st, E, nu = _jax_args()
    data = port_data()
    Ke = jk.element_hessians(st, d, cp, h, E, nu)
    Ket = tk.element_hessians(data.stack, t(d), t(cp), t(h), data.E,
                              data.nu)
    assert tuple(Ket.shape) == Ke.shape
    assert rel(Ket, Ke) <= TOL


def test_residual_vjp(state):
    from goldfish_tpu.physics import kl_shell as jk
    from goldfish_tpu_torch.physics import kl_shell as tk

    cp, h, d, lam, _ = state
    st, E, nu = _jax_args()
    data = port_data()

    def r_shell(cp_, h_):
        return jax.grad(jk.internal_energy, argnums=1)(st, d, cp_, h_, E, nu)

    _, vjp = jax.vjp(r_shell, cp, h)
    dcp, dh = vjp(-lam)
    dcpt, dht = tk.shell_adjoint(data.stack, t(d), t(cp), t(h), data.E,
                                 data.nu, t(lam))
    assert rel(dcpt, dcp) <= TOL
    assert rel(dht, dh) <= TOL


def test_padded_elements_contribute_exact_zeros(state):
    """Padded elements (zero quadrature weight) give exactly zero energy
    and Hessian, never NaN."""
    from goldfish_tpu_torch.physics import kl_shell as tk

    cp, h, d, _, _ = state
    data = port_data()
    pad = (data.stack.wq == 0).all(-1)
    assert bool(pad.any())
    W_e, _, _ = tk.shell_value_grad(data.stack, t(d), t(cp), t(h), data.E,
                                    data.nu)
    H = tk.shell_hessians(data.stack, t(d), t(cp), t(h), data.E, data.nu)
    assert bool((W_e[pad] == 0).all())
    assert bool((H[pad] == 0).all())
    assert bool(np.isfinite(H.numpy()).all())
