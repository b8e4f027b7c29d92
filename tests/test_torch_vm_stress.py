"""The von Mises stress (K9's plain version) and the stress aggregation of
the port against the JAX package on the small plate (PLATE_SMALL):

- `kl_shell.stress_density` through `vm_stress_value` / `qp_stress_vm` vs
  `kl_shell.qp_stress_vm` for top, mid and bottom at the solved state plus
  seeded noise (1e-12 relative); no real qp of the solved plate has
  sigma = 0, where sqrt(max(v, 0)) has no derivative;
- the plain VJP in (d, cp, h) vs `jax.vjp` (1e-12);
- `objectives.max_vm_stress` (KS, pnorm, induced power) at the solved
  state: value 1e-12, gradients in (d, cp, h) 1e-10 (KS at rho = 50/m,
  pnorm and induced power at p = 50), 1e-6 (KS at the demo's rho = 100 /Pa,
  whose weights resolve 0.05 Pa of a ~1e6 Pa field);
- on a CUDA tensor the wrapper launches K9 or raises: without the library
  it raises instead of taking the plain path.

CPU runs launch no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import jax_plate, plate_state, port_plate, rel, t

THROUGH = ("top", "mid", "bottom")


def _jax_stress(through):
    from goldfish_tpu.physics import kl_shell as jk

    s = jax_plate()
    stack, E, nu = s.stack, s.E, s.nu
    return jax.jit(lambda d, cp, h: jk.qp_stress_vm(
        stack, d, cp, h, E, nu, through=through))


@pytest.mark.parametrize("through", THROUGH)
def test_stress_matches_jax(through):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, d, dn, _ = plate_state()
    s = port_plate()
    _cuda.reset_launch_counts()
    got = kl_shell.vm_stress_value(s.stack, t(dn), t(cp), t(h), s.E, s.nu,
                                   kl_shell.ZETA[through])
    ref = np.asarray(_jax_stress(through)(dn, cp, h))
    assert rel(got, ref) <= 1e-12
    auto = kl_shell.qp_stress_vm(s.stack, t(dn), t(cp), t(h), s.E, s.nu,
                                 through=through)
    assert torch.equal(auto, got)
    # the sqrt trap: every real qp of the solved plate is stressed
    sol = kl_shell.qp_stress_vm(s.stack, t(d), t(cp), t(h), s.E, s.nu,
                                through=through)
    assert float(sol[s.stack.wq > 0].min()) > 1e-6 * float(sol.max())
    assert all(n == 0 for n in _cuda.launch_counts.values())


@pytest.mark.parametrize("through", ["top", "bottom"])
def test_stress_vjp_matches_jax(through):
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, _, dn, gbar = plate_state()
    s = port_plate()
    got = kl_shell.vm_stress_vjp(s.stack, t(dn), t(cp), t(h), s.E, s.nu,
                                 kl_shell.ZETA[through], t(gbar))
    _, f = jax.vjp(_jax_stress(through), jnp.asarray(dn), jnp.asarray(cp),
                   jnp.asarray(h))
    for name, a, b in zip(("d", "cp", "h"), got, f(jnp.asarray(gbar))):
        assert rel(a, np.asarray(b)) <= 1e-12, name
    # the autograd Function's backward is the same VJP
    args = [t(x).requires_grad_(True) for x in (dn, cp, h)]
    kl_shell.qp_stress_vm(s.stack, *args, s.E, s.nu, through=through
                          ).backward(t(gbar))
    for a, b in zip(args, got):
        assert torch.equal(a.grad, b)


def _max_stress_m():
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, d, _, _ = plate_state()
    s = port_plate()
    sig = kl_shell.qp_stress_vm(s.stack, t(d), t(cp), t(h), s.E, s.nu)
    return float(sig[s.stack.wq > 0].max())


@pytest.mark.parametrize("method,rho,tol", [
    ("KS", "50/m", 1e-10), ("KS", 100.0, 1e-6), ("pnorm", 50.0, 1e-10),
    ("induced power", 50.0, 1e-10)])
def test_max_vm_stress_matches_jax(method, rho, tol):
    from goldfish_tpu.physics import objectives as jo
    from goldfish_tpu_torch.physics import objectives

    if rho == "50/m":
        rho = 50.0 / _max_stress_m()
    cp, h, d, _, _ = plate_state()
    jdata = jax_plate().data
    ref, g_ref = jax.jit(jax.value_and_grad(
        lambda dd, c, hh: jo.max_vm_stress(jdata, dd, c, hh, rho=rho,
                                           method=method),
        argnums=(0, 1, 2)))(jnp.asarray(d), jnp.asarray(cp), jnp.asarray(h))
    s = port_plate()
    args = [t(x).requires_grad_(True) for x in (d, cp, h)]
    val = objectives.max_vm_stress(s.data, *args, rho=rho, method=method)
    val.backward()
    assert abs(float(val.detach()) - float(ref)) <= 1e-12 * abs(float(ref))
    for name, a, b in zip(("d", "cp", "h"), args, g_ref):
        assert rel(a.grad, np.asarray(b)) <= tol, name


def test_cuda_tensor_without_the_library_raises(monkeypatch, tmp_path):
    """The dispatch of `on_cuda` is the only way to the plain path: a
    tensor the rule sends to the kernel raises when the kernel cannot be
    built, rather than falling back."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, d, _, gbar = plate_state()
    s = port_plate()
    monkeypatch.setattr(_cuda, "on_cuda", lambda x: True)
    monkeypatch.setattr(_cuda, "_lib", None)
    monkeypatch.setattr(_cuda, "_BUILD", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        kl_shell.vm_stress_value(s.stack, t(d), t(cp), t(h), s.E, s.nu, 0.5)
    with pytest.raises(RuntimeError, match="nvcc"):
        kl_shell.vm_stress_vjp(s.stack, t(d), t(cp), t(h), s.E, s.nu, 0.5,
                               t(gbar))
    assert _cuda.launch_counts["vm_stress_qp/value"] == 0
