"""The whole moving-intersection slice: scripts/bench_mi.py's shape
iteration (cp(amp) -> CP->xi solve -> MI Newton on the persistent factor
with the Woodbury seam correction -> internal energy J -> dJ/damp through
both implicit solves) as the port runs it on the small MI T-beam, cold at
amp = 0.05, against `jax.value_and_grad` of the same function in the JAX
package (direct mode): J 1e-10, dJ/damp 1e-6 (the BASELINE.md gradient
bar; mixed vs direct differ by ~1e-7), and against the port's own central
difference (eps 1e-5) 1e-5. Two warm steps with secant warm starts follow;
the CPU run launches no kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import jax_mi_tbeam, mi_bend, port_mi_tbeam

AMP = 0.05


def _jax_value_and_grad(amp):
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver import linalg

    s = jax_mi_tbeam()
    m = s.metas[1]
    bend = jnp.asarray(mi_bend(s))
    linalg.set_mode("direct")
    try:
        forward = s.build_forward(rtol=1e-9, max_it=30)

        def J(a):
            cp = s.cp.at[1, : m.n_cp, 0].add(a * bend)
            d, _ = forward(cp, s.h_init, s.zero_displacement())
            return kl_shell.internal_energy(s.stack, d, cp, s.h_init, s.E,
                                            s.nu)

        val, g = jax.value_and_grad(J)(jnp.asarray(amp))
    finally:
        linalg.set_mode(None)
    return float(val), float(g)


def _port_iteration(s, forward, amp, d0, xi0=None, grad=True):
    from goldfish_tpu_torch.physics import kl_shell

    m = s.metas[1]
    bend = torch.from_numpy(mi_bend(s))
    a = torch.tensor(amp, dtype=torch.float64, requires_grad=grad)
    cp = s.cp.clone()
    cp[1, : m.n_cp, 0] = cp[1, : m.n_cp, 0] + a * bend
    d, xi = forward(cp, s.h_init, d0, xi0)
    J = kl_shell.internal_energy(s.stack, d, cp, s.h_init, s.E, s.nu)
    if grad:
        J.backward()
        return float(J.detach()), float(a.grad), d.detach(), xi.detach()
    return float(J.detach())


@pytest.fixture(scope="module")
def port_run():
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart

    _cuda.reset_launch_counts()
    s = port_mi_tbeam()
    forward = s.build_forward(rtol=1e-9, max_it=30)
    J, g, d, xi = _port_iteration(s, forward, AMP, s.zero_displacement())
    ws_d, ws_xi = SecantWarmStart(), SecantWarmStart()
    a0 = torch.tensor(AMP, dtype=torch.float64)
    ws_d.update(a0, d)
    ws_xi.update(a0, xi)
    warm = []
    dk, xk = d, xi
    for k in (1, 2):
        ak = torch.tensor(AMP * (1.0 + 1e-3 * k), dtype=torch.float64)
        seed = ws_xi.predict(ak, xk).clamp(0.0, 1.0)
        Jk, gk, dk, xk = _port_iteration(s, forward, float(ak),
                                         ws_d.predict(ak, dk), seed)
        ws_d.update(ak, dk)
        ws_xi.update(ak, xk)
        warm.append((Jk, gk, dk, xk))
    counts = dict(_cuda.launch_counts)
    return dict(s=s, J=J, g=g, d=d, warm=warm, counts=counts,
                fac=forward.solve_d.device_factor)


def test_cold_iteration_matches_jax(port_run):
    J_ref, g_ref = _jax_value_and_grad(AMP)
    assert abs(port_run["J"] - J_ref) <= 1e-10 * abs(J_ref)
    assert abs(port_run["g"] - g_ref) <= 1e-6 * abs(g_ref)


def test_gradient_matches_central_difference(port_run):
    s = port_mi_tbeam()
    forward = s.build_forward(rtol=1e-11, max_it=30)
    eps = 1e-5
    Jp = _port_iteration(s, forward, AMP + eps, s.zero_displacement(),
                         grad=False)
    Jm = _port_iteration(s, forward, AMP - eps, s.zero_displacement(),
                         grad=False)
    fd = (Jp - Jm) / (2 * eps)
    assert abs(port_run["g"] - fd) <= 1e-5 * abs(fd)


def test_warm_steps_and_no_kernel_launch_on_cpu(port_run):
    for J, g, d, xi in port_run["warm"]:
        assert np.isfinite(J) and np.isfinite(g)
        assert bool(torch.isfinite(d).all()) and bool(torch.isfinite(xi).all())
    Js = [port_run["J"]] + [w[0] for w in port_run["warm"]]
    assert Js[0] > Js[1] > Js[2]      # bending the web further relieves it
    fac = port_run["fac"]
    assert fac.n_factor_failed == 0 and not fac.nonconverged
    assert all(n == 0 for n in port_run["counts"].values())
