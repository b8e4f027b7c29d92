"""The operations layer of the port (`DispImOperation`, the explicit
operations) against the JAX package's on the small plate (PLATE_SMALL),
over the same flat real-dof numpy vectors (clamped dofs included):

- `apply_nonlinear` (1e-12), `solve_nonlinear` (1e-8 of JAX's solution);
- `apply_linear_rev` (all three outputs, the JAX package's + sign) and
  `apply_linear_fwd` in d and in (cp, h) (the CPU-only design tangent),
  1e-10;
- `solve_linear_rev` (1e-8), and the manual adjoint (solve_linear_rev +
  apply_linear_rev, what OpenMDAO's reverse mode runs) against the JAX
  package's `jax.grad` through its implicit solve (1e-6);
- each explicit operation's `compute` / `gradients` (1e-10; the KS stress
  at rho = 50/m, test_torch_vm_stress.py holds the demo's rho = 100).

CPU runs launch no kernel."""

import jax
import numpy as np
import pytest

from _torch_port_common import jax_plate, plate_state, port_plate, rel


def _flat(lay, x, k=3):
    x = np.asarray(x)
    return np.asarray(lay.to_flat(x if k == 3 else x[..., None])).ravel()


@pytest.fixture(scope="module")
def ops():
    from goldfish_tpu.operations import DispImOperation as JaxDisp
    from goldfish_tpu_torch.operations import DispImOperation

    js = jax_plate()
    jop = JaxDisp(js, rtol=1e-12)
    pop = DispImOperation(port_plate(), rtol=1e-12)
    cp, h, d, dn, _ = plate_state()
    lay = jop.layout
    vec = dict(cp=_flat(lay, cp), h=_flat(lay, h, 1), d=_flat(lay, d),
               dn=_flat(lay, dn))
    return jop, pop, vec


def test_apply_nonlinear_matches_jax(ops):
    from goldfish_tpu_torch import _cuda

    jop, pop, v = ops
    _cuda.reset_launch_counts()
    got = pop.apply_nonlinear(v["cp"], v["h"], v["dn"])
    assert rel(got, jop.apply_nonlinear(v["cp"], v["h"], v["dn"])) <= 1e-12
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_solve_nonlinear_matches_jax(ops):
    from goldfish_tpu_torch.operations import DispImOperation

    jop, _, v = ops
    pop = DispImOperation(port_plate(), rtol=1e-12)
    d = pop.solve_nonlinear(v["cp"], v["h"])
    d_ref = jop.solve_nonlinear(v["cp"], v["h"])
    assert rel(d, d_ref) <= 1e-8
    r = pop.apply_nonlinear(v["cp"], v["h"], d)
    r0 = pop.apply_nonlinear(v["cp"], v["h"], 0 * d)
    assert np.linalg.norm(r) <= 1e-7 * np.linalg.norm(r0)


def test_apply_linear_matches_jax(ops):
    jop, pop, v = ops
    rng = np.random.default_rng(7)
    for op in (jop, pop):
        op.linearize(v["cp"], v["h"], v["dn"])
    d_r = rng.normal(size=v["d"].size)
    for name, a, b in zip(("cp", "h", "d"), pop.apply_linear_rev(d_r),
                          jop.apply_linear_rev(d_r)):
        assert rel(a, b) <= 1e-10, name
    t_cp = 1e-3 * rng.normal(size=v["cp"].size)
    t_h = 1e-3 * rng.normal(size=v["h"].size)
    t_d = rng.normal(size=v["d"].size)
    for kw in (dict(d_d=t_d), dict(d_cp=t_cp), dict(d_h=t_h),
               dict(d_cp=t_cp, d_h=t_h, d_d=t_d)):
        assert rel(pop.apply_linear_fwd(**kw), jop.apply_linear_fwd(**kw)) \
            <= 1e-10, sorted(kw)


def test_solve_linear_and_manual_adjoint_match_jax(ops):
    """K lam = dJ/dd at the solved state, then dJ/dh = partial - h_bar
    (OpenMDAO's reverse mode) against the JAX package's jax.grad."""
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver.implicit import build_solve_fn
    from goldfish_tpu_torch.operations import IntEnergyExOperation

    jop, pop, v = ops
    js = jax_plate()
    for op in (jop, pop):
        op.linearize(v["cp"], v["h"], v["d"])
    _, dJdh_partial, dJdd = IntEnergyExOperation(pop.system).gradients(
        v["cp"], v["h"], v["d"])
    lam = pop.solve_linear_rev(dJdd)
    assert rel(lam, jop.solve_linear_rev(dJdd)) <= 1e-8
    dJdh = dJdh_partial - pop.apply_linear_rev(lam)[1]

    solve = build_solve_fn(js.data, rtol=1e-12, max_it=30)

    def J(h_pad):
        dd = solve(js.cp, h_pad, js.zero_displacement())
        return kl_shell.internal_energy(js.stack, dd, js.cp, h_pad, js.E,
                                        js.nu)

    g = jax.grad(J)(js.h_init)
    assert rel(dJdh, _flat(jop.layout, g, 1)) <= 1e-6


def _custom_fn(data, d, cp, h):
    # one expression for both packages: tip-direction work weighted by h
    # and x, so each of (d, cp, h) has a nonzero partial
    return (d[..., 2] * h * cp[..., 0]).sum()


@pytest.mark.parametrize("name", ["IntEnergy", "Volume", "Compliance",
                                  "MaxvMStress", "Custom"])
def test_explicit_operations_match_jax(ops, name):
    from goldfish_tpu.operations import custom_exop as jc
    from goldfish_tpu.operations import exops as jx
    from goldfish_tpu_torch.operations import custom_exop as pc
    from goldfish_tpu_torch.operations import exops as px

    jop, pop, v = ops
    kw = {}
    if name == "Custom":
        jx, px, kw = jc, pc, dict(fn=_custom_fn)
    if name == "MaxvMStress":
        from goldfish_tpu_torch.physics import kl_shell

        s = pop.system
        lay = pop.layout
        sig = kl_shell.qp_stress_vm(
            s.stack, lay.to_padded(pop._t(v["d"]).reshape(-1, 3)), s.cp,
            s.h_init, s.E, s.nu)
        kw = dict(rho=50.0 / float(sig.max()))
    cls = name + "ExOperation"
    jo = getattr(jx, cls)(jax_plate(), **kw)
    po = getattr(px, cls)(pop.system, **kw)
    args = (v["cp"], v["h"], v["d"])
    ref = jo.compute(*args)
    assert abs(po.compute(*args) - ref) <= 1e-10 * abs(ref)
    for i, (a, b) in enumerate(zip(po.gradients(*args), jo.gradients(*args))):
        b = np.asarray(b)
        if np.linalg.norm(b) == 0.0:
            assert np.linalg.norm(a) == 0.0, i
        else:
            assert rel(a, b) <= 1e-10, i
