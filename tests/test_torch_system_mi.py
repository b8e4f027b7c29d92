"""The port's moving-intersection system (solver/system_mi) against
goldfish_tpu/solver/system_mi on the small MI T-beam: potential, residual
and dense tangent at a seeded state (1e-12); point loads on the fixed-intersection
T-beam (1e-12, and bridged bit for bit); the Woodbury-corrected IR solve
on a factor made stale by a design step that moved the seam (certificate
1e-6, backward error 1e-12, agreement with a fresh direct solve 1e-6,
without refactoring); and the seeded IR solve (never more sweeps than the
unseeded one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import (
    jax_mi_tbeam,
    mi_cp,
    mi_state,
    port_data,
    port_mi_tbeam,
    rel,
    seeded_state,
    t,
)

TOL = 1e-12


@pytest.mark.parametrize("what", ["total_potential_mi", "residual_mi",
                                  "assemble_K_mi"])
def test_residual_and_tangent_match(what):
    from goldfish_tpu.solver import system_mi as jsm
    from goldfish_tpu_torch.solver import system_mi as psm

    js, ps = jax_mi_tbeam(), port_mi_tbeam()
    cp, h, xi, d, _ = mi_state(3)
    J = jnp.asarray
    ref = getattr(jsm, what)(js.data, js.mi, js.co, js.ss, js.pdeg,
                             js.qdeg, J(d), J(cp), J(h), J(xi))
    got = getattr(psm, what)(*ps.mi_args, t(d), t(cp), t(h), t(xi))
    assert rel(got, ref) <= TOL


def test_point_loads_on_the_fixed_tbeam():
    """tbeam.build (fixed seam, tip point load): the port's own data and
    the bridged JAX data agree, and so do the residuals at a seeded d."""
    from goldfish_tpu.models import tbeam as jt
    from goldfish_tpu.solver import system as jsys
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.models import tbeam as pt
    from goldfish_tpu_torch.solver import system as psys

    js = jt.build(num_el=4, p=3)
    ps = pt.build(num_el=4, p=3, device="cpu")
    bridged = from_numpy_tree(js.data, device="cpu")
    for f in ("patch", "conn", "R0", "F"):
        assert np.array_equal(getattr(ps.data.point_loads, f).numpy(),
                              getattr(bridged.point_loads, f).numpy()), f
    cp, h = np.array(js.cp), np.array(js.h_init)
    rng = np.random.default_rng(8)
    d = 1e-3 * rng.normal(size=cp.shape) * np.asarray(js.data.free)
    ref = jsys.residual(js.data, jnp.asarray(d), jnp.asarray(cp),
                        jnp.asarray(h))
    for data in (ps.data, bridged):
        got = psys.residual(data, t(d), t(cp), t(h))
        assert rel(got, ref) <= TOL
    W_ref = jsys.total_potential(js.data, jnp.asarray(d), jnp.asarray(cp),
                                 jnp.asarray(h))
    W = psys.total_potential(ps.data, t(d), t(cp), t(h))
    assert abs(float(W) - float(W_ref)) <= TOL * abs(float(W_ref))


@pytest.fixture(scope="module")
def stale_mi():
    """A factor pinned at the converged state of amp = 0.05 and the
    converged state of the design step amp = 0.05 * 1.01 (which moves the
    seam)."""
    from goldfish_tpu_torch.solver import system_mi as psm

    ps = port_mi_tbeam()
    h = ps.h_init
    cp0 = t(mi_cp(jax_mi_tbeam(), 0.05))
    cp1 = t(mi_cp(jax_mi_tbeam(), 0.05 * 1.01))
    xi0 = ps.c2x.solve(cp0)
    xi1 = ps.c2x.solve(cp1, xi0)
    fac = psm.PersistentDeviceFactorMI(*ps.mi_args)
    d0, _, _ = psm.newton_solve_mi_host(*ps.mi_args, cp0, h, xi0,
                                        ps.zero_displacement(), rtol=1e-9,
                                        device_fac=fac)
    d1, _, _ = psm.newton_solve_mi_host(*ps.mi_args, cp1, h, xi1, d0,
                                        rtol=1e-9, device_fac=fac)
    fac.ensure(cp0, h, xi0, d0, force=True, why="test")
    r1 = psm.residual_mi(*ps.mi_args, d1, cp1, h, xi1)
    return ps, fac, (cp1, h, xi1, d1), -r1


def test_woodbury_corrected_solve_is_exact(stale_mi):
    from goldfish_tpu_torch.solver import system_mi as psm

    ps, fac, s1, b = stale_mi
    assert float(torch.linalg.norm(s1[2] - fac._ref[2])) > 0.0
    _, ratio_plain, _ = fac._ir_solve(s1, b, 2)   # no correction
    nf = fac.n_factor
    assert fac.prepare(*s1) and fac.n_factor == nf
    _, ratio_wb, _ = fac._ir_solve(s1, b, 2)
    assert float(ratio_wb) < float(ratio_plain)
    x = fac.exact_solve(*s1, b)
    assert fac.last_ratio <= 1e-6 and not fac.nonconverged
    assert fac.n_factor == nf
    K1 = psm.assemble_K_mi(*ps.mi_args, s1[3], s1[0], s1[1], s1[2])
    res = b.reshape(-1) - K1 @ x.reshape(-1)
    backward_err = res.norm() / (torch.linalg.matrix_norm(K1, 2) * x.norm())
    assert float(backward_err) <= 1e-12
    x_ref = torch.linalg.solve(K1, b.reshape(-1)).reshape(b.shape)
    assert rel(x, x_ref.numpy()) <= 1e-6


@pytest.mark.parametrize("problem", ["wing", "mi"])
def test_seeded_solve_takes_no_more_sweeps(problem, stale_mi):
    """exact_solve(x0=) from a nearby solution certifies with no more
    sweeps than the unseeded solve of the same system."""
    if problem == "mi":
        _, fac, s, b = stale_mi
    else:
        from goldfish_tpu_torch.solver import system as ts
        from goldfish_tpu_torch.solver.devicechol import (
            PersistentDeviceFactor,
        )

        cp, h, _, lam, _ = (t(a) for a in seeded_state(0))
        data = port_data()
        zero = torch.zeros_like(cp)
        K0 = ts.assemble_K(data, zero, cp, h)
        r0 = ts.residual(data, zero, cp, h)
        d_lin = torch.linalg.solve(K0, -r0.reshape(-1)).reshape(r0.shape)
        fac = PersistentDeviceFactor(data)
        fac.ensure(cp, h, 0.9 * d_lin, why="test")
        s, b = (cp, h, d_lin), lam * data.free
    x_prev = fac.exact_solve(*s, 1.001 * b)
    n_unseeded = fac.cert_log[-1][1]
    x = fac.exact_solve(*s, b, x0=1.001 ** -1 * x_prev)
    tag, n_seeded, ratio = fac.cert_log[-1]
    assert tag == "exact-x0" and ratio <= 1e-6
    assert n_seeded <= n_unseeded
    assert bool(torch.isfinite(x).all())


def test_solve_nonlinear_is_the_coupled_mi_solve():
    """MINonMatchingSystem.solve_nonlinear solves xi = c2x.solve(cp), then
    the MI Newton at xi: the same d as `build_forward`'s coupled solve
    (1e-8), and within 2e-2 of the fixed-seam T-beam's u_z at the loaded
    corner (the reference's test_system_mi.py:43-54)."""
    from goldfish_tpu_torch.models import tbeam as pt

    ps = pt.build_mi(num_el=4, p=3, n_pts=9, device="cpu")
    d = ps.solve_nonlinear(rtol=1e-11)
    d_fwd, _ = ps.build_forward(rtol=1e-11)(ps.cp, ps.h_init,
                                            ps.zero_displacement())
    assert rel(d, d_fwd.detach().numpy()) <= 1e-8
    static = pt.build(num_el=4, p=3, device="cpu")
    u_static = static.evaluate_displacement(
        static.solve_nonlinear(rtol=1e-11), 0, [1.0, 1.0])
    u_mi = ps.evaluate_displacement(d, 0, [1.0, 1.0])
    assert abs(u_mi[2]) > 0.0
    assert abs(u_mi[2] - u_static[2]) / abs(u_static[2]) < 2e-2
