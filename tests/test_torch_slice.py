"""The whole slice: bench.py's opt_iteration (ThicknessFFD -> Newton solve
-> internal energy J -> adjoint dJ/dh_ffd) as the port runs it, against
`jax.value_and_grad` of the same function in the JAX package, under its
device-factor path ("mixed", the same algorithm as the port) and its
default direct path (the same answer). A cold iteration, then a warm one
seeded by SecantWarmStart. Tolerances: J 1e-8, d 1e-6, dJ/dh_ffd 1e-6
(the BASELINE.md gradient bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import FFD_SMALL, WING_SMALL, rel

STEP = 1e-3  # relative design step of the warm iteration


def _jax_iterations(mode):
    from goldfish_tpu.design.pipeline import ThicknessFFD
    from goldfish_tpu.models import wing
    from goldfish_tpu.opt.warmstart import SecantWarmStart
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver import linalg
    from goldfish_tpu.solver.implicit import build_solve_fn

    linalg.set_mode(mode)
    try:
        s = wing.build(**WING_SMALL)
        th = ThicknessFFD(s, **FFD_SMALL)
        solve = build_solve_fn(s.data, rtol=1e-9, max_it=30)

        def opt_iteration(h_ffd, d0):
            h = th(h_ffd)
            d = solve(s.cp, h, d0)
            return kl_shell.internal_energy(s.stack, d, s.cp, h, s.E,
                                            s.nu), d

        vg = jax.value_and_grad(opt_iteration, has_aux=True)
        h0 = jnp.asarray(th.init_h_ffd(wing.H_TH))
        (J0, d0), g0 = vg(h0, s.zero_displacement())
        ws = SecantWarmStart()
        ws.update(h0, d0)
        h1 = h0 * (1.0 + STEP)
        (J1, d1), g1 = vg(h1, ws.predict(h1, d0))
    finally:
        linalg.set_mode(None)
    return [(float(J), np.asarray(d), np.asarray(g))
            for J, d, g in ((J0, d0, g0), (J1, d1, g1))]


@pytest.fixture(scope="module")
def port_iterations():
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn

    s = wing.build(**WING_SMALL, device="cpu")
    th = ThicknessFFD(s, **FFD_SMALL)
    solve = build_solve_fn(s.data, rtol=1e-9, max_it=30)

    def opt_iteration(h_ffd, d0):
        hf = h_ffd.clone().requires_grad_(True)
        h = th(hf)
        d = solve(s.cp, h, d0)
        J = kl_shell.internal_energy(s.stack, d, s.cp, h, s.E, s.nu)
        J.backward()
        return float(J.detach()), d.detach(), hf.grad

    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64)
    J0, d0, g0 = opt_iteration(h0, s.zero_displacement())
    ws = SecantWarmStart()
    ws.update(h0, d0)
    h1 = h0 * (1.0 + STEP)
    J1, d1, g1 = opt_iteration(h1, ws.predict(h1, d0))
    fac = solve.device_factor
    assert fac.n_factor >= 1 and fac.n_factor_failed == 0
    return [(J0, d0.numpy(), g0.numpy()), (J1, d1.numpy(), g1.numpy())]


@pytest.mark.parametrize("mode", ["mixed", "direct"])
def test_opt_iteration_matches_jax(port_iterations, mode):
    ref = _jax_iterations(mode)
    for k, ((J, d, g), (Jr, dr, gr)) in enumerate(zip(port_iterations,
                                                       ref)):
        assert d.shape == dr.shape and g.shape == gr.shape
        assert np.isfinite(g).all()
        assert abs(J - Jr) <= 1e-8 * abs(Jr), (k, J, Jr)
        assert rel(d, dr) <= 1e-6, k
        assert rel(g, gr) <= 1e-6, k
