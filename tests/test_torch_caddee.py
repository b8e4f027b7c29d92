"""The port's CADDEE interface (`caddee.KLShellModel`) against the JAX
package's: both built from the same knot/CP lists and one name1..name6
intersection cache of the small box wing (n_sections=2, num_el=2, p=2),
the same system (the stack bit for bit, the free mask), `evaluate` under
an upward skin load to 1e-8 relative (two Newton solves to rtol 1e-9),
and the coupled adjoint d W_int / d(force amplitude) through `evaluate`
against central differences as in tests/test_caddee.py (1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import rel


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    from goldfish_tpu.caddee import KLShellModel as JModel

    from goldfish_tpu_torch.caddee import KLShellModel
    from goldfish_tpu_torch.geometry.nurbs import NURBS
    from goldfish_tpu_torch.geometry.preprocessing import Preprocessor
    from goldfish_tpu_torch.models import boxwing

    base = boxwing.build(n_sections=2, num_el=2, p=2, device="cpu")
    knot_list = [[np.asarray(k) for k in s.knots] for s in base.surfs]
    cp_list = [np.asarray(s.control) for s in base.surfs]
    cache = str(tmp_path_factory.mktemp("cad") / "int_data.npz")
    Preprocessor([NURBS(k, c) for k, c in zip(knot_list, cp_list)],
                 device="cpu").compute_intersections(
        rtol=2e-4).save_intersections_data(cache)
    kw = dict(bc_list=[[base.ids["rib0"], 1, 0]], int_data=cache,
              E=boxwing.E, nu=boxwing.NU, h_th=boxwing.H_TH)
    jm = JModel(knot_list, cp_list, **kw)
    pm = KLShellModel(knot_list, cp_list, device="cpu", **kw)
    return pm, jm, base.ids


def _load(sys_, ids, amp):
    f = np.zeros((sys_.num_splines, sys_.stack.max_cp, 3))
    f[ids["up0"], :, 2] = amp
    return f * np.asarray(sys_.stack.cp_mask)[..., None]


def test_klshellmodel_matches_jax(models):
    pm, jm, ids = models
    ps, js = pm.system, jm.system
    for field in js.stack._fields:
        assert np.array_equal(getattr(ps.stack, field).numpy(),
                              np.asarray(getattr(js.stack, field))), field
    assert np.array_equal(ps.data.free.numpy(), np.asarray(js.data.free))
    f = _load(js, ids, 50.0)
    d = pm.evaluate(f)
    d_ref = np.asarray(jm.evaluate(jnp.asarray(f)))
    assert bool(torch.isfinite(d).all())
    assert rel(d, d_ref) <= 1e-8
    u = ps.evaluate_displacement(d, ids["up1"], [0.5, 1.0])
    assert float(u[2]) > 0  # the upward load bends the wing up


def test_klshellmodel_coupled_adjoint_fd(models):
    pm, _, ids = models
    f0 = torch.tensor(_load(pm.system, ids, 1.0))

    def J(amp):
        return pm.internal_energy(pm.evaluate(amp * f0))

    amp0 = torch.tensor(40.0, dtype=torch.float64, requires_grad=True)
    with torch.enable_grad():
        (g,) = torch.autograd.grad(J(amp0), amp0)
    eps = 1e-3
    with torch.no_grad():
        fd = (J(amp0 + eps) - J(amp0 - eps)) / (2 * eps)
    assert abs(float(g - fd)) / abs(float(fd)) < 1e-6, (float(g), float(fd))
