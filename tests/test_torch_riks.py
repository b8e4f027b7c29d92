"""Crisfield arc-length continuation in the port (solver/riks.py) and the
LU variant of the persistent factor it polishes on, against the JAX
package:

- `_arc_root` on the same numbers as the JAX package's (both roots, the
  root choice and the "arc too small" case);
- R and q = -dR/dlam at a seeded state of the small follower-pressure tube
  (num_el=3) against the JAX `_R_q`, whose q is a `jax.jvp` through
  `scale_loads` (1e-12);
- tests/test_riks.py's shallow-panel snap-through at num_el=6 against
  tests/data/torch_port_contact_reference.json (the final d 1e-6, lam_peak
  1e-3; written by scripts/torch_port_contact_reference.py) and the JAX
  test's own criteria;
- the LU factor's substitution solves K x = b as the dense solve does, and
  an unknown factor kind raises.

CPU runs launch no kernel."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import jax_tube, port_panel, port_press, \
    press_state, rel, t

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_contact_reference.json")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_arc_root_matches_jax(seed):
    from goldfish_tpu.solver.riks import _arc_root as jax_root
    from goldfish_tpu_torch.solver.riks import _arc_root

    rng = np.random.default_rng(seed)
    Dd, dd_r, dd_q = (rng.normal(size=(2, 5, 3)) for _ in range(3))
    Dlam, q2, psi = rng.normal(), abs(rng.normal()) * 10, 1.0
    for dl in (0.1, 3.0, 30.0):
        want = jax_root(*(jnp.asarray(a) for a in (Dd,)), Dlam,
                        jnp.asarray(dd_r), jnp.asarray(dd_q), q2, dl, psi)
        got = _arc_root(t(Dd), Dlam, t(dd_r), t(dd_q), q2, dl, psi)
        assert (got is None) == (want is None)
        if want is not None:
            assert abs(got - want) <= 1e-12 * max(abs(want), 1.0)


def test_R_and_q_match_jax_on_the_pressurized_tube():
    from goldfish_tpu.solver.riks import _R_q as jax_R_q
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.solver.riks import _R_q

    s = jax_tube()
    rng = np.random.default_rng(4)
    cp, h = np.asarray(s.cp), np.asarray(s.h_init)
    free = np.asarray(s.data.free)
    d = 1e-3 * rng.normal(size=cp.shape) * free
    lam = 0.7
    R_ref, q_ref = jax_R_q(s.data, jnp.asarray(cp), jnp.asarray(h),
                           jnp.asarray(d), jnp.asarray(lam))
    data = from_numpy_tree(s.data, device="cpu")
    R, q = _R_q(data, t(cp), t(h), t(d), lam)
    assert float(np.linalg.norm(q_ref)) > 0.0
    assert rel(R, R_ref) <= 1e-12
    assert rel(q, q_ref) <= 1e-12


def test_riks_snap_through_matches_reference():
    """tests/test_riks.py at num_el=6: the path reaches lam = 1 at
    equilibrium, descends through the limit point and snaps through; the
    final d and the limit load agree with the JAX package's."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver.riks import riks_solve
    from goldfish_tpu_torch.solver.system import residual, scale_loads

    with open(REF) as fh:
        ref = json.load(fh)["riks6"]
    s = port_panel(num_el=6)
    d0 = s.zero_displacement()
    stats = {}
    _cuda.reset_launch_counts()
    d, lam, path = riks_solve(s.data, s.cp, s.h_init, d0, lam_target=1.0,
                              dlam0=0.02, rtol=1e-6, dl_max=60.0,
                              max_steps=150, stats=stats)
    lams = np.array([p[0] for p in path])
    norms = np.array([p[1] for p in path])
    assert lam == 1.0 and lams[-1] == 1.0
    data1 = scale_loads(s.data, 1.0)
    rn = float(torch.linalg.norm(residual(data1, d, s.cp, s.h_init)))
    q0 = float(torch.linalg.norm(residual(data1, d0, s.cp, s.h_init)))
    assert rn < 1e-5 * q0
    i_peak = int(np.argmax(lams[: len(lams) // 2]))
    assert lams[i_peak] > lams[i_peak:].min() + 0.2
    assert norms[-1] > 3.0 * norms[: i_peak + 1].max()
    assert rel(d, ref["d"]) <= 1e-6
    assert abs(lams[i_peak] - ref["lam_peak"]) <= 1e-3
    assert stats["n_lu"] >= stats["steps"]
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_lu_factor_solves_like_the_dense_solve():
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.system import assemble_K

    s = port_press(num_el=3)
    cp, h, d, _, b = press_state(s, seed=5)
    fac = PersistentDeviceFactor(s.data, kind="lu")
    fac.ensure(t(cp), t(h), t(d))
    assert fac.factor_ok and fac.n_factor == 1 and fac.failed_info == []
    free = s.data.free
    x = fac.exact_solve(t(cp), t(h), t(d), t(b) * free)
    K = assemble_K(s.data, t(d), t(cp), t(h))
    want = torch.linalg.solve(K, (t(b) * free).reshape(-1))
    assert rel(x.reshape(-1), want) <= 1e-10
    with pytest.raises(ValueError, match="kind"):
        PersistentDeviceFactor(s.data, kind="qr")
