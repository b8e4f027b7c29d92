"""The forward design tangents of the port against the JAX package's
`jax.jvp`, on the CPU, at seeded states (relative error in norm <= 1e-12:
f64 roundoff of two differently ordered but identical formulas). The JAX
numbers are stored by scripts/torch_port_design_jvp_reference.py in
tests/data/torch_port_design_jvp_reference.json (~70 s of JAX tracing):

- K1 mode 4's plain version (`kl_shell.shell_design_jvp`) against the jvp in
  (cp, h) of `jax.grad(internal_energy)` in d, and K2 mode 3's
  (`coupling.penalty_design_jvp`) against that of `penalty_energy`, on the
  small wing;
- the follower pressure's route (`loads.pressure_design_jvp`: K8 mode c at
  lambda = tcp) against the jvp in cp of -grad(follower_pressure_work), and
  against the plain jvp of the port's own pressure residual (<= 1e-13: the
  symmetry the route rests on), on the small tube;
- `system.residual_jvp` against the jvp of `system.residual` in (cp, h)
  on the small wing (dead load) and the small tube (follower pressure);
- on the OM MI T-beam at num_el=3 (p=2, 7 seam points): K6 mode 1's plain
  version (`coupling_mi.penalty_xi_jvp`) against the jvp in xi of
  `residual_mi`, K7 mode 4's (`cpiga2xi.c2x_res_jvp`) against the jvp in cp
  of `_c2x_res`, and `system_mi.residual_jvp_mi` against the jvp of
  `residual_mi` in (cp, h, xi).

CPU runs launch no kernel."""

import json
import os

import numpy as np
import pytest
import torch

from _torch_port_common import (
    OM_MI_SMALL,
    PRESSURE,
    TUBE_SMALL,
    design_tangents,
    jax_tube,
    om_mi_design_state,
    port_data,
    rel,
    seeded_state,
    t,
)

TOL = 1e-12
REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_design_jvp_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)


def _same_inputs(ref, key, arrays):
    got = [float(np.linalg.norm(a)) for a in arrays]
    assert np.allclose(got, ref["inputs"][key], rtol=1e-15, atol=0.0), key


@pytest.fixture(scope="module")
def wing(ref):
    cp, h, d, _, _ = seeded_state(0)
    state = (cp, h, d) + design_tangents(cp, h, 10)
    _same_inputs(ref, "wing", state)
    return port_data(), tuple(t(a) for a in state)


@pytest.fixture(scope="module")
def tube(ref):
    from goldfish_tpu_torch.models import tube as port_tube

    cp, h, d, _, _ = seeded_state(0, jax_tube())
    state = (cp, h, d) + design_tangents(cp, h, 11)
    _same_inputs(ref, "tube", state)
    ps = port_tube.build(**TUBE_SMALL, pressure=PRESSURE, device="cpu")
    return ps.data, tuple(t(a) for a in state)


@pytest.fixture(scope="module")
def mi(ref):
    from goldfish_tpu_torch.models import tbeam

    ps = tbeam.build_mi(**OM_MI_SMALL, device="cpu")
    state = om_mi_design_state(ps)
    _same_inputs(ref, "om_mi", state)
    return ps, tuple(t(a) for a in state)


def _want(ref, key, like):
    return np.asarray(ref[key]).reshape(tuple(like.shape))


def test_k1_design_mode_matches_jax(wing, ref):
    from goldfish_tpu_torch.physics import kl_shell

    data, (cp, h, d, tcp, th) = wing
    got = kl_shell.shell_design_jvp(data.stack, d, cp, h, data.E, data.nu,
                                    tcp, th)
    assert rel(got, _want(ref, "k1", got)) <= TOL


def test_k2_design_mode_matches_jax(wing, ref):
    from goldfish_tpu_torch.physics import coupling

    data, (cp, h, d, tcp, th) = wing
    got = coupling.penalty_design_jvp(data.ifs, d, cp, h, data.E, tcp, th)
    assert rel(got, _want(ref, "k2", got)) <= TOL


def test_pressure_route_matches_jax_and_the_plain_jvp(tube, ref):
    """r_p = -dW_p/dd: its cp-Jacobian is symmetric, so K8 mode c at lambda
    = tcp is its forward product."""
    from goldfish_tpu_torch.physics import loads

    data, (cp, h, d, tcp, _) = tube
    st, pr = data.stack, data.pressure
    got = loads.pressure_design_jvp(st, d, cp, pr, tcp)
    plain = loads._pressure_design_jvp_plain(st, d, cp, pr, tcp)
    assert rel(got, _want(ref, "pressure", got)) <= TOL
    assert rel(got, plain.numpy()) <= 1e-13


@pytest.mark.parametrize("which", ["wing", "tube"])
def test_residual_jvp_matches_jax(which, wing, tube, ref):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver.system import residual_jvp

    data, (cp, h, d, tcp, th) = wing if which == "wing" else tube
    assert (data.f_areal if which == "wing" else data.pressure) is not None
    _cuda.reset_launch_counts()
    got = residual_jvp(data, d, cp, h, tcp, th)
    assert rel(got, _want(ref, "residual_" + which, got)) <= TOL
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_k6_xi_mode_matches_jax(mi, ref):
    from goldfish_tpu_torch.physics import coupling_mi

    ps, (cp, h, xi, d, _, _, txi) = mi
    data, m, co, ss, p, q = ps.mi_args
    got = coupling_mi.penalty_xi_jvp(ss, p, q, m, co, xi, d, cp, h, data.E,
                                     txi) * data.free
    assert rel(got, _want(ref, "k6", got)) <= TOL


def test_k7_cp_mode_matches_jax(mi, ref):
    from goldfish_tpu_torch.geometry import cpiga2xi

    ps, (cp, _, xi, _, tcp, _, _) = mi
    c = ps.c2x
    got = cpiga2xi.c2x_res_jvp(c.ss, c.p, c.q, c.mi, cp, xi, tcp)
    assert rel(got, _want(ref, "k7", got)) <= TOL


def test_residual_jvp_mi_matches_jax(mi, ref):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver.system_mi import residual_jvp_mi

    ps, (cp, h, xi, d, tcp, th, txi) = mi
    _cuda.reset_launch_counts()
    got = residual_jvp_mi(*ps.mi_args, d, cp, h, xi, tcp, th, txi)
    assert rel(got, _want(ref, "residual_mi", got)) <= TOL
    assert all(n == 0 for n in _cuda.launch_counts.values())
    assert torch.count_nonzero(got) > 0
