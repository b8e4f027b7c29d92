"""The port's areal field load, field-input implicit solve and coupled
VLM-aeroelastic demo against the JAX package: the field load's Pi and r at
a seeded state (1e-12), the residual VJP in (cp, h, f) against jax.vjp
(1e-11), K v unchanged by the field, and the coupled demo at the size of
the reference's tests/test_vlm.py coupled test (2 x 3 patches, num_el=2,
p=2, 5 x 8 panels, 3 passes) against
tests/data/torch_port_vlm_reference.json (W_int, lift and tip 1e-8,
dW_int/dh 1e-6) with the demo's own central-difference check (< 1e-5).
The JAX coupled test is slow-marked, so the demo is held to the JSON
(scripts/torch_port_vlm_reference.py) instead of a JAX rerun."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import rel, t

WING = dict(n_chord=2, n_span=3, num_el=2, p=2)
REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_vlm_reference.json")


@pytest.fixture(scope="module")
def field_state():
    """(port wing, cp, h, d, f, lam, v, refs): the 2 x 3 wing with its dead
    load, a seeded d, field f, adjoint lam and vector v (numpy), and the JAX
    package's numbers at that state from one jitted function (one
    compilation for the module)."""
    from goldfish_tpu.models import wing as jw
    from goldfish_tpu.physics import loads as jl
    from goldfish_tpu.solver import system as jsys
    from goldfish_tpu_torch.models import wing as pw

    js = jw.build(**WING)
    ps = pw.build(**WING, device="cpu")
    cp, h = np.asarray(js.cp), np.asarray(js.h_init)
    mask = np.asarray(js.stack.cp_mask)[..., None]
    rng = np.random.default_rng(21)
    d = 1e-3 * rng.normal(size=cp.shape) * np.asarray(js.data.free)
    f = 40.0 * rng.normal(size=cp.shape) * mask
    lam = rng.normal(size=cp.shape)
    v = rng.normal(size=cp.shape)
    data = js.data

    @jax.jit
    def refs(d, cp, h, f, lam, v):
        df = data._replace(f_field=f)
        W_f, F_f = jax.value_and_grad(jl.areal_field_work, argnums=1)(
            data.stack, d, cp, f)
        _, vjp = jax.vjp(lambda c, hh, ff: jsys.residual(
            data._replace(f_field=ff), d, c, hh), cp, h, f)
        return {"Pi": jsys.total_potential(df, d, cp, h),
                "r": jsys.residual(df, d, cp, h), "W_f": W_f, "F_f": F_f,
                "vjp": vjp(-lam),
                "Kv": jsys.tangent_matvec(df, d, cp, h, v)}

    J = jnp.asarray
    out = jax.device_get(refs(J(d), J(cp), J(h), J(f), J(lam), J(v)))
    return ps, cp, h, d, f, lam, v, out


def test_field_load_potential_and_residual(field_state):
    from goldfish_tpu_torch.physics import loads as pl
    from goldfish_tpu_torch.solver import system as psys

    ps, cp, h, d, f, _, _, ref = field_state
    pd = ps.data._replace(f_field=t(f))
    Pi = float(psys.total_potential(pd, t(d), t(cp), t(h)))
    assert abs(Pi - float(ref["Pi"])) <= 1e-12 * abs(float(ref["Pi"]))
    assert rel(psys.residual(pd, t(d), t(cp), t(h)), ref["r"]) <= 1e-12
    # the field's own work and force, apart from the shell's and the dead
    # load's
    W = float(pl.areal_field_work(ps.stack, t(d), t(cp), t(f)))
    assert abs(W - float(ref["W_f"])) <= 1e-12 * abs(float(ref["W_f"]))
    assert rel(pl.areal_field_force(ps.stack, t(cp), t(f)),
               ref["F_f"]) <= 1e-12


def test_field_residual_vjp(field_state):
    """-lam^T dR/d(cp, h, f) against jax.vjp of the reference's residual
    (the signs of its field solve's vjp(-lam))."""
    from goldfish_tpu_torch.solver import system as psys

    ps, cp, h, d, f, lam, _, ref = field_state
    got = psys.residual_vjp_field(ps.data._replace(f_field=t(f)), t(d),
                                  t(cp), t(h), t(lam))
    for g, r, name in zip(got, ref["vjp"], ("cp", "h", "f")):
        assert rel(g, r) <= 1e-11, name


def test_tangent_unchanged_by_field(field_state):
    from goldfish_tpu_torch.solver import system as psys

    ps, cp, h, d, f, _, v, ref = field_state
    Kv = psys.tangent_matvec(ps.data._replace(f_field=t(f)), t(d), t(cp),
                             t(h), t(v))
    assert torch.equal(Kv, psys.tangent_matvec(ps.data, t(d), t(cp), t(h),
                                               t(v)))
    assert rel(Kv, ref["Kv"]) <= 1e-12


def test_coupled_demo_matches_reference():
    """The port's demo `main` on the CPU at the reference's coupled-test
    size: W_int, lift, tip displacement and dW_int/dh against the JAX
    package's numbers, and the FD check the demo asserts. No kernel is
    launched on CPU tensors."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos.vlm_aeroelastic_wing import main

    with open(REF) as fh:
        ref = json.load(fh)["test"]
    size = {k: v for k, v in ref["size"].items()}
    _cuda.reset_launch_counts()
    J, lift, tip, gh, fd_rel, _ = main(**size, verbose=False, device="cpu")
    assert all(n == 0 for n in _cuda.launch_counts.values())
    assert abs(J - ref["J"]) <= 1e-8 * abs(ref["J"])
    assert abs(lift - ref["lift"]) <= 1e-8 * abs(ref["lift"])
    assert rel(tip, ref["tip"]) <= 1e-8
    assert rel(gh, ref["dW_dh"]) <= 1e-6
    assert fd_rel < 1e-5
    assert J > 0 and lift > 0 and tip[2] > 0   # lift bends the wing up


def test_set_areal_field_puts_the_field_into_data(field_state):
    """NonMatchingSystem.set_areal_field: the system's data carries the
    field, and its residual is the one of the data with f_field set."""
    from goldfish_tpu_torch.models import wing as pw
    from goldfish_tpu_torch.solver import system as psys

    _, cp, h, d, f, _, _, _ = field_state
    s = pw.build(**WING, device="cpu")
    r0 = psys.residual(s.data, t(d), t(cp), t(h))
    s.set_areal_field(f)
    assert torch.equal(s.data.f_field, t(f))
    r = psys.residual(s.data, t(d), t(cp), t(h))
    assert torch.equal(r, psys.residual(s.data._replace(f_field=t(f)), t(d),
                                        t(cp), t(h)))
    assert not torch.equal(r, r0)
