"""The moving-intersection route with contact and the areal field load:
the T-beam driven into a stop plate (`port_tbeam_stop` at
TBEAM_STOP_SMALL: num_el=4, p=2, 5 seam points, a clamped plate above the
outer 30% of the span, an upward field load of 80 on the flange, contact
(flange, stop); N = 252) against the JAX package's numbers in
tests/data/torch_port_contact_routes_reference.json
(scripts/torch_port_contact_routes_reference.py, part `mi_small`):

- Pi, r, K v and the assembled K of the MI system at a contact-active
  state: 1e-12 relative;
- the field load alone (contact off): the MI residual and the field load's
  pullback -lam^T dR/df: 1e-12;
- four load levels warm-started from d = 0: each level's d 1e-8, W_c > 0
  at the last, |r| <= 1e-8 |r(0)| at every level;
- J = W_int, dJ/d(amp) and dJ/dh through the CP -> xi and displacement
  solves at full load: 1e-6;
- `DispMintImOperation.apply_linear_fwd`/`apply_linear_rev` with contact
  against the JAX operation's (1e-10) and the dot test <fwd t, w> =
  <t, rev w> (1e-10);
- a factor made before contact engages is refreshed by the solve entries'
  certificates once it does (no stale contact block survives);
- at 2.5 times the load (part `mi_load`) the levels' d against JAX's
  (1e-8): the iterates meet an indefinite tangent, which the MI factor's
  LU takes and a Cholesky factor did not (ROADMAP C20).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from _torch_port_common import TBEAM_STOP_SMALL, dec, mi_bend, \
    port_tbeam_stop, rel, t

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_contact_routes_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)["mi_small"]


def _cp(s, amp):
    m = s.metas[1]
    cp = s.cp.clone()
    cp[1, : m.n_cp, 0] = cp[1, : m.n_cp, 0] + amp * torch.from_numpy(
        mi_bend(s))
    return cp


@functools.lru_cache(maxsize=2)
def _levels(q=TBEAM_STOP_SMALL["q"]):
    """The port's four warm load levels at cp(0.05) under the field load q:
    (system, cp, xi, [(d, its, |r|, |r(0)|)], factor)."""
    from goldfish_tpu_torch.solver.system import potential_and_residual, \
        scale_loads
    from goldfish_tpu_torch.solver.system_mi import (
        PersistentDeviceFactorMI,
        data_at,
        newton_solve_mi_host,
    )

    s = port_tbeam_stop(**dict(TBEAM_STOP_SMALL, q=q))
    cp = _cp(s, 0.05)
    xi = s.c2x.solve(cp).detach()
    args = s.mi_args
    fac = PersistentDeviceFactorMI(*args)
    d = s.zero_displacement()
    out = []
    for k in range(1, 5):
        data = scale_loads(s.data, k / 4)
        r0 = potential_and_residual(data_at(data, *args[1:], xi),
                                    torch.zeros_like(d), cp, s.h_init)[1]
        d, its, rn = newton_solve_mi_host(data, *args[1:], cp, s.h_init, xi,
                                          d, rtol=1e-10, atol=0.0,
                                          max_it=40, device_fac=fac)
        out.append((d, its, float(rn), float(torch.linalg.norm(r0))))
    return s, cp, xi, out, fac


def test_mi_contact_energy_residual_tangent_match_jax(ref):
    from goldfish_tpu_torch.physics.contact import contact_energy
    from goldfish_tpu_torch.solver.system import tangent_matvec
    from goldfish_tpu_torch.solver.system_mi import (
        assemble_K_mi,
        data_at,
        residual_mi,
        total_potential_mi,
    )

    s = port_tbeam_stop(**TBEAM_STOP_SMALL)
    args = s.mi_args
    cp, xi, d = t(dec(ref["cp"])), t(dec(ref["xi"])), t(dec(ref["state_d"]))
    h = s.h_init
    assert float(contact_energy(s.data.contact, s.stack, d, cp)) > 0
    assert abs(float(contact_energy(s.data.contact, s.stack, d, cp))
               - ref["state_Wc"]) <= 1e-12 * ref["state_Wc"]
    Pi = float(total_potential_mi(*args, d, cp, h, xi))
    assert abs(Pi - ref["Pi"]) <= 1e-12 * abs(ref["Pi"])
    assert rel(residual_mi(*args, d, cp, h, xi), dec(ref["r"])) <= 1e-12
    Kv = tangent_matvec(data_at(s.data, *args[1:], xi), d, cp, h,
                        t(dec(ref["v"])))
    assert rel(Kv, dec(ref["Kv"])) <= 1e-12
    assert rel(assemble_K_mi(*args, d, cp, h, xi), dec(ref["K"])) <= 1e-12


def test_mi_field_load_residual_and_pullback_match_jax(ref):
    from goldfish_tpu_torch.solver.system import residual_vjp_field
    from goldfish_tpu_torch.solver.system_mi import data_at, residual_mi

    s = port_tbeam_stop(**TBEAM_STOP_SMALL)
    data = s.data._replace(contact=None)
    args = (data,) + s.mi_args[1:]
    cp, xi, d = t(dec(ref["cp"])), t(dec(ref["xi"])), t(dec(ref["state_d"]))
    assert rel(residual_mi(*args, d, cp, s.h_init, xi),
               dec(ref["field_r"])) <= 1e-12
    _, _, df = residual_vjp_field(data_at(*args, xi), d, cp, s.h_init,
                                  t(dec(ref["lam"])))
    assert rel(df, dec(ref["field_pull"])) <= 1e-12


def test_mi_contact_levels_match_jax(ref):
    from goldfish_tpu_torch.physics.contact import contact_energy

    s, cp, xi, levels, fac = _levels()
    want = dec(ref["d_levels"])
    assert rel(xi, dec(ref["xi"])) <= 1e-10
    for k, (d, its, rn, r0) in enumerate(levels):
        assert rn <= 1e-8 * r0, (k, its, rn, r0)
        assert rel(d, want[k]) <= 1e-8, k
    Wc = float(contact_energy(s.data.contact, s.stack, levels[-1][0], cp))
    assert Wc > 0 and abs(Wc - ref["Wc"]) <= 1e-6 * ref["Wc"]


def test_mi_contact_gradients_match_jax(ref):
    from goldfish_tpu_torch.physics import kl_shell

    s, _, _, levels, _ = _levels()
    forward = s.build_forward(rtol=1e-10, max_it=40)
    a = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    h = s.h_init.clone().requires_grad_(True)
    cp = _cp(s, a)
    d, _ = forward(cp, h, levels[-2][0])
    J = kl_shell.internal_energy(s.stack, d, cp, h, s.E, s.nu)
    J.backward()
    assert abs(float(J.detach()) - ref["J"]) <= 1e-8 * abs(ref["J"])
    assert abs(float(a.grad) - ref["dJ_damp"]) <= 1e-6 * abs(ref["dJ_damp"])
    assert rel(h.grad, dec(ref["dJ_dh"])) <= 1e-6
    assert rel(d, dec(ref["d"])) <= 1e-8


def test_disp_mint_operation_with_contact_matches_jax(ref):
    from goldfish_tpu_torch.operations import DispMintImOperation

    s, cp, xi, levels, _ = _levels()
    op = DispMintImOperation(s)
    lay = op.layout
    flat = lambda a: lay.to_flat(a).reshape(-1).numpy()   # noqa: E731
    op.linearize(flat(cp), flat(s.h_init[..., None]),
                 xi.reshape(-1).numpy(), flat(levels[-1][0]))
    o = ref["op"]
    tan = {k: dec(v) for k, v in o["tan"].items()}
    w = dec(o["w"])
    fwd = op.apply_linear_fwd(**tan)
    rev = op.apply_linear_rev(w)
    assert rel(fwd, dec(o["fwd"])) <= 1e-10
    for a, b in zip(rev, o["rev"]):
        assert rel(a, dec(b)) <= 1e-10
    lhs = float(fwd @ w)
    rhs = float(sum(a @ b for a, b in zip(
        (tan["d_cp"], tan["d_h"], tan["d_xi"], tan["d_d"]), rev)))
    assert abs(lhs - rhs) <= 1e-10 * abs(lhs)


def test_stale_contact_block_is_refreshed():
    """A factor made at d = 0 (no contact) meets a contact-active state:
    the direction certificate refactors, and the solve converges."""
    from goldfish_tpu_torch.physics.contact import contact_energy
    from goldfish_tpu_torch.solver.system_mi import (
        PersistentDeviceFactorMI,
        newton_solve_mi_host,
    )

    s, cp, xi, levels, _ = _levels()
    args = s.mi_args
    fac = PersistentDeviceFactorMI(*args)
    d0 = s.zero_displacement()
    fac.ensure(cp, s.h_init, xi, d0)
    d_start = 0.9 * levels[-1][0]
    assert float(contact_energy(s.data.contact, s.stack, d_start, cp)) > 0
    n0 = fac.n_factor
    d, its, rn = newton_solve_mi_host(*args, cp, s.h_init, xi, d_start,
                                      rtol=1e-10, atol=0.0, max_it=40,
                                      device_fac=fac)
    assert fac.n_factor > n0
    assert rel(d, levels[-1][0]) <= 1e-8


def test_mi_contact_at_a_larger_load_matches_jax():
    with open(REF) as f:
        want = json.load(f)["mi_load"]
    s, cp, xi, levels, fac = _levels(want["config"]["q"])
    assert fac.kind == "lu" and fac.n_factor_failed == 0
    for k, (d, its, rn, r0) in enumerate(levels):
        assert rn <= 1e-8 * r0, (k, its, rn, r0)
        assert rel(d, dec(want["d_levels"])[k]) <= 1e-8, k
