"""The Newton-Krylov route with contact: tests/test_contact.py's press at
num_el=4 (two clamped plates, contact (0, 1), N = 216) against the JAX
package's numbers in tests/data/torch_port_contact_routes_reference.json
(scripts/torch_port_contact_routes_reference.py, part `press_small`):

- `newton_krylov_solve` from 0.98 times the dense continuation's
  equilibrium, with the dense and the patch-block preconditioners: d within
  1e-8 of the JAX route's (its `newton_krylov_solve`) and of the dense
  route's;
- `build_solve_fn_krylov` with each of them: J = W_int and dJ/dh by the
  GMRES-IR adjoint within 1e-6 of the JAX dense adjoint's;
- GMRES on K(d) x = b with contact (K12's hvp in every Arnoldi step)
  against the dense solve;
- pair-Schwarz refuses the press (no interface pairs), as the JAX
  package's does.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_port_common import dec, port_press, rel, t

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_contact_routes_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)["press_small"]


@pytest.fixture(scope="module")
def press():
    return port_press(num_el=4)


@pytest.mark.parametrize("precond", ["full", "patch"])
def test_newton_krylov_press_matches_jax(ref, press, precond):
    from goldfish_tpu_torch.physics.contact import contact_energy
    from goldfish_tpu_torch.solver.krylov import newton_krylov_solve

    s = press
    log = []
    d, its, rn = newton_krylov_solve(
        s.data, s.cp, s.h_init, 0.98 * t(dec(ref["d_dense"])), rtol=1e-10,
        cg_rtol=1e-8, precond=precond, log=log)
    assert float(rn) <= 1e-9 * ref["r0"], log
    assert rel(d, dec(ref["d_krylov"])) <= 1e-8
    assert rel(d, dec(ref["d_dense"])) <= 1e-8
    assert float(contact_energy(s.data.contact, s.stack, d, s.cp)) > 0


@pytest.mark.parametrize("precond", ["full", "patch"])
def test_krylov_adjoint_press_matches_jax(ref, press, precond):
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.krylov import build_solve_fn_krylov

    s = press
    solve = build_solve_fn_krylov(s.data, rtol=1e-10, cg_rtol=1e-10,
                                  precond=precond)
    h = s.h_init.clone().requires_grad_(True)
    d = solve(s.cp, h, t(dec(ref["d_krylov"])))
    J = kl_shell.internal_energy(s.stack, d, s.cp, h, s.E, s.nu)
    J.backward()
    assert abs(float(J.detach()) - ref["J"]) <= 1e-8 * abs(ref["J"])
    assert rel(h.grad, dec(ref["dJ_dh"])) <= 1e-6
    assert solve.solver.adjoint_cycles[-1] >= 1


@pytest.mark.parametrize("precond", ["full", "patch"])
def test_gmres_with_contact_matches_dense_solve(ref, press, precond):
    from goldfish_tpu_torch.solver.krylov import (
        _block_tables,
        full_precond,
        gmres_solve,
        patch_block_precond,
    )
    from goldfish_tpu_torch.solver.system import assemble_K

    s = press
    d = t(dec(ref["d_krylov"]))
    b = t(np.random.default_rng(3).normal(size=tuple(s.cp.shape))) \
        * s.data.free
    pre = full_precond(s.data, d, s.cp, s.h_init) if precond == "full" \
        else patch_block_precond(s.data, d, s.cp, s.h_init,
                                 bt=_block_tables(s.data))
    x, cycles = gmres_solve(s.data, d, s.cp, s.h_init, b, pre, rtol=1e-10)
    K = assemble_K(s.data, d, s.cp, s.h_init)
    want = torch.linalg.solve(K, b.reshape(-1)).reshape(b.shape)
    assert rel(x, want) <= 1e-8
    assert cycles >= 1


def test_pair_schwarz_refuses_the_press_as_jax_does(press):
    from goldfish_tpu.solver.krylov import PairSchwarz as JaxPairSchwarz
    from test_contact import _press_problem

    from goldfish_tpu_torch.solver.krylov import PairSchwarz, \
        build_solve_fn_krylov

    with pytest.raises(AssertionError):
        JaxPairSchwarz(_press_problem(num_el=2).data)
    with pytest.raises(AssertionError, match="no interface pairs"):
        PairSchwarz(press.data)
    with pytest.raises(AssertionError, match="no interface pairs"):
        build_solve_fn_krylov(press.data, precond="pair_schwarz")
