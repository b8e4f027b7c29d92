"""The port's fixed-seam T-beam, arch, moving-seam T-beam and aeroelastic
demos on the CPU at the JAX tests' sizes (tests/test_demos.py), against the
JAX runs stored in tests/data/torch_port_drivers_reference.json
(`JAX_PLATFORMS=cpu python scripts/torch_port_drivers_reference.py`; the
JAX demos' own tests are slow-marked): the start J (1e-8) and gradient
(1e-6) of each SLSQP surface (as the run evaluates them), the JAX tests'
criteria, and the end J (1e-6) where both runs take the same SLSQP
path."""

import json
import os

import numpy as np
import pytest
from _torch_port_common import record_start, rel

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_drivers_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)


# Where the JAX run recorded the state its start evaluation reached
# (`d_start`), the port's energy at that state must give the JAX start J
# to 1e-12: the same model. The start J of the two solves are held at 1e-8
# except where the JAX Newton stops far above the port's residual: at the
# small arch it stops at its stall test with |r| = 1.7e-6 |r(0)| (the
# port's polished solve: 2.0e-9 |r(0)|), 6.0e-8 in J; the fixed-seam
# T-beam's tangent (E = 1e12, nu = 0) has a condition number of ~2.8e14 at
# num_el=3, where the JAX gradient is 1.7e-5 from an extended-precision
# dense adjoint at the port's state (the port's 2.0e-6) and the start J
# differ by 1.4e-8 (ROADMAP C16). Those two are held at these bars; so is
# the T-beam's energy at the JAX state, whose membrane strains x.x - X.X
# lose ~1e-8 to cancellation at |d| ~ 1e-7 |X| in both packages (C14).
LOOSE_TOL_J, TBEAM_TOL_G = 1e-7, 1e-4


def _eval_start(prob):
    """The start J and gradient at x0 by a separate evaluation (where SLSQP
    first evaluates the design clipped to its bounds), the warm start then
    reset to d = 0 for the run."""
    fun, jac, _ = prob._build_callables()
    x0 = prob._x0()
    g = np.array(jac(x0))
    seen = {"J": fun(x0), "g": g}
    prob.state_box[0] = prob._state0
    return seen


def _check_start(ns, seen, want, tol_J=1e-8, tol_g=1e-6, tol_state=1e-12):
    import torch

    from goldfish_tpu_torch.physics import kl_shell

    prob = ns.prob
    assert np.array_equal(prob._x0(), np.asarray(want["x0"]))
    assert abs(seen["J"] - want["J_start"]) <= tol_J * abs(want["J_start"])
    assert rel(seen["g"], want["g_start"]) <= tol_g
    if "d_start" in want:
        s = ns.sys
        d = torch.tensor(want["d_start"], dtype=torch.float64).reshape(
            s.cp.shape)
        with torch.no_grad():
            cp = ns.ffd(torch.tensor(ns.p0))
            Jd = prob._obj_scaler * float(kl_shell.internal_energy(
                s.stack, d, cp, s.h_init, s.E, s.nu))
        assert abs(Jd - want["J_start"]) <= tol_state * abs(want["J_start"])


def _check_run(res, J0, want, tol_J=1e-8):
    assert abs(J0 - want["J0"]) <= tol_J * abs(want["J0"])
    assert res.nit == want["nit"]
    assert abs(res.fun - want["fun_end"]) <= 1e-6 * abs(want["fun_end"])


def test_tbeam_shape_opt_demo(ref):
    """Fixed-seam T-beam shape optimization: stiffness improves and the
    off-center web moves toward the flange center."""
    from goldfish_tpu_torch.demos import tbeam_shape_opt as demo

    kw = dict(num_el=3, p=2, x_web=0.4)
    ns = demo.setup(device="cpu", **kw)
    seen = record_start(ns.prob)
    res, J0, web_x, _, _ = demo.main(maxiter=8, verbose=False, ns=ns)
    _check_start(ns, seen, ref["tbeam_small"], LOOSE_TOL_J, TBEAM_TOL_G,
                 LOOSE_TOL_J)
    assert res.fun < J0
    assert abs(web_x) < 0.4
    want = ref["tbeam_small"]
    assert abs(J0 - want["J0"]) <= LOOSE_TOL_J * abs(want["J0"])
    # the SLSQP paths part at the start gradient's 1.9e-5 (C16): the JAX
    # test's criteria above, not the JAX run's end, hold the run


def test_shape_opt_arch_demo(ref):
    """Plate -> arch: membrane action beats bending by a wide margin."""
    from goldfish_tpu_torch.demos import shape_opt_arch as demo

    kw = dict(num_el=3, p=2, num_patches=3)
    ns = demo.setup(device="cpu", **kw)
    # the block's end slabs start below their bounds of 0: SLSQP clips them
    seen = _eval_start(ns.prob)
    res, J0, _, _ = demo.main(maxiter=10, verbose=False, ns=ns)
    _check_start(ns, seen, ref["arch_small"], LOOSE_TOL_J)
    assert res.fun < 0.3 * J0
    _check_run(res, J0, ref["arch_small"], LOOSE_TOL_J)


def test_shape_opt_mint_tbeam_demo(ref):
    """Moving-seam T-beam: the web's lateral offsets lower the energy."""
    from goldfish_tpu_torch.demos import shape_opt_mint_tbeam as demo

    kw = dict(num_el=3, p=2)
    ns = demo.setup(device="cpu", **kw)
    seen = record_start(ns.prob)
    res, J0, _ = demo.main(maxiter=5, verbose=False, ns=ns)
    _check_start(ns, seen, ref["mint_small"])
    assert res.fun < 0.9 * J0
    _check_run(res, J0, ref["mint_small"])


def test_aeroelastic_wing_demo(ref):
    """The strip-theory fixed point: the port's energy at the JAX run's
    final state (1e-12), J0 and the tip (1e-8) and the coupled adjoint
    dJ/dh (1e-6) against the JAX demo's; finite, lift bends the wing up."""
    from goldfish_tpu_torch.demos import aeroelastic_wing as demo

    import torch

    from goldfish_tpu_torch.physics import kl_shell

    want = ref["aero_small"]
    J0, tip, gh, s = demo.main(verbose=False, device="cpu", **want["kw"])
    d = torch.tensor(want["d"], dtype=torch.float64).reshape(s.cp.shape)
    with torch.no_grad():
        J_at = float(kl_shell.internal_energy(s.stack, d, s.cp, s.h_init,
                                              s.E, s.nu))
    assert abs(J_at - want["J0"]) <= 1e-12 * abs(want["J0"])
    assert np.isfinite(J0) and J0 > 0
    assert float(tip[2]) > 0
    assert bool(np.all(np.isfinite(gh.numpy())))
    assert abs(J0 - want["J0"]) <= 1e-8 * abs(want["J0"])
    assert rel(tip, want["tip"]) <= 1e-8
    assert list(gh.shape) == want["gh_shape"]
    assert rel(gh.reshape(-1), want["dJ_dh"]) <= 1e-6
