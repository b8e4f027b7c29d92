"""The moving-seam pressurized-tube slice: the port's
goldfish_tpu_torch/demos/draft_tube_shopt_mi_wffd.py on the small tube
(num_el=3, p=3, follower pressure 5e2, four seams of 9 points): J and dJ/dp
at the ovalized start from d = 0 against `jax.value_and_grad` of the JAX
demo's objective (direct mode; J 1e-10, dJ/dp 1e-6; the JAX package's
numbers are read from tests/data/torch_port_tube_small_reference.json,
written by scripts/torch_port_tube_small_reference.py), and the port's own
`run_slsqp(maxiter=2)`, which must end below the start's J (SLSQP's
first step overshoots, as in the JAX package) and hold the pin to 1e-10."""

import json
import os

import numpy as np
import torch

from _torch_port_common import SLICE_PRESSURE, TUBE_SMALL, rel

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_tube_small_reference.json")


def _port_value_and_grad(ns, name, x0):
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    J, _ = ns.obj({name: x}, ns.sys.zero_displacement())
    J.backward()
    return float(J.detach()), x.grad.numpy()


def test_moving_seam_objective_and_gradient_match_jax():
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as demo

    with open(REF) as fh:
        ref = json.load(fh)["mi"]
    p_start, J_ref, g_ref = np.asarray(ref["p_start"]), ref["J"], \
        ref["dJ_dp"]
    ns = demo.setup(**TUBE_SMALL, device="cpu",
                    pressure=SLICE_PRESSURE)
    assert np.array_equal(ns.p_start, p_start)
    J, g = _port_value_and_grad(ns, "p_ffd", ns.p_start)
    assert abs(J - float(J_ref)) <= 1e-10 * abs(float(J_ref))
    assert rel(g, g_ref) <= 1e-6


def test_moving_seam_slsqp_lowers_J_and_holds_the_pin():
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as demo

    ns = demo.setup(**TUBE_SMALL, device="cpu",
                    pressure=SLICE_PRESSURE)
    with torch.no_grad():
        J0 = float(ns.obj({"p_ffd": torch.tensor(ns.p_start)},
                          ns.sys.zero_displacement())[0])
    res = ns.prob.run_slsqp(maxiter=2, tol=1e-12)
    x = res.x["p_ffd"]
    assert res.nit == 2 and len(res.history) == 2
    assert res.fun < J0
    assert ns.forward.solve_d.device_factor.n_factor_failed == 0
    assert np.abs(ns.A_pin2 @ x - ns.A_pin2 @ ns.p0).max() <= 1e-10
