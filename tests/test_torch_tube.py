"""The fixed-seam pressurized-tube slice and the optimizer loop: the
port's goldfish_tpu_torch/demos/tube_shape_opt.py on the small tube
(num_el=3, p=3, follower pressure 5e2) against the JAX package's
demos/tube_shape_opt.py (the moving-seam demo is test_torch_tube_mi.py's):

- J and dJ/dp at p0 from d = 0 (J 1e-10, dJ/dp 1e-6, and the port's own
  central difference), then `run_slsqp(maxiter=2)` against the JAX
  `OptProblem` on the same problem (the JAX demo's constraints and
  bounds): the same nit, nfev and njev, x 1e-6 and fun 1e-8. The JAX
  package's numbers are read from
  tests/data/torch_port_tube_small_reference.json
  (scripts/torch_port_tube_small_reference.py);
- `OptProblem` on an analytic problem (quadratic objective, a linear
  equality, a nonlinear inequality, a threaded state): the same iterates,
  `nit`, `nfev` and `njev` as the JAX package's.

CPU runs launch no kernel."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import SLICE_PRESSURE, TUBE_SMALL, rel

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_tube_small_reference.json")


def _ref(part):
    with open(REF) as fh:
        return json.load(fh)[part]


def _port_value_and_grad(ns, name, x0):
    x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
    J, d = ns.obj({name: x}, ns.sys.zero_displacement())
    J.backward()
    return float(J.detach()), x.grad.numpy(), d.detach()


def test_fixed_seam_objective_and_gradient_match_jax():
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import tube_shape_opt as demo

    ref = _ref("fixed")
    p0, J_ref, g_ref = np.asarray(ref["p0"]), ref["J"], ref["dJ_dp"]
    _cuda.reset_launch_counts()
    ns = demo.setup(**TUBE_SMALL, device="cpu", pressure=SLICE_PRESSURE)
    assert np.array_equal(ns.p0, p0)
    J, g, d = _port_value_and_grad(ns, "p_xy", ns.p0)
    assert abs(J - float(J_ref)) <= 1e-10 * abs(float(J_ref))
    assert rel(g, g_ref) <= 1e-6
    # the port's own central difference along a seeded direction (solves
    # warm-started from the solution at p0)
    u = np.random.default_rng(5).normal(size=p0.size)
    u /= np.linalg.norm(u)
    eps = 1e-5
    with torch.no_grad():
        Jp, Jm = (float(ns.obj({"p_xy": torch.tensor(ns.p0 + k * eps * u)},
                               d)[0])
                  for k in (1.0, -1.0))
    fd = (Jp - Jm) / (2 * eps)
    assert abs(fd - g @ u) <= 1e-5 * np.linalg.norm(g)
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_fixed_seam_slsqp_matches_jax():
    from goldfish_tpu_torch.demos import tube_shape_opt as demo

    ref = _ref("fixed_slsqp")
    ns = demo.setup(**TUBE_SMALL, device="cpu", pressure=SLICE_PRESSURE)
    res = ns.prob.run_slsqp(maxiter=2, tol=1e-14)
    assert (res.nit, res.nfev, res.njev) == (ref["nit"], ref["nfev"],
                                             ref["njev"])
    assert rel(res.x["p_xy"], ref["x"]) <= 1e-6
    assert abs(res.fun - ref["fun"]) <= 1e-8 * abs(ref["fun"])
    assert np.allclose(res.history, ref["history"], rtol=1e-8, atol=0)
    assert res.history[-1] < res.history[0] \
        and ns.solve.device_factor.n_factor_failed == 0


def _analytic(opt_cls, xp, device=None):
    """min sum w (x - c)^2 s.t. x0 + x1 + x2 = 1, sum x^2 <= 0.5,
    0 <= x <= 1, with a threaded state (the last x); `xp` is the array
    module of the package under test."""
    w = np.array([1.0, 2.0, 3.0, 0.5])
    c = np.array([0.9, -0.3, 0.4, 0.8])
    A = np.array([[1.0, 1.0, 1.0, 0.0]])
    prob = opt_cls() if device is None else opt_cls(device=device)
    prob.add_design_var("x", np.full(4, 0.25), lower=0.0, upper=1.0)

    def obj(dvs, state):
        x = dvs["x"]
        return (xp.asarray(w) * (x - xp.asarray(c)) ** 2).sum() \
            + 0.0 * state.sum(), x * 1.0

    prob.set_objective(obj, scaler=2.0, state0=xp.asarray(np.zeros(4)))
    prob.add_constraint("lin", lambda dvs: xp.asarray(A) @ dvs["x"],
                        equals=1.0)
    prob.add_constraint("ball", lambda dvs: (dvs["x"] ** 2).sum(),
                        upper=0.5)
    return prob


def test_optproblem_matches_jax_on_an_analytic_problem():
    from goldfish_tpu.opt.problem import OptProblem as JaxOptProblem
    from goldfish_tpu_torch.opt.problem import OptProblem

    class _Torch:
        @staticmethod
        def asarray(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float64)

    ref = _analytic(JaxOptProblem, jnp).run_slsqp(maxiter=50, tol=1e-12)
    prob = _analytic(OptProblem, _Torch, device="cpu")
    prob.preflight()
    res = prob.run_slsqp(maxiter=50, tol=1e-12)
    assert (res.nit, res.nfev, res.njev) == (ref.nit, ref.nfev, ref.njev)
    assert np.abs(res.x["x"] - ref.x["x"]).max() <= 1e-12
    assert abs(res.fun - ref.fun) <= 1e-12 * abs(ref.fun)
    assert np.allclose(res.history, ref.history, rtol=1e-12, atol=0)
    # the threaded state committed the last evaluated design
    assert prob.state_box[0].shape == (4,)
    assert len(prob.eval_wall["fun"]) >= 1 and len(prob.eval_wall["jac"]) \
        >= res.njev


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_optproblem_commits_only_finite_states(bad):
    from goldfish_tpu_torch.opt.problem import OptProblem

    prob = OptProblem(device="cpu")
    prob.add_design_var("x", np.ones(2))
    prob.set_objective(lambda dvs, st: ((dvs["x"] ** 2).sum(),
                                        dvs["x"] * bad),
                       state0=torch.zeros(2, dtype=torch.float64))
    fun, jac, _ = prob._build_callables()
    assert fun(np.ones(2)) == 2.0
    assert np.array_equal(jac(np.ones(2) * 3.0), [6.0, 6.0])
    assert torch.equal(prob.state_box[0], torch.zeros(2, dtype=torch.float64))
