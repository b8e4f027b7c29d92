"""The port's pyOptSparse route, executed: each case of
tests/test_pyoptsparse_shim.py on the port's `OptProblem.run` and its copy
of the shim (goldfish_tpu_torch/pyoptsparse_shim.py), with the JAX tests'
tolerances, on the CPU (`device="cpu"`; the objectives are torch
functions). Plus: `run(optimizer="SLSQP")` is `run_slsqp`, bit for bit.
These are toy problems: no JAX is needed.
"""

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (one torch thread per worker)
from goldfish_tpu_torch import pyoptsparse_shim as pos
from goldfish_tpu_torch.opt.problem import OptProblem as _OptProblem


def OptProblem():
    return _OptProblem(device="cpu")


def _arr(v):
    return torch.tensor(v, dtype=torch.float64)


# --------------------------------------------------------------- helpers
def _qp_problem(state0=None):
    """min (x0-1)^2 + (x1-2)^2  s.t. x0+x1 <= 2, 0 <= x <= 3.
    KKT solution: x* = (0.5, 1.5), J* = 0.5."""
    prob = OptProblem()
    prob.add_design_var("x", np.zeros(2), lower=0.0, upper=3.0)
    if state0 is None:
        prob.set_objective(
            lambda dvs: (dvs["x"][0] - 1.0) ** 2
            + (dvs["x"][1] - 2.0) ** 2)
    else:
        prob.set_objective(
            lambda dvs, s: ((dvs["x"][0] - 1.0) ** 2
                            + (dvs["x"][1] - 2.0) ** 2, s + 1.0),
            state0=state0)
    prob.add_constraint("lin", lambda dvs: torch.sum(dvs["x"]),
                        upper=2.0)
    return prob


# ------------------------------------------------- OptProblem.run paths
def test_snopt_dispatch_qp():
    prob = _qp_problem()
    res = prob.run(optimizer="SNOPT", maxiter=200, tol=1e-12)
    assert res.success, res.message
    np.testing.assert_allclose(res.x["x"], [0.5, 1.5], atol=1e-6)
    assert abs(res.fun - 0.5) < 1e-8


def test_snopt_matches_slsqp_route():
    r1 = _qp_problem().run(optimizer="SNOPT", maxiter=200, tol=1e-12)
    r2 = _qp_problem().run_slsqp(maxiter=200, tol=1e-12)
    np.testing.assert_allclose(r1.x["x"], r2.x["x"], atol=1e-6)


def test_ipopt_dispatch_equality():
    """min ||x||^2 s.t. sum(x) = 1 -> x = 1/3 each (interior-point
    engine, equality handled through NonlinearConstraint lb==ub)."""
    prob = OptProblem()
    prob.add_design_var("x", np.array([0.9, 0.05, 0.05]))
    prob.set_objective(lambda dvs: torch.sum(dvs["x"] ** 2))
    prob.add_constraint("bal", lambda dvs: torch.sum(dvs["x"]),
                        equals=1.0)
    res = prob.run(optimizer="IPOPT", maxiter=300, tol=1e-10)
    np.testing.assert_allclose(res.x["x"], np.full(3, 1.0 / 3.0),
                               atol=1e-6)


def test_snopt_threaded_state():
    """The warm-start state box must advance through the pyoptsparse
    objfun exactly as it does through run_slsqp."""
    prob = _qp_problem(state0=torch.zeros((), dtype=torch.float64))
    res = prob.run(optimizer="SNOPT", maxiter=200, tol=1e-12)
    assert res.success
    assert float(prob.state_box[0]) > 0  # objfun advanced the state
    np.testing.assert_allclose(res.x["x"], [0.5, 1.5], atol=1e-6)


def test_snopt_scaled_two_groups():
    """Two var groups with different scalers + a two-sided constraint:
    exercises the slices/descale plumbing in _run_pyoptsparse."""
    prob = OptProblem()
    prob.add_design_var("a", np.zeros(2), lower=-5.0, upper=5.0,
                        scaler=10.0)
    prob.add_design_var("b", np.zeros(1), lower=-5.0, upper=5.0)
    prob.set_objective(
        lambda dvs: torch.sum((dvs["a"] - _arr([1.0, -1.0])) ** 2)
        + (dvs["b"][0] - 2.0) ** 2)
    prob.add_constraint("box", lambda dvs: dvs["a"][0] + dvs["b"][0],
                        lower=0.5, upper=1.5)
    res = prob.run(optimizer="SNOPT", maxiter=300, tol=1e-12)
    # unconstrained optimum a=(1,-1), b=2 violates the upper bound 1.5;
    # KKT with a0 + b = 1.5 and equal curvature gives b = a0 + 1, so
    # a0 = 0.25, b = 1.25
    np.testing.assert_allclose(res.x["a"], [0.25, -1.0], atol=1e-5)
    np.testing.assert_allclose(res.x["b"], [1.25], atol=1e-5)


def test_snopt_descales_objective_and_fires_iter_callback():
    """res.fun must be the UNSCALED objective whichever driver ran
    (run_slsqp descales res.fun / obj_scaler — _run_pyoptsparse must
    match), and the per-iteration callback hook (checkpointing,
    utils/checkpoint.resume_run) must fire on the pyoptsparse path
    with the SCALED objective (same convention as run_slsqp's cb)."""
    prob = _qp_problem()
    # rebuild the objective with a scaler: _qp_problem sets scaler=1
    obj = prob._obj
    prob.set_objective(obj, scaler=100.0)
    seen = []
    prob.iter_callback = lambda xdict, J: seen.append(
        (np.asarray(xdict["x"]), float(J)))
    res = prob.run(optimizer="SNOPT", maxiter=200, tol=1e-12)
    assert res.success, res.message
    # unscaled optimum value is 0.5 regardless of the driver scaler
    assert abs(res.fun - 0.5) < 1e-8
    assert len(seen) >= 1
    x_last, J_last = seen[-1]
    # callback sees the driver-SCALED objective and the UNSCALED dvs
    assert abs(J_last - 100.0 * 0.5) < 1e-4
    np.testing.assert_allclose(x_last, [0.5, 1.5], atol=1e-4)
    # the START-POINT gradient (every engine's first sens call) must
    # NOT fire the callback: the persisted 'iter' counter counts
    # ACCEPTED iterations, or resume_run's remaining budget under-runs
    x_first, _ = seen[0]
    assert not np.allclose(x_first, 0.0), \
        "first callback fired at the initial point (start-point sens)"


def test_maxiter_option_forwarded():
    """run(maxiter=1) must actually cap the engine (the generic ->
    wrapper option-name translation in _run_pyoptsparse)."""
    prob = _qp_problem()
    res = prob.run(optimizer="SNOPT", maxiter=1, tol=1e-12)
    assert res.nit <= 2
    # explicit opt_settings override the generic translation
    prob2 = _qp_problem()
    res2 = prob2.run(optimizer="SNOPT", maxiter=1, tol=1e-12,
                     opt_settings={"Major iterations limit": 200})
    assert res2.success and abs(res2.fun - 0.5) < 1e-8


# ------------------------------------------------ shim semantics pins
def _shim_qp(sens):
    """Direct shim usage with pyoptsparse calling conventions."""
    def objfun(xdict):
        x = np.asarray(xdict["x"])
        funcs = {"obj": float((x[0] - 1.0) ** 2 + (x[1] - 2.0) ** 2),
                 "lin": np.atleast_1d(x.sum())}
        return funcs, False

    prob = pos.Optimization("qp", objfun)
    prob.addVarGroup("x", 2, value=np.zeros(2), lower=0.0, upper=3.0)
    prob.addObj("obj")
    prob.addConGroup("lin", 1, upper=2.0)
    opt = pos.SNOPT(options={"Major iterations limit": 200,
                             "Major optimality tolerance": 1e-12})
    return opt(prob, sens=sens)


def test_shim_fd_sens_matches_analytic():
    def sens(xdict, funcs):
        x = np.asarray(xdict["x"])
        return ({"obj": {"x": np.array([2 * (x[0] - 1.0),
                                        2 * (x[1] - 2.0)])},
                 "lin": {"x": np.ones((1, 2))}}, False)

    sol_an = _shim_qp(sens)
    sol_fd = _shim_qp("FD")
    np.testing.assert_allclose(sol_an.xStar["x"], [0.5, 1.5],
                               atol=1e-6)
    np.testing.assert_allclose(sol_fd.xStar["x"], sol_an.xStar["x"],
                               atol=1e-4)
    assert abs(sol_an.fStar - 0.5) < 1e-8


def test_shim_objfun_fail_flag():
    """pyoptsparse convention: (funcs, fail=True) aborts the run."""
    def objfun(xdict):
        return {"obj": 0.0}, True

    prob = pos.Optimization("bad", objfun)
    prob.addVarGroup("x", 1, value=0.0)
    prob.addObj("obj")
    with pytest.raises(pos.Error):
        pos.SNOPT()(prob, sens="FD")


def test_shim_sens_receives_groups_and_funcs():
    """sens gets (xdict keyed by var group, funcs from the LAST objfun
    call) and returns dict-of-dicts keyed [func][group]."""
    seen = {}

    def objfun(xdict):
        x = np.asarray(xdict["x"])
        return {"obj": float(np.sum(x ** 2))}, False

    def sens(xdict, funcs):
        seen["keys"] = sorted(xdict.keys())
        seen["funcs_obj"] = funcs["obj"]
        return {"obj": {"x": 2 * np.asarray(xdict["x"])}}, False

    prob = pos.Optimization("p", objfun)
    prob.addVarGroup("x", 3, value=np.ones(3))
    prob.addObj("obj")
    sol = pos.SNOPT(options={"maxiter": 100})(prob, sens=sens)
    assert seen["keys"] == ["x"]
    assert isinstance(seen["funcs_obj"], float)
    np.testing.assert_allclose(sol.xStar["x"], np.zeros(3), atol=1e-6)


def test_shim_duplicate_group_rejected():
    prob = pos.Optimization("p", lambda xd: ({"obj": 0.0}, False))
    prob.addVarGroup("x", 1)
    with pytest.raises(pos.Error):
        prob.addVarGroup("x", 1)


def test_run_slsqp_route_is_run_slsqp_bit_for_bit():
    """`run(optimizer="SLSQP")` dispatches to run_slsqp: the same design,
    J, history and counters, bit for bit, with a threaded state."""
    r1 = _qp_problem(state0=torch.zeros((), dtype=torch.float64)).run(
        optimizer="SLSQP", maxiter=200, tol=1e-12)
    r2 = _qp_problem(state0=torch.zeros((), dtype=torch.float64)).run_slsqp(
        maxiter=200, tol=1e-12)
    assert np.array_equal(r1.x["x"], r2.x["x"])
    assert r1.fun == r2.fun and r1.history == r2.history
    assert (r1.nit, r1.nfev, r1.njev) == (r2.nit, r2.nfev, r2.njev)
