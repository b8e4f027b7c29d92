"""Host-side optimization loop: SciPy SLSQP over PyTorch callables.

Port of goldfish_tpu/opt/problem.py (`OptProblem`, `OptResult`,
`run_slsqp`, `preflight`). Design variables, constraints and the objective
are plain PyTorch functions of a dict of design tensors on the problem's
device; `OptProblem` flattens and scales them and hands SciPy SLSQP host
numbers from three kinds of callables:

- `fun`: the objective forward-only, under `torch.no_grad()` (every SLSQP
  line-search trial pays a forward solve and nothing more);
- `jac`: the objective's value and gradient by autograd, through the
  implicit solves' `torch.autograd.Function`s (the adjoints run only where
  SLSQP asks for a gradient);
- per constraint, its value and its Jacobian (`torch.func.jacrev`).

fun and jac are separate callables with single-entry memos, and a jac
evaluation also yields J, so it seeds fun's memo (SLSQP's iteration
callback and its next fun(x) at an accepted point cost nothing).

Warm starting: the objective may thread a non-differentiated state
(typically the previous displacement) through successive evaluations; the
state commits only when it is finite, so a diverged trial design cannot
poison later warm starts. `iter_callback(dvs, J)` runs after every SLSQP
iteration (`utils.checkpoint.Checkpointer.attach` saves there).

`run(optimizer=...)` is the optimizer front end: "SLSQP" is `run_slsqp`;
any other name ("SNOPT", "IPOPT", ...) goes through pyOptSparse, the real
package where it is installed, else the port's own API subset
(`goldfish_tpu_torch.pyoptsparse_shim`, SciPy engines). Its `sens` callback
hands pyOptSparse the same autograd gradient and `torch.func.jacrev`
constraint Jacobians as the SLSQP route.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch
from scipy.optimize import minimize

from goldfish_tpu_torch.config import DTYPE, as_device

__all__ = ["OptProblem", "OptResult"]


@dataclass
class _DesignVar:
    name: str
    init: np.ndarray
    lower: float | np.ndarray | None
    upper: float | np.ndarray | None
    scaler: float


@dataclass
class _Constraint:
    name: str
    fn: Callable
    equals: np.ndarray | None
    lower: np.ndarray | None
    upper: np.ndarray | None
    scaler: float


@dataclass
class OptResult:
    x: dict
    fun: float
    nit: int
    success: bool
    message: str
    history: list = field(default_factory=list)
    nfev: int = -1   # objective (forward-only) evaluations
    njev: int = -1   # gradient (adjoint) evaluations


def _finite(state):
    return state is None or bool(torch.isfinite(state).all())


class OptProblem:
    """Declarative optimization problem over named design tensors on
    `device` (the current CUDA device by default)."""

    def __init__(self, device=None):
        self.device = as_device(device)
        self._dvs: list[_DesignVar] = []
        self._cons: list[_Constraint] = []
        self._obj = None
        self._obj_scaler = 1.0
        self._state0 = None
        self.state_box = [None]
        self.iter_callback = None
        # host wall seconds of every fun / jac evaluation (each ends in a
        # device-to-host read of J, so the device work is included)
        self.eval_wall = {"fun": [], "jac": []}

    # ------------------------------------------------------------ setup
    def add_design_var(self, name, init, lower=None, upper=None,
                       scaler=1.0):
        self._dvs.append(_DesignVar(
            name, np.asarray(init, dtype=np.float64), lower, upper,
            float(scaler)))

    def set_objective(self, fn, scaler=1.0, state0=None):
        """fn(dvs: dict) -> 0-dim tensor, or fn(dvs, state) -> (0-dim
        tensor, state) when `state0` is given (the state is threaded, not
        differentiated; the live one is `self.state_box[0]`)."""
        self._obj = fn
        self._obj_scaler = float(scaler)
        self._state0 = state0
        self.state_box = [state0]

    def add_constraint(self, name, fn, equals=None, lower=None, upper=None,
                       scaler=1.0):
        """fn(dvs: dict) -> vector (or 0-dim) tensor."""
        to = lambda v: None if v is None else np.atleast_1d(  # noqa: E731
            np.asarray(v, dtype=np.float64))
        self._cons.append(_Constraint(name, fn, to(equals), to(lower),
                                      to(upper), float(scaler)))

    # ------------------------------------------------------- flattening
    def _unflatten(self, x):
        """Flat scaled design tensor -> {name: unscaled tensor}."""
        out, o = {}, 0
        for v in self._dvs:
            n = v.init.size
            out[v.name] = x[o:o + n].reshape(v.init.shape) / v.scaler
            o += n
        return out

    def _x0(self):
        return np.concatenate(
            [v.scaler * v.init.ravel() for v in self._dvs])

    def _bounds(self):
        bs = []
        for v in self._dvs:
            lo = -np.inf if v.lower is None else v.lower
            hi = np.inf if v.upper is None else v.upper
            lo = np.broadcast_to(np.asarray(lo, dtype=np.float64) * v.scaler,
                                 (v.init.size,))
            hi = np.broadcast_to(np.asarray(hi, dtype=np.float64) * v.scaler,
                                 (v.init.size,))
            bs.append(np.stack([lo, hi], axis=1))
        return np.concatenate(bs, axis=0)

    def _tensor(self, x):
        return torch.tensor(np.asarray(x, dtype=np.float64), dtype=DTYPE,
                            device=self.device)

    def _raw(self, x):
        """(scaled J, new warm-start state or None) at the flat scaled
        design tensor x."""
        dvs = self._unflatten(x)
        if self._state0 is not None:
            J, new_state = self._obj(dvs, self.state_box[0])
        else:
            J, new_state = self._obj(dvs), None
        return self._obj_scaler * J, new_state

    def _commit(self, new_state):
        """Keep the warm-start state only when it is finite: a diverged
        trial design must not poison later warm starts."""
        if self._state0 is not None and _finite(new_state):
            self.state_box[0] = new_state.detach()

    def _value_and_grad(self, x):
        """(scaled J, its gradient (numpy), x's tensor) by autograd; commits
        the state."""
        xt = self._tensor(x).requires_grad_(True)
        J, new_state = self._raw(xt)
        (g,) = torch.autograd.grad(J, xt)
        self._commit(new_state)
        return float(J.detach()), g.cpu().numpy().astype(np.float64), \
            xt.detach()

    def _con_value(self, x, c):
        return c.scaler * torch.atleast_1d(c.fn(self._unflatten(x)))

    # ------------------------------------------------------------- run
    def run(self, optimizer="SLSQP", maxiter=100, tol=1e-9, verbose=False,
            opt_settings=None):
        """Pluggable optimizer front end (the reference's SNOPT/SLSQP
        switch, reference: demos_om/thickness_opt/plate/
        plate_var_th_opt_wint.py:342-361): "SLSQP" runs `run_slsqp`; any
        other name runs that pyOptSparse optimizer."""
        if optimizer.upper() == "SLSQP":
            return self.run_slsqp(maxiter=maxiter, tol=tol, verbose=verbose)
        return self._run_pyoptsparse(optimizer, maxiter=maxiter, tol=tol,
                                     verbose=verbose,
                                     opt_settings=opt_settings or {})

    @staticmethod
    def _import_pyoptsparse():
        """The real pyoptsparse where installed, else the port's shim."""
        try:
            import pyoptsparse
            return pyoptsparse
        except ModuleNotFoundError:
            from goldfish_tpu_torch import pyoptsparse_shim
            return pyoptsparse_shim

    def _run_pyoptsparse(self, optimizer, maxiter, tol, verbose,
                         opt_settings):
        """The pyOptSparse route (SNOPT et al.). pyOptSparse sees the
        scaled design space (value = scaler * init, as in run_slsqp); the
        objective and constraints come from objfun, forward-only; `sens`
        gives the autograd gradient (the warm-start state commits only when
        finite, as in run_slsqp) and each constraint's jacrev. pyOptSparse
        calls sens once per accepted major iteration, so `iter_callback`
        fires there with the scaled objective, except at the first call
        (the start point, before any step is accepted): the checkpointed
        iteration count is then the number of accepted iterations."""
        pyoptsparse = self._import_pyoptsparse()
        names = [dv.name for dv in self._dvs]
        slices, o = {}, 0
        for dv in self._dvs:
            slices[dv.name] = slice(o, o + dv.init.size)
            o += dv.init.size

        def flat(xdict):
            return np.concatenate([np.asarray(xdict[n], dtype=np.float64)
                                   .ravel() for n in names])

        def objfun(xdict):
            t0 = time.perf_counter()
            xt = self._tensor(flat(xdict))
            with torch.no_grad():
                J, new_state = self._raw(xt)
                self._commit(new_state)
                funcs = {"obj": float(J)}
                for c in self._cons:
                    funcs[c.name] = self._con_value(xt, c).cpu().numpy()
            self.eval_wall["fun"].append(time.perf_counter() - t0)
            return funcs, False

        n_sens = [0]

        def sens(xdict, funcs):
            t0 = time.perf_counter()
            _, g, x = self._value_and_grad(flat(xdict))
            out = {"obj": {n: g[slices[n]] for n in names}}
            for c in self._cons:
                Jc = torch.func.jacrev(
                    lambda y, c=c: self._con_value(y, c))(x).cpu().numpy()
                out[c.name] = {n: Jc[:, slices[n]] for n in names}
            self.eval_wall["jac"].append(time.perf_counter() - t0)
            n_sens[0] += 1
            if self.iter_callback is not None and n_sens[0] > 1:
                self.iter_callback(self._unflatten(x),
                                   float(np.asarray(funcs["obj"]).ravel()[0]))
            return out, False

        prob = pyoptsparse.Optimization("goldfish_tpu_torch", objfun)
        sc = lambda v, s: None if v is None else np.asarray(v) * s  # noqa
        for dv in self._dvs:
            prob.addVarGroup(dv.name, int(dv.init.size),
                             value=dv.scaler * dv.init.ravel(),
                             lower=sc(dv.lower, dv.scaler),
                             upper=sc(dv.upper, dv.scaler))
        prob.addObj("obj")
        x0 = self._tensor(self._x0())
        for c in self._cons:
            with torch.no_grad():
                n = int(self._con_value(x0, c).numel())
            kw = {}
            if c.equals is not None:
                kw = dict(lower=c.scaler * c.equals,
                          upper=c.scaler * c.equals)
            else:
                if c.lower is not None:
                    kw["lower"] = c.scaler * c.lower
                if c.upper is not None:
                    kw["upper"] = c.scaler * c.upper
            prob.addConGroup(c.name, n, **kw)
        opt_cls = getattr(pyoptsparse, optimizer.upper())
        # run()'s generic maxiter/tol in each wrapper's own option names;
        # explicit opt_settings win
        generic = {
            "SNOPT": {"Major iterations limit": int(maxiter),
                      "Major optimality tolerance": float(tol)},
            "IPOPT": {"max_iter": int(maxiter), "tol": float(tol)},
            "SLSQP": {"MAXIT": int(maxiter), "ACC": float(tol)},
            "PSQP": {"MIT": int(maxiter), "TOLG": float(tol)},
        }.get(optimizer.upper(), {})
        opt = opt_cls(options={**generic, **dict(opt_settings)})
        sol = opt(prob, sens=sens)
        x = np.concatenate([np.asarray(sol.xStar[n], dtype=np.float64)
                            .ravel() for n in names])
        xdict = {k: v.cpu().numpy() for k, v in
                 self._unflatten(torch.from_numpy(x)).items()}
        # descaled as in run_slsqp: callers see the same objective value
        # whichever route ran
        return OptResult(x=xdict,
                         fun=float(np.asarray(sol.fStar).ravel()[0])
                         / self._obj_scaler,
                         nit=int(getattr(sol, "nIter", -1)),
                         success=bool(getattr(sol, "success", True)),
                         message=str(sol.optInform), history=[])

    def preflight(self):
        """One evaluation of every optimizer callable at x0 (forward-only
        objective, gradient, each constraint and its Jacobian): warms the
        kernel build and the persistent factor before anything is timed,
        and settles the warm-start state at x0. fun runs before jac, since
        jac seeds fun's memo."""
        fun, jac, cons = self._build_callables()
        x0 = self._x0()
        fun(x0)
        jac(x0)
        for c in cons:
            c["fun"](x0)
            c["jac"](x0)

    def run_slsqp(self, maxiter=100, tol=1e-9, verbose=False):
        fun, jac, cons = self._build_callables()
        history = []

        def cb(x):
            J = fun(x)
            history.append(J)
            if verbose:
                print(f"  slsqp iter {len(history)}: J = {J:.6e}")
            if self.iter_callback is not None:
                self.iter_callback(self._unflatten(self._tensor(x)), J)

        res = minimize(
            fun, self._x0(), jac=jac, method="SLSQP",
            bounds=self._bounds(), constraints=cons, callback=cb,
            options=dict(maxiter=maxiter, ftol=tol, disp=verbose))
        xdict = {k: v.cpu().numpy() for k, v in
                 self._unflatten(torch.from_numpy(res.x)).items()}
        return OptResult(x=xdict, fun=float(res.fun) / self._obj_scaler,
                         nit=int(res.nit), success=bool(res.success),
                         message=str(res.message), history=history,
                         nfev=int(getattr(res, "nfev", -1)),
                         njev=int(getattr(res, "njev", -1)))

    def _build_callables(self):
        """(fun, jac, constraints) with single-entry memos: the SciPy SLSQP
        surface, shared by run_slsqp and preflight."""
        assert self._obj is not None, "set_objective first"

        def f_fun(x):
            t0 = time.perf_counter()
            with torch.no_grad():
                J, new_state = self._raw(self._tensor(x))
            self._commit(new_state)
            J = float(J)
            self.eval_wall["fun"].append(time.perf_counter() - t0)
            return J

        def f_jac(x):
            t0 = time.perf_counter()
            out = self._value_and_grad(x)[:2]
            self.eval_wall["jac"].append(time.perf_counter() - t0)
            return out

        memo_f, memo_g = {}, {}

        def fun(x):
            key = np.asarray(x, dtype=np.float64).tobytes()
            if memo_f.get("k") != key:
                memo_f["k"], memo_f["v"] = key, f_fun(x)
            return memo_f["v"]

        def jac(x):
            key = np.asarray(x, dtype=np.float64).tobytes()
            if memo_g.get("k") != key:
                Jv, gv = f_jac(x)
                memo_g["k"], memo_g["v"] = key, gv
                memo_f["k"], memo_f["v"] = key, Jv
            return memo_g["v"]

        cons = []
        for c in self._cons:
            def value(x, c=c):
                return self._con_value(x, c)

            def cfn(x, value=value):
                with torch.no_grad():
                    return value(self._tensor(x)).cpu().numpy()

            def cjac(x, value=value):
                return torch.func.jacrev(value)(self._tensor(x)).cpu().numpy()

            if c.equals is not None:
                t = c.scaler * c.equals
                cons.append(dict(type="eq",
                                 fun=lambda x, f=cfn, t=t: f(x) - t,
                                 jac=cjac))
            if c.lower is not None:
                t = c.scaler * c.lower
                cons.append(dict(type="ineq",
                                 fun=lambda x, f=cfn, t=t: f(x) - t,
                                 jac=cjac))
            if c.upper is not None:
                t = c.scaler * c.upper
                cons.append(dict(type="ineq",
                                 fun=lambda x, f=cfn, t=t: t - f(x),
                                 jac=lambda x, j=cjac: -j(x)))
        return fun, jac, cons
