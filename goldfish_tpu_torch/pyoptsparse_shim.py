"""Executable pyOptSparse-API subset backed by SciPy engines.

A NumPy/SciPy copy of goldfish_tpu/pyoptsparse_shim.py, so the port needs
nothing of the JAX package: `OptProblem.run(optimizer=...)` drives the
pyOptSparse route on the real package where it is installed, else on this
shim. The reference drives its large problems through pyOptSparse's SNOPT
wrapper (reference: demos_om/thickness_opt/plate/
plate_var_th_opt_wint.py:342-361 builds ``pyoptsparse.Optimization``,
adds var/con groups, and calls ``SNOPT(options)(prob, sens=...)``).
This shim implements exactly the API subset that path (and the reference
demos) use:

- ``Optimization(name, objFun)`` with ``addVarGroup`` / ``addObj`` /
  ``addConGroup``
- optimizer classes (``SNOPT``, ``SLSQP``, ``IPOPT``, ``PSQP``)
  constructed with ``options=dict`` and called as
  ``opt(prob, sens=callback)``
- a ``Solution`` carrying ``xStar`` (dict of per-group arrays),
  ``fStar``, ``optInform``

with pyOptSparse's CALLING CONVENTIONS preserved bit-for-bit —
``objFun(xdict) -> (funcs, fail)``; ``sens(xdict, funcs) ->
(dict-of-dicts, fail)`` keyed ``[func_name][var_group]``; ``sens="FD"``
falls back to internal finite differences — so swapping in the real
package is a pure import change.  The SQP engines are scipy's
(``SLSQP`` for SNOPT/SLSQP/PSQP, ``trust-constr`` for the
interior-point IPOPT); real-package option names ("Major iterations
limit", "max_iter", "MAXIT", ...) are translated.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import Bounds, NonlinearConstraint, minimize

__all__ = ["Optimization", "Solution", "Optimizer",
           "SNOPT", "SLSQP", "IPOPT", "PSQP", "Error"]

_IS_SHIM = True  # lets callers report which backend actually ran


class Error(RuntimeError):
    """pyoptsparse.pyOpt_error.Error equivalent."""


def _bcast(v, n, fill):
    if v is None:
        return np.full(n, fill, dtype=np.float64)
    a = np.asarray(v, dtype=np.float64).ravel()
    return np.broadcast_to(a, (n,)).astype(np.float64).copy()


class Optimization:
    """Problem container (pyoptsparse.Optimization subset)."""

    def __init__(self, name, objFun, comm=None):
        self.name = name
        self.objFun = objFun
        self.variables = {}    # group -> dict(n, value, lower, upper)
        self.objectives = []   # objective names, in addObj order
        self.constraints = {}  # group -> dict(n, lower, upper)

    # pyoptsparse signature: addVarGroup(name, nVars, varType='c',
    # value=0.0, lower=None, upper=None, scale=1.0, ...)
    def addVarGroup(self, name, nVars, varType="c", value=0.0,
                    lower=None, upper=None, **_ignored):
        n = int(nVars)
        if name in self.variables:
            raise Error(f"duplicate variable group {name!r}")
        self.variables[name] = dict(
            n=n,
            value=_bcast(value, n, 0.0),
            lower=_bcast(lower, n, -np.inf),
            upper=_bcast(upper, n, np.inf),
        )

    def addVar(self, name, *args, **kw):
        self.addVarGroup(name, 1, *args, **kw)

    def addObj(self, name, **_ignored):
        self.objectives.append(name)

    def addConGroup(self, name, nCon, lower=None, upper=None,
                    **_ignored):
        n = int(nCon)
        if name in self.constraints:
            raise Error(f"duplicate constraint group {name!r}")
        self.constraints[name] = dict(
            n=n,
            lower=_bcast(lower, n, -np.inf),
            upper=_bcast(upper, n, np.inf),
        )

    def addCon(self, name, **kw):
        self.addConGroup(name, 1, **kw)


class Solution:
    """Result object exposing the attributes callers read
    (``sol.xStar[group]``, ``sol.fStar``, ``sol.optInform``)."""

    def __init__(self, xStar, fStar, optInform, success, nIter):
        self.xStar = xStar
        self.fStar = fStar
        self.optInform = optInform
        self.success = success
        self.nIter = nIter

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Solution(fStar={self.fStar!r}, "
                f"optInform={self.optInform!r})")


class Optimizer:
    """Base driver: flattens var groups, adapts the pyoptsparse
    objFun/sens conventions to scipy.optimize.minimize."""

    _engine = "SLSQP"          # scipy method
    _maxiter_keys = ("maxiter",)
    _tol_keys = ("tol",)

    def __init__(self, options=None, **_ignored):
        self.options = dict(options or {})

    def _setting(self, keys, default):
        for k in keys:
            if k in self.options:
                return self.options[k]
        return default

    def __call__(self, optProb, sens=None, storeHistory=None,
                 **_ignored):
        if not optProb.objectives:
            raise Error("no objective declared (addObj)")
        obj_name = optProb.objectives[0]
        names = list(optProb.variables)
        sizes = [optProb.variables[n]["n"] for n in names]
        offs = np.cumsum([0] + sizes)
        slices = {n: slice(int(o0), int(o1))
                  for n, o0, o1 in zip(names, offs[:-1], offs[1:])}
        x0 = np.concatenate(
            [optProb.variables[n]["value"] for n in names])
        lb = np.concatenate(
            [optProb.variables[n]["lower"] for n in names])
        ub = np.concatenate(
            [optProb.variables[n]["upper"] for n in names])

        def split(x):
            return {n: np.asarray(x[slices[n]], dtype=np.float64).copy()
                    for n in names}

        # scipy calls fun/jac/constraints separately at the same x;
        # memoize the last evaluation so objFun runs once per point
        # (the real pyoptsparse caches identically).
        f_memo = {"x": None, "funcs": None}

        def funcs_at(x):
            x = np.asarray(x, dtype=np.float64)
            if f_memo["x"] is None or not np.array_equal(f_memo["x"], x):
                funcs, fail = optProb.objFun(split(x))
                if fail:
                    raise Error("objFun signalled failure (fail=True)")
                f_memo["x"] = x.copy()
                f_memo["funcs"] = funcs
            return f_memo["funcs"]

        if sens is None or (isinstance(sens, str)
                            and sens.upper() in ("FD", "FDR", "CD")):
            sens_fn = self._fd_sens(optProb, names, obj_name)
        elif callable(sens):
            sens_fn = sens
        else:
            raise Error(f"unsupported sens specification {sens!r}")

        g_memo = {"x": None, "sens": None}

        def sens_at(x):
            x = np.asarray(x, dtype=np.float64)
            if g_memo["x"] is None or not np.array_equal(g_memo["x"], x):
                sdict, fail = sens_fn(split(x), funcs_at(x))
                if fail:
                    raise Error("sens signalled failure (fail=True)")
                g_memo["x"] = x.copy()
                g_memo["sens"] = sdict
            return g_memo["sens"]

        def f(x):
            return float(np.asarray(funcs_at(x)[obj_name]).ravel()[0])

        def g(x):
            s = sens_at(x)[obj_name]
            return np.concatenate(
                [np.asarray(s[n], dtype=np.float64).ravel()
                 for n in names])

        def con_fun(cname):
            def fun(x):
                return np.asarray(funcs_at(x)[cname],
                                  dtype=np.float64).ravel()
            return fun

        def con_jac(cname, nc):
            def jac(x):
                s = sens_at(x)[cname]
                return np.column_stack(
                    [np.asarray(s[n], dtype=np.float64).reshape(nc, -1)
                     for n in names])
            return jac

        maxiter = int(self._setting(self._maxiter_keys, 200))
        tol = float(self._setting(self._tol_keys, 1e-9))

        if self._engine == "SLSQP":
            res = self._run_slsqp(f, g, x0, lb, ub, optProb,
                                  con_fun, con_jac, maxiter, tol)
        else:
            res = self._run_trust_constr(f, g, x0, lb, ub, optProb,
                                         con_fun, con_jac, maxiter, tol)

        xs = res.x
        xStar = split(xs)
        optInform = {"value": int(getattr(res, "status", 0)),
                     "text": str(res.message)}
        return Solution(xStar=xStar, fStar=float(res.fun),
                        optInform=optInform,
                        success=bool(res.success),
                        nIter=int(getattr(res, "nit", -1)))

    # ------------------------------------------------ sens fallback
    @staticmethod
    def _fd_sens(optProb, names, obj_name, step=1e-7):
        """pyoptsparse's sens='FD': forward differences of every
        declared function w.r.t. every var group."""

        def sens_fn(xdict, funcs):
            fnames = [obj_name] + list(optProb.constraints)
            base = {fn: np.asarray(funcs[fn], dtype=np.float64).ravel()
                    for fn in fnames}
            out = {fn: {} for fn in fnames}
            for n in names:
                xn = np.asarray(xdict[n], dtype=np.float64).ravel()
                cols = {fn: [] for fn in fnames}
                for j in range(xn.size):
                    h = step * max(1.0, abs(xn[j]))
                    xp = dict(xdict)
                    pert = xn.copy()
                    pert[j] += h
                    xp[n] = pert
                    fp, fail = optProb.objFun(xp)
                    if fail:
                        raise Error("objFun failed inside FD sens")
                    for fn in fnames:
                        fv = np.asarray(fp[fn],
                                        dtype=np.float64).ravel()
                        cols[fn].append((fv - base[fn]) / h)
                for fn in fnames:
                    out[fn][n] = np.column_stack(cols[fn]) \
                        if base[fn].size > 1 or fn != obj_name \
                        else np.column_stack(cols[fn]).ravel()
            return out, False

        return sens_fn

    # ------------------------------------------------ scipy engines
    @staticmethod
    def _run_slsqp(f, g, x0, lb, ub, optProb, con_fun, con_jac,
                   maxiter, tol):
        cons = []
        for cname, c in optProb.constraints.items():
            nc = c["n"]
            lo, hi = c["lower"], c["upper"]
            fun, jac = con_fun(cname), con_jac(cname, nc)
            eq = np.isfinite(lo) & (lo == hi)
            ge = np.isfinite(lo) & ~eq
            le = np.isfinite(hi) & ~eq
            if eq.any():
                cons.append(dict(
                    type="eq",
                    fun=lambda x, fun=fun, lo=lo, m=eq: (fun(x) - lo)[m],
                    jac=lambda x, jac=jac, m=eq: jac(x)[m]))
            if ge.any():
                cons.append(dict(
                    type="ineq",
                    fun=lambda x, fun=fun, lo=lo, m=ge: (fun(x) - lo)[m],
                    jac=lambda x, jac=jac, m=ge: jac(x)[m]))
            if le.any():
                cons.append(dict(
                    type="ineq",
                    fun=lambda x, fun=fun, hi=hi, m=le: (hi - fun(x))[m],
                    jac=lambda x, jac=jac, m=le: -jac(x)[m]))
        return minimize(f, x0, jac=g, method="SLSQP",
                        bounds=Bounds(lb, ub), constraints=cons,
                        options={"maxiter": maxiter, "ftol": tol})

    @staticmethod
    def _run_trust_constr(f, g, x0, lb, ub, optProb, con_fun, con_jac,
                          maxiter, tol):
        nlcs = [NonlinearConstraint(con_fun(cn), c["lower"], c["upper"],
                                    jac=con_jac(cn, c["n"]))
                for cn, c in optProb.constraints.items()]
        return minimize(f, x0, jac=g, method="trust-constr",
                        bounds=Bounds(lb, ub), constraints=nlcs,
                        options={"maxiter": maxiter, "gtol": tol,
                                 "xtol": min(tol, 1e-10), "verbose": 0})


class SNOPT(Optimizer):
    """SNOPT stand-in (SQP engine).  Honors the real wrapper's
    headline option names."""
    _engine = "SLSQP"
    _maxiter_keys = ("Major iterations limit", "maxiter")
    _tol_keys = ("Major optimality tolerance", "tol")


class SLSQP(Optimizer):
    """pyoptsparse.SLSQP option names (MAXIT/ACC)."""
    _engine = "SLSQP"
    _maxiter_keys = ("MAXIT", "maxiter")
    _tol_keys = ("ACC", "tol")


class PSQP(Optimizer):
    _engine = "SLSQP"
    _maxiter_keys = ("MIT", "maxiter")
    _tol_keys = ("TOLG", "tol")


class IPOPT(Optimizer):
    """Interior-point stand-in (scipy trust-constr engine)."""
    _engine = "trust-constr"
    _maxiter_keys = ("max_iter", "maxiter")
    _tol_keys = ("tol",)
