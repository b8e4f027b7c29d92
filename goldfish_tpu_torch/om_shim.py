"""Minimal OpenMDAO-compatible execution runtime (the port's own copy).

A copy of goldfish_tpu/om_shim.py for goldfish_tpu_torch, which may not
import the JAX package (`goldfish_tpu/__init__.py` pulls in jax); only the
imports and docstrings differ. It is a real, executing implementation of
the OpenMDAO API subset the component/driver layer uses (the reference
plate driver demos_om/thickness_opt/plate/plate_var_th_opt_wint.py:338-364
and its om_comps). `goldfish_tpu_torch.om_comps` imports real OpenMDAO when
available and falls back to this shim, so the adapter layer is executed
and derivative-checked either way.

Implemented semantics (matching OpenMDAO where it matters):
  - Component lifecycle: initialize -> options -> setup ->
    add_input/add_output/declare_partials.
  - ExplicitComponent: compute, compute_partials (dense sub-Jacobians
    keyed (of, wrt)), or constant `val=` partials from declare_partials.
  - ImplicitComponent: apply_nonlinear, solve_nonlinear, linearize,
    apply_linear (fwd/rev), solve_linear (fwd/rev) — the 6-method
    implicit protocol.
  - Group: add_subsystem, connect("comp.var", "comp.var"),
    add_design_var/add_constraint/add_objective (with scaler, bounds).
  - Problem: setup, run_model, run_driver, __getitem__/__setitem__,
    compute_totals, check_partials, check_totals.
  - ScipyOptimizeDriver: SLSQP via scipy.optimize.minimize with
    analytic total Jacobians from reverse-mode accumulation over the
    component DAG (the role of OpenMDAO's linear solves).
"""

from __future__ import annotations

import numpy as np

__all__ = ["IndepVarComp", "ExplicitComponent", "ImplicitComponent",
           "Group", "Problem", "ScipyOptimizeDriver",
           "pyOptSparseDriver", "api"]


class OptionsDictionary(dict):
    def declare(self, name, default=None, **kwargs):
        self.setdefault(name, default)


class _VarDict(dict):
    """Mutable mapping handed to component callbacks."""

    def __init__(self, names, store):
        super().__init__()
        self._store = store
        for n in names:
            super().__setitem__(n, store[n])

    def __setitem__(self, k, v):
        arr = np.asarray(v, dtype=float).reshape(self._store[k].shape)
        self._store[k] = arr
        super().__setitem__(k, arr)

    def get(self, k, default=None):
        return super().get(k, default)

    def flush(self):
        for k in self:
            self._store[k] = np.asarray(super().__getitem__(k))


class _Component:
    """Shared variable bookkeeping."""

    def __init__(self, **kwargs):
        self.options = OptionsDictionary()
        self.initialize()
        for k, v in kwargs.items():
            self.options[k] = v
        self.name = None
        self._inputs = {}      # name -> np array (current values)
        self._outputs = {}
        self._partials_decl = {}
        self._partials = {}    # (of, wrt) -> dense array

    def initialize(self):
        pass

    def setup(self):
        pass

    def add_input(self, name, shape=None, val=None, **kw):
        arr = _init_val(shape, val)
        self._inputs[name] = arr

    def add_output(self, name, shape=None, val=None, **kw):
        arr = _init_val(shape, val)
        self._outputs[name] = arr

    def declare_partials(self, of, wrt, val=None, rows=None, cols=None,
                         method="exact", step=1e-6, form="forward",
                         **kw):
        """OpenMDAO semantics incl. the COO-sparse form: with
        `rows`/`cols` given, `val` is the flat nonzero-data vector (and
        compute_partials may later assign just a new data vector of the
        same length) — the pattern the reference's sparse comps use
        (e.g. demos_om/shape_opt_mint/tube/custom_comps/xi_cons_comp.py
        :27-36 declares val=coo.data, rows=coo.row, cols=coo.col).

        `method='fd'`: the framework approximates this partial by
        finite-differencing `compute` (OpenMDAO's FD-partials fallback;
        openmdao.core.explicitcomponent `declare_partials(method='fd',
        step=..., form='forward'|'central'|'backward')`) —
        compute_partials is not called for these keys."""
        if method == "fd":
            self._fd_partials = getattr(self, "_fd_partials", {})
            self._fd_partials[(of, wrt)] = dict(step=float(step),
                                                form=form)
            return
        self._partials_decl[(of, wrt)] = val
        if of == "*" or wrt == "*":
            return
        if rows is not None:
            r = np.asarray(rows, dtype=int)
            c = np.asarray(cols, dtype=int)
            self._sparsity = getattr(self, "_sparsity", {})
            self._sparsity[(of, wrt)] = (r, c)
            if val is not None:
                n_of = self._outputs[of].size
                n_wrt = self._inputs[wrt].size
                dense = np.zeros((n_of, n_wrt))
                # duplicate (row, col) entries ACCUMULATE in OpenMDAO's
                # scipy-COO assembly — np.add.at, not fancy assignment
                np.add.at(dense, (r, c),
                          np.asarray(val, dtype=float).ravel())
                self._partials[(of, wrt)] = dense
        elif val is not None:
            self._partials[(of, wrt)] = np.asarray(val, dtype=float)

    def _in_names(self):
        return list(self._inputs)

    def _out_names(self):
        return list(self._outputs)


def _init_val(shape, val):
    if val is not None:
        arr = np.atleast_1d(np.asarray(val, dtype=float)).ravel()
        if shape is not None:
            n = int(np.prod(np.atleast_1d(shape)))
            if arr.size == 1 and n > 1:
                arr = np.full(n, arr[0])
            arr = arr.reshape(-1)
        return arr
    n = 1 if shape is None else int(np.prod(np.atleast_1d(shape)))
    return np.zeros(n)


class IndepVarComp(_Component):
    """Independent variables: outputs only."""

    def add_output(self, name, shape=None, val=None, **kw):
        super().add_output(name, shape=shape, val=val)


class ExplicitComponent(_Component):
    def compute(self, inputs, outputs):
        raise NotImplementedError

    def compute_partials(self, inputs, partials):
        pass

    # -- runtime --
    def _run(self):
        ins = _VarDict(self._inputs, self._inputs)
        outs = _VarDict(self._outputs, self._outputs)
        self.compute(ins, outs)
        outs.flush()

    def _jacobian(self):
        """Dense sub-Jacobians {(of, wrt): (n_of, n_wrt)}."""
        pd = _PartialsDict(self)
        self.compute_partials(_VarDict(self._inputs, self._inputs), pd)
        out = pd.as_dense(self)
        for (of, wrt), fd in getattr(self, "_fd_partials", {}).items():
            out[(of, wrt)] = self._fd_jacobian(of, wrt, **fd)
        return out

    def _fd_jacobian(self, of, wrt, step, form):
        """FD of `compute` for one (of, wrt) pair — the framework-side
        approximation behind declare_partials(method='fd'). Forms match
        OpenMDAO's ApproximationScheme: forward (default), backward,
        central."""
        x0 = self._inputs[wrt].copy()
        n_of = self._outputs[of].size
        n_wrt = x0.size
        J = np.zeros((n_of, n_wrt))

        def run_at(x):
            self._inputs[wrt] = x
            ins = _VarDict(self._inputs, self._inputs)
            outs = _VarDict(dict(self._outputs),
                            {k: v.copy() for k, v in
                             self._outputs.items()})
            self.compute(ins, outs)
            return np.asarray(outs.get(of)).ravel().copy()

        f0 = run_at(x0) if form in ("forward", "backward") else None
        for j in range(n_wrt):
            e = np.zeros(n_wrt)
            e[j] = step
            if form == "central":
                J[:, j] = (run_at(x0 + e) - run_at(x0 - e)) / (2 * step)
            elif form == "backward":
                J[:, j] = (f0 - run_at(x0 - e)) / step
            else:
                J[:, j] = (run_at(x0 + e) - f0) / step
        self._inputs[wrt] = x0
        return J


class _Solver:
    """Option container matching the OpenMDAO solver-options surface
    (openmdao.solvers.solver.Solver: maxiter/atol/rtol/iprint, Newton's
    solve_subsystems). The shim's ImplicitComponent honors an attached
    NewtonSolver in `_run` — the reference implicit comps set
    `nonlinear_solver_rtol`/`_max_it` through init_parameters
    (GOLDFISH/om_comps/disp_states_mi_comp.py:14-21), which real
    OpenMDAO plumbs into exactly these options."""

    def __init__(self, **kwargs):
        self.options = OptionsDictionary()
        self.options.declare("maxiter", default=10)
        self.options.declare("atol", default=1e-10)
        self.options.declare("rtol", default=1e-10)
        self.options.declare("iprint", default=1)
        self.options.declare("solve_subsystems", default=False)
        self.options.declare("err_on_non_converge", default=False)
        for k, v in kwargs.items():
            self.options[k] = v


class NewtonSolver(_Solver):
    pass


class NonlinearBlockGS(_Solver):
    pass


class DirectSolver(_Solver):
    pass


class ScipyKrylov(_Solver):
    pass


class ImplicitComponent(_Component):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.nonlinear_solver = None
        self.linear_solver = None

    def apply_nonlinear(self, inputs, outputs, residuals):
        raise NotImplementedError

    def solve_nonlinear(self, inputs, outputs):
        raise NotImplementedError

    def linearize(self, inputs, outputs, partials):
        pass

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        raise NotImplementedError

    def solve_linear(self, d_outputs, d_residuals, mode):
        raise NotImplementedError

    def _run(self):
        if isinstance(self.nonlinear_solver, NewtonSolver):
            return self._newton_run()
        ins = _VarDict(self._inputs, self._inputs)
        outs = _VarDict(self._outputs, self._outputs)
        self.solve_nonlinear(ins, outs)
        outs.flush()

    def _newton_run(self):
        """Framework-driven Newton when a NewtonSolver is attached
        (OpenMDAO semantics: the solver drives apply_nonlinear to zero
        with linearize + solve_linear(fwd) updates; convergence when
        |R| <= atol or |R| <= rtol*|R0|; maxiter caps iterations;
        err_on_non_converge raises om.AnalysisError analogously)."""
        opts = self.nonlinear_solver.options
        ins = _VarDict(self._inputs, self._inputs)

        def resid():
            res = _Bag({v: np.zeros_like(self._outputs[v])
                        for v in self._outputs})
            self.apply_nonlinear(ins, _Bag(dict(self._outputs)), res)
            return res

        r = resid()
        rn0 = max(np.sqrt(sum(float(np.sum(np.square(v)))
                              for v in r.values())), 1e-300)
        rn = rn0
        for it in range(int(opts["maxiter"])):
            if rn <= opts["atol"] or rn <= opts["rtol"] * rn0:
                break
            self.linearize(ins, _Bag(dict(self._outputs)), {})
            d_residuals = _Bag({v: -np.asarray(r[v]) for v in r})
            d_outputs = _Bag({v: np.zeros_like(self._outputs[v])
                              for v in self._outputs})
            self.solve_linear(d_outputs, d_residuals, "fwd")
            for v in self._outputs:
                self._outputs[v] = self._outputs[v] + np.asarray(
                    d_outputs[v]).reshape(self._outputs[v].shape)
            r = resid()
            rn = np.sqrt(sum(float(np.sum(np.square(v)))
                             for v in r.values()))
        if (rn > opts["atol"] and rn > opts["rtol"] * rn0
                and opts["err_on_non_converge"]):
            raise RuntimeError(
                f"NewtonSolver did not converge: |R|={rn:.3e}")

    def _linearize(self):
        self.linearize(_VarDict(self._inputs, self._inputs),
                       _VarDict(self._outputs, self._outputs), {})


class _PartialsDict(dict):
    """What compute_partials writes into."""

    def __init__(self, comp):
        super().__init__()
        self._comp = comp

    def __setitem__(self, key, val):
        super().__setitem__(key, np.asarray(val, dtype=float))

    def as_dense(self, comp):
        out = dict(comp._partials)  # constant declared vals
        sparsity = getattr(comp, "_sparsity", {})
        for (of, wrt), v in self.items():
            n_of = comp._outputs[of].size
            n_wrt = comp._inputs[wrt].size
            pat = sparsity.get((of, wrt))
            if pat is not None and v.size == pat[0].size:
                # COO-declared pattern: compute_partials assigned the
                # flat nonzero-data vector (OpenMDAO sparse semantics).
                # The declared pattern WINS even when nnz happens to
                # equal n_of*n_wrt (a size heuristic here misread such
                # patterns as dense C-order matrices);
                # duplicate coordinates accumulate as in scipy COO.
                dense = np.zeros((n_of, n_wrt))
                np.add.at(dense, (pat[0], pat[1]), v.ravel())
                out[(of, wrt)] = dense
            else:
                out[(of, wrt)] = v.reshape(n_of, n_wrt)
        return out


class Group:
    """Flat group (subsystems + connections). Nested groups collapse:
    add_subsystem of a Group inlines its children with dotted names."""

    def __init__(self, **kwargs):
        self._subs = {}          # name -> component
        self._conn = {}          # target "comp.var" -> source "comp.var"
        self._design_vars = {}   # "comp.var" -> dict
        self._constraints = {}
        self._objective = None
        self.options = OptionsDictionary()
        self.initialize()
        for k, v in kwargs.items():
            self.options[k] = v

    def initialize(self):
        pass

    def setup(self):
        pass

    def add_subsystem(self, name, comp, promotes=None, **kw):
        comp.name = name
        self._subs[name] = comp
        return comp

    def connect(self, src, tgt, src_indices=None):
        """`src_indices`: indices into the FLATTENED source array that
        feed the (smaller) target input — OpenMDAO's connection slicing
        (openmdao.core.group.Group.connect(src_indices=...),
        flat-source semantics)."""
        self._conn[tgt] = src if src_indices is None else (
            src, np.asarray(src_indices, dtype=int).ravel())

    def approx_totals(self, method="fd", step=1e-6, form="forward",
                      **kw):
        """Approximate SEMI-total derivatives across this group by one
        FD sweep over the group's run instead of chaining component
        partials (OpenMDAO Group.approx_totals). compute_totals then
        finite-differences run_model."""
        assert method == "fd", method
        self._approx_totals = dict(step=float(step), form=form)

    def add_design_var(self, name, lower=None, upper=None, scaler=None,
                       adder=None, ref=None, ref0=None, **kw):
        self._design_vars[name] = dict(lower=lower, upper=upper,
                                       scaler=scaler, adder=adder,
                                       ref=ref, ref0=ref0)

    def add_constraint(self, name, equals=None, lower=None, upper=None,
                       scaler=None, adder=None, ref=None, ref0=None,
                       **kw):
        self._constraints[name] = dict(equals=equals, lower=lower,
                                       upper=upper, scaler=scaler,
                                       adder=adder, ref=ref, ref0=ref0)

    def add_objective(self, name, scaler=None, adder=None, ref=None,
                      ref0=None, **kw):
        self._objective = (name, dict(scaler=scaler, adder=adder,
                                      ref=ref, ref0=ref0))


class ScipyOptimizeDriver:
    def __init__(self):
        self.options = OptionsDictionary()
        self.options.declare("optimizer", default="SLSQP")
        self.options.declare("tol", default=1e-8)
        self.options.declare("disp", default=True)
        self.options.declare("maxiter", default=200)
        self.options.declare("print_results", default=True)
        self.opt_settings = {}


class pyOptSparseDriver(ScipyOptimizeDriver):
    """Facade for the reference drivers' SNOPT/IPOPT route (reference:
    demos_om/shape_opt_mint/tube/tube_shopt_mi_4patch_wffd.py:434-443
    `om.pyOptSparseDriver` + `opt_settings['Major iterations limit']`
    etc.). pyOptSparse is not installable here; the shim translates the
    pyoptsparse option names onto its scipy-SLSQP totals engine (same
    move as the JAX package's pyoptsparse_shim.py) so those driver scripts
    run unchanged. `run_driver` reads the translation in
    `_driver_limits`."""

    def __init__(self):
        super().__init__()
        self.options["optimizer"] = "SNOPT"
        self.options["maxiter"] = 50000

    def _driver_limits(self):
        maxiter = int(self.options["maxiter"])
        tol = float(self.options["tol"])
        for key in ("Major iterations limit", "max_iter", "MAXIT", "MIT"):
            if key in self.opt_settings:
                maxiter = int(self.opt_settings[key])
        for key in ("Major optimality tolerance", "tol", "ACC", "TOLG"):
            if key in self.opt_settings:
                tol = float(self.opt_settings[key])
        return maxiter, tol


def _adder_scaler(meta):
    """OpenMDAO driver-scaling conventions
    (openmdao.utils.general_utils.determine_adder_scaler): the driver
    sees scaled = (physical + adder) * scaler; ref/ref0 mean physical
    `ref` maps to 1 and `ref0` to 0, i.e. scaler = 1/(ref - ref0),
    adder = -ref0; ref/ref0 are MUTUALLY EXCLUSIVE with scaler/adder.
    Model values, constraint bounds, and compute_totals stay UNSCALED
    — only the driver's view scales."""
    scaler, adder = meta.get("scaler"), meta.get("adder")
    ref, ref0 = meta.get("ref"), meta.get("ref0")
    if (ref is not None or ref0 is not None) and (
            scaler is not None or adder is not None):
        raise ValueError(
            "ref/ref0 are mutually exclusive with scaler/adder")
    if ref is not None or ref0 is not None:
        r0 = 0.0 if ref0 is None else float(ref0)
        r = 1.0 if ref is None else float(ref)
        return 1.0 / (r - r0), -r0
    return (1.0 if scaler is None else float(scaler),
            0.0 if adder is None else float(adder))


class Problem:
    def __init__(self, model=None):
        self.model = model if model is not None else Group()
        self.driver = ScipyOptimizeDriver()
        self._order = None

    # ---------- structure ----------
    def setup(self, **kw):
        self.model.setup()
        for comp in self.model._subs.values():
            comp.setup()
        self._order = self._toposort()
        return self

    def _toposort(self):
        subs = self.model._subs
        deps = {n: set() for n in subs}
        for tgt, src in self.model._conn.items():
            if isinstance(src, tuple):
                src = src[0]
            tc, _ = tgt.split(".", 1)
            sc, _ = src.split(".", 1)
            if tc != sc:
                deps[tc].add(sc)
        order, done = [], set()

        def visit(n, stack=()):
            if n in done:
                return
            if n in stack:
                raise RuntimeError(f"cycle through {n}")
            for m in sorted(deps[n]):
                visit(m, stack + (n,))
            done.add(n)
            order.append(n)

        for n in sorted(subs):
            visit(n)
        return order

    # ---------- values ----------
    def _resolve(self, path):
        cname, vname = path.split(".", 1)
        comp = self.model._subs[cname]
        if vname in comp._outputs:
            return comp._outputs, vname, comp
        if vname in comp._inputs:
            return comp._inputs, vname, comp
        raise KeyError(path)

    def __getitem__(self, path):
        store, vname, _ = self._resolve(path)
        return store[vname]

    def __setitem__(self, path, val):
        store, vname, _ = self._resolve(path)
        store[vname] = np.asarray(val, dtype=float).reshape(
            store[vname].shape)

    # ---------- nonlinear execution ----------
    def _push_connections(self, comp_name):
        comp = self.model._subs[comp_name]
        for vname in comp._inputs:
            tgt = f"{comp_name}.{vname}"
            src = self.model._conn.get(tgt)
            if src is not None:
                src, idx = src if isinstance(src, tuple) else (src, None)
                val = np.asarray(self[src], dtype=float).ravel()
                if idx is not None:
                    # flat-source indexing (Group.connect src_indices)
                    val = val[idx]
                comp._inputs[vname] = val.reshape(
                    comp._inputs[vname].shape)

    def run_model(self):
        for name in self._order:
            comp = self.model._subs[name]
            self._push_connections(name)
            if hasattr(comp, "_run"):
                comp._run()

    # ---------- derivatives ----------
    def _linearize_all(self):
        jacs = {}
        for name in self._order:
            comp = self.model._subs[name]
            if isinstance(comp, ExplicitComponent):
                jacs[name] = comp._jacobian()
            elif isinstance(comp, ImplicitComponent):
                comp._linearize()
        return jacs

    def compute_totals(self, of, wrt, jacs=None):
        """Reverse-mode totals over the DAG: {(of, wrt): dense}.

        of/wrt: lists of "comp.var" paths (outputs / design vars)."""
        at = getattr(self.model, "_approx_totals", None)
        if at is not None:
            return self._fd_totals(of, wrt, **at)
        if jacs is None:
            jacs = self._linearize_all()
        totals = {}
        for of_path in of:
            bars = self._reverse_sweep(of_path, jacs)
            for wrt_path in wrt:
                n_of = self[of_path].size
                n_wrt = self[wrt_path].size
                totals[(of_path, wrt_path)] = bars.get(
                    wrt_path, np.zeros((n_of, n_wrt)))
        return totals

    def _fd_totals(self, of, wrt, step, form):
        """Group.approx_totals engine: ONE finite-difference sweep over
        run_model per wrt dof (OpenMDAO's approximated semi-totals) —
        component partials and the reverse sweep are bypassed
        entirely. Restores the model state afterwards."""
        def snap(paths):
            return {p: np.asarray(self[p]).copy() for p in paths}

        x0 = snap(wrt)

        def eval_at():
            self.run_model()
            return {p: np.asarray(self[p]).ravel().copy() for p in of}

        f0 = eval_at() if form != "central" else None
        totals = {(o, w): np.zeros((self[o].size, self[w].size))
                  for o in of for w in wrt}
        for w in wrt:
            base = x0[w].ravel()
            for j in range(base.size):
                def run_pert(sgn):
                    pert = base.copy()
                    pert[j] += sgn * step
                    self[w] = pert.reshape(x0[w].shape)
                    out = eval_at()
                    self[w] = x0[w]
                    return out
                if form == "central":
                    fp, fm = run_pert(+1), run_pert(-1)
                    for o in of:
                        totals[(o, w)][:, j] = (fp[o] - fm[o]) / (2 * step)
                else:
                    fp = run_pert(+1)
                    for o in of:
                        totals[(o, w)][:, j] = (fp[o] - f0[o]) / step
        self.run_model()
        return totals

    def _reverse_sweep(self, of_path, jacs):
        """Seed each component of `of_path` and accumulate bars on every
        upstream variable. bars: path -> (n_of, n_var)."""
        n_of = self[of_path].size
        bars = {of_path: np.eye(n_of)}

        def bar_of(path):
            return bars.get(path)

        def add_bar(path, val):
            if path in bars:
                bars[path] = bars[path] + val
            else:
                bars[path] = val

        for name in reversed(self._order):
            comp = self.model._subs[name]
            if isinstance(comp, IndepVarComp):
                continue
            # collect output bars of this comp
            out_bars = {}
            for vname in comp._outputs:
                b = bar_of(f"{name}.{vname}")
                if b is not None:
                    out_bars[vname] = b
            if not out_bars:
                continue
            if isinstance(comp, ExplicitComponent):
                J = jacs[name]
                for (of_v, wrt_v), sub in J.items():
                    if of_v in out_bars and wrt_v in comp._inputs:
                        add_bar(f"{name}.{wrt_v}", out_bars[of_v] @ sub)
            else:  # implicit: d_in += -(dR/din)^T (dR/dout)^-T bar
                for vname, b in out_bars.items():
                    for row in range(b.shape[0]):
                        d_in = self._implicit_pullback(comp, vname,
                                                       b[row])
                        for wrt_v, contrib in d_in.items():
                            add_bar(f"{name}.{wrt_v}",
                                    _row_into(b.shape[0], row, contrib))
            # propagate across connections: input bars -> source outputs
            for vname in comp._inputs:
                tgt = f"{name}.{vname}"
                b = bars.get(tgt)
                if b is None:
                    continue
                src = self.model._conn.get(tgt)
                if src is not None:
                    src, idx = src if isinstance(src, tuple) \
                        else (src, None)
                    if idx is not None:
                        # scatter the target bar back into the source's
                        # flat columns; duplicate indices ACCUMULATE
                        # (the transpose of the src_indices gather)
                        wide = np.zeros((b.shape[0], self[src].size))
                        np.add.at(wide.T, idx, b.T)
                        b = wide
                    add_bar(src, b)
        return bars

    def _implicit_pullback(self, comp, out_name, bar_row):
        """One reverse linear solve + apply_linear for one seed row.

        OpenMDAO semantics: psi = (dR/du)^-T bar ; d_in = -(dR/din)^T
        psi. GOLDFISH implicit comps implement apply_linear so that
        d_inputs receives +(dR/din)^T d_residuals and solve_linear rev
        gives d_residuals = (dR/du)^-T d_outputs; the TOTAL derivative
        chain through the solve is d_in = -(dR/din)^T (dR/du)^-T bar.
        """
        # OpenMDAO passes ALL of the comp's output vars in d_outputs
        # (zeros where unseeded), not just the seeded one
        d_outputs = _Bag({v: (bar_row.copy() if v == out_name
                              else np.zeros_like(comp._outputs[v]))
                          for v in comp._outputs})
        d_residuals = _Bag({v: np.zeros_like(comp._outputs[v])
                            for v in comp._outputs})
        comp.solve_linear(d_outputs, d_residuals, "rev")
        d_inputs = _Bag({v: np.zeros_like(comp._inputs[v])
                         for v in comp._inputs})
        d_out2 = _Bag({v: np.zeros_like(comp._outputs[v])
                       for v in comp._outputs})
        comp.apply_linear(_Bag(dict(comp._inputs)),
                          _Bag(dict(comp._outputs)),
                          d_inputs, d_out2, d_residuals, "rev")
        return {v: -d_inputs[v] for v in d_inputs}

    # ---------- driver ----------
    def run_driver(self):
        from scipy.optimize import minimize

        model = self.model
        dv_paths = list(model._design_vars)
        assert model._objective is not None, "no objective set"
        obj_path, obj_meta = model._objective
        obj_scaler, obj_adder = _adder_scaler(obj_meta)

        sizes = [self[p].size for p in dv_paths]
        offsets = np.concatenate([[0], np.cumsum(sizes)])
        # (scaler, adder) per dv: driver-space x = (physical + adder)*sc
        sc_ad = [_adder_scaler(model._design_vars[p]) for p in dv_paths]
        scalers = [sa[0] for sa in sc_ad]

        def set_x(x):
            for p, s0, s1, (sc, ad) in zip(dv_paths, offsets[:-1],
                                           offsets[1:], sc_ad):
                self[p] = x[s0:s1] / sc - ad

        def get_x():
            return np.concatenate([
                (np.asarray(self[p]).ravel() + ad) * sc
                for p, (sc, ad) in zip(dv_paths, sc_ad)])

        cons_paths = list(model._constraints)
        state = {"x": None, "jacs": None}

        def ensure(x):
            if state["x"] is None or not np.array_equal(state["x"], x):
                set_x(x)
                self.run_model()
                state["x"] = x.copy()
                state["jacs"] = None

        def ensure_jac(x):
            ensure(x)
            if state["jacs"] is None:
                state["jacs"] = self._linearize_all()
                state["totals"] = self.compute_totals(
                    [obj_path] + cons_paths, dv_paths,
                    jacs=state["jacs"])

        def totals_row(of_path, scaler):
            T = np.concatenate(
                [state["totals"][(of_path, p)] / sc
                 for p, sc in zip(dv_paths, scalers)], axis=1)
            return T * scaler

        def f(x):
            ensure(x)
            return (float(self[obj_path]) + obj_adder) * obj_scaler

        def fgrad(x):
            ensure_jac(x)
            return totals_row(obj_path, obj_scaler)[0]

        constraints = []
        for cp in cons_paths:
            meta = model._constraints[cp]
            csc, _cad = _adder_scaler(meta)

            def make(cp=cp, meta=meta, csc=csc):
                eq = meta.get("equals")
                lo = meta.get("lower")
                up = meta.get("upper")
                out = []
                if eq is not None:
                    out.append(dict(
                        type="eq",
                        fun=lambda x: (_val(self, cp, x, ensure) -
                                       np.atleast_1d(eq)) * csc,
                        jac=lambda x: (ensure_jac(x),
                                       totals_row(cp, csc))[1]))
                if lo is not None:
                    out.append(dict(
                        type="ineq",
                        fun=lambda x: (_val(self, cp, x, ensure) -
                                       np.atleast_1d(lo)) * csc,
                        jac=lambda x: (ensure_jac(x),
                                       totals_row(cp, csc))[1]))
                if up is not None:
                    out.append(dict(
                        type="ineq",
                        fun=lambda x: (np.atleast_1d(up) -
                                       _val(self, cp, x, ensure)) * csc,
                        jac=lambda x: (ensure_jac(x),
                                       -totals_row(cp, csc))[1]))
                return out

            constraints.extend(make())

        bounds = None
        if any(model._design_vars[p].get("lower") is not None
               or model._design_vars[p].get("upper") is not None
               for p in dv_paths):
            bounds = []
            for p, (sc, ad) in zip(dv_paths, sc_ad):
                lo = model._design_vars[p].get("lower")
                up = model._design_vars[p].get("upper")
                n = self[p].size
                lo_arr = np.full(n, -np.inf) if lo is None \
                    else np.broadcast_to(
                        (np.asarray(lo, float) + ad) * sc, (n,))
                up_arr = np.full(n, np.inf) if up is None \
                    else np.broadcast_to(
                        (np.asarray(up, float) + ad) * sc, (n,))
                bounds.extend(zip(lo_arr, up_arr))

        x0 = get_x()
        if hasattr(self.driver, "_driver_limits"):
            maxiter, tol = self.driver._driver_limits()
        else:
            maxiter = int(self.driver.options["maxiter"])
            tol = float(self.driver.options["tol"])
        res = minimize(
            f, x0, jac=fgrad, method="SLSQP", bounds=bounds,
            constraints=constraints,
            options={"maxiter": maxiter, "ftol": tol,
                     "disp": bool(self.driver.options["disp"])})
        set_x(res.x)
        self.run_model()
        self._driver_result = res
        return not res.success

    # ---------- verification ----------
    def check_partials(self, compact_print=False, step=1e-6,
                       method="fd", out_stream=None):
        """FD-verify every component's declared partials / linear ops.

        Returns {comp: {(of, wrt): {'J_fwd':..., 'J_fd':...,
        'rel error': namedtuple-like}}} approximating OpenMDAO."""
        self.run_model()
        jacs = self._linearize_all()
        report = {}
        for name in self._order:
            comp = self.model._subs[name]
            if isinstance(comp, IndepVarComp):
                continue
            report[name] = {}
            if isinstance(comp, ExplicitComponent):
                J = jacs[name]
                for wrt in comp._inputs:
                    base_in = {k: v.copy() for k, v in
                               comp._inputs.items()}
                    n_wrt = comp._inputs[wrt].size
                    cols = {of: np.zeros((comp._outputs[of].size, n_wrt))
                            for of in comp._outputs}
                    for j in range(n_wrt):
                        for sgn in (+1, -1):
                            comp._inputs[wrt] = base_in[wrt].copy()
                            comp._inputs[wrt][j] += sgn * step
                            comp._run()
                            for of in comp._outputs:
                                cols[of][:, j] += sgn * \
                                    comp._outputs[of] / (2 * step)
                    comp._inputs[wrt] = base_in[wrt]
                    comp._run()
                    for of in comp._outputs:
                        Jan = J.get((of, wrt))
                        if Jan is None:
                            continue
                        report[name][(of, wrt)] = _errs(
                            Jan, cols[of], compact_print, name, of, wrt)
            else:
                report[name].update(self._check_implicit(
                    comp, step, compact_print))
        return report

    def _check_implicit(self, comp, step, compact_print):
        """FD of apply_nonlinear vs apply_linear fwd for each input AND
        the state; plus solve_linear consistency."""
        out = {}
        ins = {k: v.copy() for k, v in comp._inputs.items()}
        outs = {k: v.copy() for k, v in comp._outputs.items()}

        def residual():
            r = _Bag({k: np.zeros_like(v)
                      for k, v in comp._outputs.items()})
            comp.apply_nonlinear(_Bag(dict(comp._inputs)),
                                 _Bag(dict(comp._outputs)), r)
            return r

        rng = np.random.default_rng(0)
        for wrt, store in [(w, comp._inputs) for w in comp._inputs] + \
                          [(w, comp._outputs) for w in comp._outputs]:
            v = rng.normal(size=store[wrt].size)
            # FD directional derivative of R
            store[wrt] = store[wrt] + step * v
            rp = residual()
            store[wrt] = store[wrt] - 2 * step * v
            rm = residual()
            store[wrt] = store[wrt] + step * v
            fd = {k: (rp[k] - rm[k]) / (2 * step) for k in rp}
            # analytic via apply_linear fwd
            d_inputs = _Bag({k: np.zeros(comp._inputs[k].size)
                             for k in comp._inputs})
            d_outputs = _Bag({k: np.zeros(comp._outputs[k].size)
                              for k in comp._outputs})
            if wrt in comp._inputs:
                d_inputs[wrt] = v
            else:
                d_outputs[wrt] = v
            d_res = _Bag({k: np.zeros(comp._outputs[k].size)
                          for k in comp._outputs})
            comp.apply_linear(_Bag(dict(comp._inputs)),
                              _Bag(dict(comp._outputs)),
                              d_inputs, d_outputs, d_res, "fwd")
            for of in comp._outputs:
                out[(of, wrt)] = _errs(
                    d_res[of].reshape(-1, 1), fd[of].reshape(-1, 1),
                    compact_print, comp.name, of, wrt)
        return out

    def check_totals(self, of, wrt, step=1e-6, compact_print=False):
        self.run_model()
        totals = self.compute_totals(of, wrt)
        report = {}
        for wp in wrt:
            base = np.asarray(self[wp]).copy()
            for j in range(base.size):
                for sgn in (+1, -1):
                    x = base.copy()
                    x[j] += sgn * step
                    self[wp] = x
                    self.run_model()
                    for op in of:
                        key = (op, wp)
                        report.setdefault(key, np.zeros(
                            (self[op].size, base.size)))
                        report[key][:, j] += sgn * np.asarray(
                            self[op]).ravel() / (2 * step)
            self[wp] = base
            self.run_model()
        out = {}
        for key, fd in report.items():
            out[key] = _errs(totals[key], fd, compact_print,
                             "totals", key[0], key[1])
        return out


def _val(prob, path, x, ensure):
    ensure(x)
    return np.atleast_1d(np.asarray(prob[path], dtype=float).ravel())


def _row_into(n_rows, row, contrib):
    out = np.zeros((n_rows, contrib.size))
    out[row] = contrib
    return out


def _errs(Jan, Jfd, compact_print, comp, of, wrt):
    Jan = np.asarray(Jan, dtype=float)
    Jfd = np.asarray(Jfd, dtype=float).reshape(Jan.shape)
    denom = max(np.linalg.norm(Jfd), 1e-300)
    abs_err = float(np.linalg.norm(Jan - Jfd))
    rel = abs_err / denom if denom > 1e-250 else abs_err
    if compact_print:
        print(f"  {comp:28s} d{of}/d{wrt:24s} rel err {rel:.3e}")
    return {"J_fwd": Jan, "J_fd": Jfd,
            "abs error": abs_err, "rel error": rel}


class _Bag(dict):
    """Attribute-free mapping with .get, supporting containment like
    OpenMDAO's vectors."""

    def __contains__(self, k):
        return dict.__contains__(self, k)


class _Api:
    """`import goldfish_tpu_torch.om_shim as om; om.api` mirrors
    openmdao.api's namespace for the names the drivers use."""

    IndepVarComp = IndepVarComp
    ExplicitComponent = ExplicitComponent
    ImplicitComponent = ImplicitComponent
    Group = Group
    Problem = Problem
    ScipyOptimizeDriver = ScipyOptimizeDriver
    pyOptSparseDriver = pyOptSparseDriver
    NewtonSolver = NewtonSolver
    NonlinearBlockGS = NonlinearBlockGS
    DirectSolver = DirectSolver
    ScipyKrylov = ScipyKrylov


api = _Api()
