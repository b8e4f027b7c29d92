"""Differentiable implicit displacement solve (the adjoint engine).

Port of goldfish_tpu/solver/implicit.py on the persistent-factor path:

    d = solve(cp, h, d0)

is a `torch.autograd.Function` whose forward is a damped Newton solve
(`newton_solve_host`) and whose backward is the implicit-function adjoint

    K(d*) lam = dJ/dd,     (dJ/dcp, dJ/dh) -= lam^T dR/d(cp, h),

with K the exact symmetric tangent, solved on the persistent factor by
certificate-gated iterative refinement (`adjoint_solve`), and dR/d(cp, h)
from the shell and penalty kernels in adjoint mode.

The numerical policy is the reference's (ROADMAP "what crosses"): |r(0)|
as the Newton scale, the residual-bounded energy line search with its
bisection caps, the floor and stall stops, the drift / `stale_tol` logic,
and the certificate gates (direction forcing 1e-3 with near-miss
acceptance, adjoint 1e-6). The reference's single-readback speculation is
not carried over: every step reads its scalars when it needs them.

`continuation_solve` ramps the loads in levels (`system.scale_loads`) on
one persistent factor, each level's Newton warm-started from the last: the
two-plate contact press needs it.

`build_solve_fn_dataarg` is the same solve with the system as an argument
(`solve(data, cp, h, d0)`, a fresh factor a call): one function serves a
patch-sharded and an unsharded `SystemData`. On a sharded system every
rank runs the whole Newton loop and factor policy on replicated values
(all-reduced operators, the replicated factor), so every branch below is
taken alike on all ranks; `system.agree` checks it when the mesh's guard
is on.
"""

from __future__ import annotations

import math

import torch

from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
from goldfish_tpu_torch.solver.system import (
    SystemData,
    agree as _agree,
    potential_and_residual,
    residual_vjp,
    residual_vjp_field,
    scale_loads,
)

__all__ = ["damped_newton", "newton_solve_host", "continuation_solve",
           "adjoint_lambda",
           "adjoint_solve", "build_solve_fn", "build_field_solve_fn",
           "build_solve_fn_dataarg"]


# the polishing step's |r| may grow by this factor at the residual floor
POLISH_GROWTH = 8.0


def _entry(data: SystemData, cp, h, d0):
    """Load-scale |r(0)| (the convergence reference), r(d0), |r(d0)|,
    Pi(d0)."""
    _, r0 = potential_and_residual(data, torch.zeros_like(d0), cp, h)
    Pi, r = potential_and_residual(data, d0, cp, h)
    return torch.linalg.norm(r0), r, torch.linalg.norm(r), Pi


def _trial(data: SystemData, cp, h, d, delta, alpha):
    """Line-search trial state: d_try, its residual, |r|, potential."""
    d_new = d + alpha * delta
    Pi, r = potential_and_residual(data, d_new, cp, h)
    return d_new, r, torch.linalg.norm(r), Pi


def damped_newton(data: SystemData, cp, h, d0, direction, refactor,
                  rtol=1e-10, atol=1e-14, max_it=30, shared=None,
                  rerun_cold=True):
    """The damped Newton iteration of every persistent-factor solve: the
    residual-bounded energy line search, its bisection caps and the floor
    and stall stops. Returns (d, its, |r|).

    A warm-started solve that ends outside the Newton basin (|r| > 1e-2
    |r(0)|) is run once more from d = 0 (unless `rerun_cold` is False): at
    an optimizer trial design far from the last state the tangent at the
    warm state can be indefinite (its Cholesky fails) while the one at
    d = 0 is not. Continuation levels turn it off: a rerun from d = 0 would
    take the level's whole load at once, which is what the levels avoid.

    `direction(d, r, slow) -> (delta, slope)` gives the step for -r and its
    slope (a float); `slow` turns True, and stays so, once a step has
    contracted the residual by less than 4x. `refactor(d)` refreshes the
    factor at d when the line search found no descent. `shared` (optional
    dict) caches the load-scale reference |r(0)| across the solves of a
    warm optimizer loop (refreshed every 32 solves)."""
    args = (data, cp, h, direction, refactor, rtol, atol, max_it, shared)
    d, it, rn, r_ref = _newton_loop(d0, *args)
    if rerun_cold and rn > 1e-2 * r_ref and bool(d0.any()):
        d, it, rn, _ = _newton_loop(torch.zeros_like(d0), *args)
    return d, it, rn


def _newton_loop(d0, data, cp, h, direction, refactor, rtol, atol, max_it,
                 shared):
    """One damped Newton run from d0: (d, its, |r|, |r(0)|)."""
    if (shared is not None and "r_ref" in shared
            and shared.get("r_ref_age", 0) < 32):
        r_ref = shared["r_ref"]
        shared["r_ref_age"] = shared.get("r_ref_age", 0) + 1
        Pi, r = potential_and_residual(data, d0, cp, h)
        rn, Pi0 = float(torch.linalg.norm(r)), float(Pi)
    else:
        r_ref_, r, rn_, Pi = _entry(data, cp, h, d0)
        r_ref, rn, Pi0 = float(r_ref_), float(rn_), float(Pi)
        if shared is not None:
            shared["r_ref"] = r_ref
            shared["r_ref_age"] = 0
    r_ref = max(max(r_ref, rn * 1e-6), 1e-300)
    _agree(data, "newton entry", r_ref, rn, Pi0)
    eps = torch.finfo(d0.dtype).eps

    d = d0
    stall = 0
    pinned = 0
    it = 0
    refactored_on_stall = False
    slow = False
    while it < max_it and rn > atol and rn > rtol * r_ref:
        delta, slope = direction(d, r, slow)
        _agree(data, "newton slope", slope)
        # 64x-eps margin: below it the Armijo test is roundoff
        slope_tiny = abs(slope) <= 64.0 * eps * abs(Pi0) + 1e-300

        alpha = 1.0
        ls_fail = False
        if not math.isfinite(slope):
            # non-finite direction: no alpha fixes NaN * alpha
            ls_fail = True
            d_try, r_try, rn_try, Pi_try = d, r, rn, Pi0
        # floor-basin bisection cap: deep in the Newton basin 8 halvings
        # are plenty; cold solves keep 30
        n_bisect = 30 if rn > 1e-2 * r_ref else 8
        full = None
        for _ in range(0 if ls_fail else (1 if slope_tiny else n_bisect)):
            d_try, r_try, rn_try_, Pi_try_ = _trial(data, cp, h, d, delta,
                                                    alpha)
            Pi_try = float(Pi_try_)
            rn_try = None
            if full is None:
                full = (d_try, r_try, rn_try_, Pi_try)
            if slope_tiny or Pi_try <= (Pi0 + 1e-4 * alpha * slope
                                        + 16 * eps * abs(Pi0)):
                break
            alpha *= 0.5
        else:
            ls_fail = True
        if rn_try is None:
            rn_try = float(rn_try_)
        _agree(data, "line search", alpha, Pi_try, rn_try, float(ls_fail))
        if ls_fail and full is not None and rn <= 1e-2 * r_ref:
            rn_full = float(full[2])
            if rn_full <= 0.5 * rn:
                # in the Newton basin the energy's roundoff (~1e-13 |Pi|,
                # the membrane strains cancel) can hide the decrease of a
                # step that the residual shows: take the full step rather
                # than stop at a floor it has not reached (ROADMAP Queue C,
                # a deliberate difference from the reference)
                d_try, r_try, _, Pi_try = full
                rn_try, alpha, ls_fail = rn_full, 1.0, False
        if ls_fail and rn <= 1e-2 * r_ref and math.isfinite(slope) \
                and slope < 0.0:
            # line search exhausted in the Newton basin with a descent
            # direction: the energy cannot resolve further progress (the
            # residual floor). Gated on slope < 0, unlike the reference
            # (ROADMAP Queue C): a non-descent direction refactors below.
            break
        if ls_fail and not refactored_on_stall:
            # stale direction not a descent direction: refresh the factor
            # at the current state and retry this iteration
            refactor(d)
            refactored_on_stall = True
            continue
        if not ls_fail:
            refactored_on_stall = False
        if slope_tiny and rn_try >= rn:
            # the residual floor: neither the energy nor |r| can see the
            # step. In the Newton basin it is still taken, as the
            # reference takes it, since it removes the soft modes' error
            # that |r| no longer shows (see `_polish`)
            if rn <= 1e-2 * r_ref and rn_try <= POLISH_GROWTH * rn:
                d, r, rn = d_try, r_try, rn_try
                it += 1
            break
        rn_prev = rn
        d, r, rn, Pi_new = d_try, r_try, rn_try, Pi_try
        it += 1
        res_stalled = rn > 0.5 * rn_prev
        # residual pinned at its achievable floor inside the basin
        if rn <= 1e-2 * r_ref and rn > 0.98 * rn_prev:
            pinned += 1
            if pinned >= 2:
                break
        else:
            pinned = 0
        if rn > 0.25 * rn_prev and rn > rtol * r_ref:
            slow = True
        if slope_tiny and res_stalled:
            break
        if (Pi_new >= Pi0 - 64 * eps * abs(Pi0)) and res_stalled:
            stall += 1
            if stall >= 3:
                break
        else:
            stall = 0
        Pi0 = Pi_new
    else:
        if rn <= atol or rn <= rtol * r_ref:
            # the stop test passed: one more step, so that the solve does
            # not end sitting on its threshold
            d, r, rn = _polish(data, cp, h, d, r, rn, direction, slow)
    return d, it, rn, r_ref


def _polish(data, cp, h, d, r, rn, direction, slow):
    """One more full Newton step once the stop test has passed (a
    deliberate difference from the reference, ROADMAP C2, C10).

    An inexact-Newton step (forcing 1e-3) can end just under the
    threshold, so without it the state a solve returns would depend on
    which side of the test rounding put |r|: finite differences of the
    design see the stopping error, and an optimizer's iterates can
    branch. At the residual floor |r| is roundoff in the stiff (membrane)
    modes and can no longer show the error left in the soft (bending)
    modes, which the step still removes; the floor moves |r| by up to ~4x
    from one state to the next. So the step is kept unless |r| grows past
    `POLISH_GROWTH` times its value (a failed step), not only when |r|
    drops. Its cost: one direction (one IR solve on the kept factor) and
    one residual."""
    delta, _ = direction(d, r, slow)
    d_try, r_try, rn_try, _ = _trial(data, cp, h, d, delta, 1.0)
    rn_try = float(rn_try)
    _agree(data, "polish", rn_try)
    if rn_try <= POLISH_GROWTH * rn:
        return d_try, r_try, rn_try
    return d, r, rn


def newton_solve_host(data: SystemData, fac: PersistentDeviceFactor, cp, h,
                      d0, rtol=1e-10, atol=1e-14, max_it=30, shared=None,
                      rerun_cold=True):
    """Damped Newton on one persistent factor. Returns (d, its, |r|).

    Directions are substitutions against the (possibly stale) factor
    while it is fresh, and certificate-validated IR-exact directions once
    it is design-stale or the contraction slows. The energy line search
    guarantees descent (`damped_newton`)."""
    use_ir = False

    def direction(d, r, slow):
        nonlocal use_ir
        # slow contraction: the factor is too stale; switch to IR-exact
        # directions rather than crawl or refactor
        use_ir = use_ir or slow
        if not use_ir:
            if fac._ref is None:
                fac.ensure(cp, h, d)
            drift = float(fac.drift_scalar(cp, h, d))
            _agree(data, "direction drift", drift)
            if drift > 0.2:
                # grossly stale (cold transient): refresh at this state
                fac.ensure(cp, h, d, force=True, why="drift")
            elif drift > fac.stale_tol:
                # design-stale by an optimizer-sized step: ride the IR
                # certificate instead of refactoring
                use_ir = True
        if use_ir:
            return fac.newton_direction(cp, h, d, r)
        delta, slope = fac.direction_slope(r)
        return delta, float(slope)

    return damped_newton(
        data, cp, h, d0, direction,
        lambda d: fac.ensure(cp, h, d, force=True, why="stall"),
        rtol=rtol, atol=atol, max_it=max_it, shared=shared,
        rerun_cold=rerun_cold)


def continuation_solve(data: SystemData, cp, h, d0, n_steps=5, rtol=1e-10,
                       atol=1e-14, max_it=30, fac=None, log=None):
    """Load-stepped Newton (port of the reference's continuation_solve):
    level k of n_steps solves at `scale_loads(data, k / n_steps)` from the
    last level's d, all on ONE persistent factor (`fac`, default a fresh
    Cholesky one). The factor's data follows the level, so its tangent is
    the level's (a follower pressure's depends on the load); no level
    reruns from d = 0. Returns (d, its_last, |r|_last); `log`, when given,
    gets one (its, |r|) per level."""
    fac = PersistentDeviceFactor(data) if fac is None else fac
    d = d0
    for k in range(1, n_steps + 1):
        data_s = scale_loads(data, k / n_steps)
        fac.data = data_s
        d, it, rn = newton_solve_host(data_s, fac, cp, h, d, rtol=rtol,
                                      atol=atol, max_it=max_it,
                                      rerun_cold=False)
        if log is not None:
            log.append((it, rn))
    return d, it, rn


def adjoint_lambda(data: SystemData, fac: PersistentDeviceFactor, d, cp, h,
                   g):
    """K(d) lam = g on the free dofs (lam masked) by certificate-gated IR
    (tol 1e-6) on the persistent factor.

    The first attempt sizes its sweeps from the measured contraction; a
    failed certificate refactors when the factor is grossly stale and
    falls back to the self-validating `exact_solve`."""
    b = g * data.free
    if fac._ref is not None:
        drift = float(fac.drift_scalar(cp, h, d))
        x, ratio, n, rho_last = fac.ir_solve_async_dir(cp, h, d, b)
        if fac.finish_ir(n, ratio, float(rho_last)):
            return x * data.free
        if drift > 0.2:
            fac.ensure(cp, h, d, force=True, why="adjoint-drift")
    else:
        fac.ensure(cp, h, d, why="adjoint")
    return fac.exact_solve(cp, h, d, b) * data.free


def adjoint_solve(data: SystemData, fac: PersistentDeviceFactor, d, cp, h,
                  g):
    """Implicit-function adjoint on the persistent factor: lam =
    `adjoint_lambda`, then (dcp, dh) = -lam^T dR/d(cp, h)."""
    return residual_vjp(data, d, cp, h,
                        adjoint_lambda(data, fac, d, cp, h, g))


class _Solver:
    """State shared by the forward and backward of one solve function:
    the persistent factor, the Newton floor hint and the cached |r(0)|."""

    def __init__(self, data, rtol, atol, max_it, kind="cholesky"):
        self.data = data
        self.rtol = rtol
        self.atol = atol
        self.max_it = max_it
        self.factor = PersistentDeviceFactor(data, kind=kind)
        # adaptive floor hint: a warm solve stops once it reaches the
        # residual floor the previous solve achieved
        self.floor_hint = atol
        self.shared = {}
        self.last_its = None

    def solve(self, cp, h, d0, data=None):
        """Newton solve from d0 on the persistent factor (`newton_solve_host`)
        with the floor hint; returns d. `data` (default: the solver's own)
        may differ from the factor's by a load that leaves the tangent
        unchanged (the areal field load); the cached |r(0)| is then taken
        afresh, since it is the scale of that load."""
        shared = self.shared if data is None else {}
        d, its, rn = newton_solve_host(
            self.data if data is None else data, self.factor, cp, h, d0,
            rtol=self.rtol, atol=max(self.atol, self.floor_hint),
            max_it=self.max_it, shared=shared)
        self.last_its = its
        if its < self.max_it and rn <= 1e-2 * shared["r_ref"]:
            # converged or floored in the Newton basin (not truncated, not
            # failed: a failed solve's |r| would stop every later solve)
            self.floor_hint = max(self.atol, 1.5 * rn)
        return d


class _ImplicitSolve(torch.autograd.Function):

    @staticmethod
    def forward(ctx, solver: _Solver, cp, h, d0):
        d = solver.solve(cp, h, d0)
        ctx.solver = solver
        ctx.save_for_backward(d, cp, h)
        return d

    @staticmethod
    def backward(ctx, g):
        d, cp, h = ctx.saved_tensors
        dcp, dh = adjoint_solve(ctx.solver.data, ctx.solver.factor, d, cp,
                                h, g)
        return None, dcp, dh, None


def build_solve_fn(data: SystemData, rtol=1e-10, atol=1e-14, max_it=30,
                   kind="cholesky"):
    """Return a differentiable `solve(cp, h, d0) -> d`.

    `data` is non-differentiable; design variables reach the physics only
    through cp and h. The persistent factor (`kind` "cholesky", or "lu" for
    a tangent that is indefinite by nature, as a hinged structure under
    follower pressure is at d = 0) is exposed as `solve.device_factor`."""
    solver = _Solver(data, rtol, atol, max_it, kind)

    def solve(cp, h, d0):
        return _ImplicitSolve.apply(solver, cp, h, d0)

    solve.device_factor = solver.factor
    solve.solver = solver
    return solve


class _FieldSolve(torch.autograd.Function):

    @staticmethod
    def forward(ctx, solver: _Solver, cp, h, f, d0):
        data_f = solver.data._replace(f_field=f)
        d = solver.solve(cp, h, d0, data=data_f)
        solver.its_log.append(solver.last_its)
        ctx.solver = solver
        ctx.data_f = data_f
        ctx.save_for_backward(d, cp, h)
        return d

    @staticmethod
    def backward(ctx, g):
        d, cp, h = ctx.saved_tensors
        s = ctx.solver
        # the factor's tangent is the one of `s.data`, without f: the
        # field load is dead and linear in d, so K does not depend on it
        lam = adjoint_lambda(ctx.data_f, s.factor, d, cp, h, g)
        dcp, dh, df = residual_vjp_field(ctx.data_f, d, cp, h, lam)
        # no cotangent for d0: the coupled gradient reaches the previous
        # state through f only
        return None, dcp, dh, df, None


class _DataArgSolve(torch.autograd.Function):

    @staticmethod
    def forward(ctx, data, cp, h, d0, rtol, atol, max_it):
        cp, h = cp.detach(), h.detach()
        fac = PersistentDeviceFactor(data)
        d, _, _ = newton_solve_host(data, fac, cp, h, d0.detach(), rtol=rtol,
                                    atol=atol, max_it=max_it)
        ctx.data, ctx.fac = data, fac
        ctx.save_for_backward(d, cp, h)
        return d

    @staticmethod
    def backward(ctx, g):
        d, cp, h = ctx.saved_tensors
        dcp, dh = adjoint_solve(ctx.data, ctx.fac, d, cp, h, g)
        return None, dcp, dh, None, None, None, None


def build_solve_fn_dataarg(rtol=1e-10, atol=1e-14, max_it=30):
    """Differentiable `solve(data, cp, h, d0) -> d` with the system as an
    argument (port of the reference's build_solve_fn_dataarg, the form its
    multi-process run needs). `data` is not differentiable. The forward is
    `newton_solve_host` on a fresh `PersistentDeviceFactor` a call (no
    state is kept across calls, as in the reference's form); the backward
    is the adjoint (`adjoint_solve`) on that factor. The same `solve`
    takes a patch-sharded SystemData (`parallel.sharding.shard_system`)
    and an unsharded one."""

    def solve(data, cp, h, d0):
        return _DataArgSolve.apply(data, cp, h, d0, rtol, atol, max_it)

    return solve


def build_field_solve_fn(data: SystemData, rtol=1e-9, atol=1e-14, max_it=30):
    """Differentiable `solve(cp, h, f, d0) -> d` with the distributed force
    field f (P, C, 3) as an adjoint input (port of the reference's
    build_field_solve_fn): dJ/df comes out of the same implicit adjoint as
    dJ/d(cp, h). One persistent factor and floor hint serve every call;
    the Newton scale |r(0)| is taken afresh on every call, because each
    call may bring another f (each pass of a fixed-point loop does).
    `solve.solver.its_log` lists the Newton iterations of every call."""
    if data.f_field is not None:
        raise ValueError("build_field_solve_fn takes f as an argument: "
                         "data.f_field must be None")
    solver = _Solver(data, rtol, atol, max_it)
    solver.its_log = []

    def solve(cp, h, f, d0):
        return _FieldSolve.apply(solver, cp, h, f, d0)

    solve.device_factor = solver.factor
    solve.solver = solver
    return solve
