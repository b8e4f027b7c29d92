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
"""

from __future__ import annotations

import math

import torch

from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
from goldfish_tpu_torch.solver.system import (
    SystemData,
    potential_and_residual,
    residual_vjp,
)

__all__ = ["damped_newton", "newton_solve_host", "adjoint_lambda",
           "adjoint_solve", "build_solve_fn"]


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
                  rtol=1e-10, atol=1e-14, max_it=30, shared=None):
    """The damped Newton iteration of every persistent-factor solve: the
    residual-bounded energy line search, its bisection caps and the floor
    and stall stops. Returns (d, its, |r|).

    A warm-started solve that ends outside the Newton basin (|r| > 1e-2
    |r(0)|) is run once more from d = 0: at an optimizer trial design far
    from the last state the tangent at the warm state can be indefinite
    (its Cholesky fails) while the one at d = 0 is not.

    `direction(d, r, slow) -> (delta, slope)` gives the step for -r and its
    slope (a float); `slow` turns True, and stays so, once a step has
    contracted the residual by less than 4x. `refactor(d)` refreshes the
    factor at d when the line search found no descent. `shared` (optional
    dict) caches the load-scale reference |r(0)| across the solves of a
    warm optimizer loop (refreshed every 32 solves)."""
    args = (data, cp, h, direction, refactor, rtol, atol, max_it, shared)
    d, it, rn, r_ref = _newton_loop(d0, *args)
    if rn > 1e-2 * r_ref and bool(d0.any()):
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
    eps = torch.finfo(d0.dtype).eps

    d = d0
    stall = 0
    pinned = 0
    it = 0
    refactored_on_stall = False
    slow = False
    while it < max_it and rn > atol and rn > rtol * r_ref:
        delta, slope = direction(d, r, slow)
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
        for _ in range(0 if ls_fail else (1 if slope_tiny else n_bisect)):
            d_try, r_try, rn_try_, Pi_try_ = _trial(data, cp, h, d, delta,
                                                    alpha)
            Pi_try = float(Pi_try_)
            rn_try = None
            if slope_tiny or Pi_try <= (Pi0 + 1e-4 * alpha * slope
                                        + 16 * eps * abs(Pi0)):
                break
            alpha *= 0.5
        else:
            ls_fail = True
        if rn_try is None:
            rn_try = float(rn_try_)
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
    return d, it, rn, r_ref


def newton_solve_host(data: SystemData, fac: PersistentDeviceFactor, cp, h,
                      d0, rtol=1e-10, atol=1e-14, max_it=30, shared=None):
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
        rtol=rtol, atol=atol, max_it=max_it, shared=shared)


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

    def __init__(self, data, rtol, atol, max_it):
        self.data = data
        self.rtol = rtol
        self.atol = atol
        self.max_it = max_it
        self.factor = PersistentDeviceFactor(data)
        # adaptive floor hint: a warm solve stops once it reaches the
        # residual floor the previous solve achieved
        self.floor_hint = atol
        self.shared = {}
        self.last_its = None

    def solve(self, cp, h, d0):
        """Newton solve from d0 on the persistent factor (`newton_solve_host`)
        with the floor hint; returns d."""
        d, its, rn = newton_solve_host(
            self.data, self.factor, cp, h, d0, rtol=self.rtol,
            atol=max(self.atol, self.floor_hint), max_it=self.max_it,
            shared=self.shared)
        self.last_its = its
        if its < self.max_it and rn <= 1e-2 * self.shared["r_ref"]:
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


def build_solve_fn(data: SystemData, rtol=1e-10, atol=1e-14, max_it=30):
    """Return a differentiable `solve(cp, h, d0) -> d`.

    `data` is non-differentiable; design variables reach the physics only
    through cp and h. The persistent factor is exposed as
    `solve.device_factor`."""
    solver = _Solver(data, rtol, atol, max_it)

    def solve(cp, h, d0):
        return _ImplicitSolve.apply(solver, cp, h, d0)

    solve.device_factor = solver.factor
    solve.solver = solver
    return solve
