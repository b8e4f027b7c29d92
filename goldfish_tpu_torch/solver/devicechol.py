"""One persistent f64 factor (Cholesky or LU) + refinement against the exact
tangent.

Port of goldfish_tpu/solver/devicechol.py (`PersistentDeviceFactor`):

  1. the dense BC-reduced f64 tangent K(d) is assembled from the jet
     Hessians (kernels K1/K2 mode (b) + K3);
  2. Jacobi equilibration D K D, D = diag(K)^(-1/2), then the Cholesky
     factor with the inverses of its diagonal blocks (solver/cholesky.
     chol_factor: kernel K14 on the card, in place in the assembled K), or,
     for a factor made with kind="lu", `torch.linalg.lu_factor_ex` (getrf);
  3. substitutions with K13 (solver/cholesky.chol_solve: the factor read
     in place, the equilibration folded in) or `lu_solve`; iterative
     refinement
     x += K_fac^-1 (b - K(d) x) whose matvec is the EXACT tangent product
     at the current state (kernel K4 on jet Hessians recomputed once per
     solve), so a design- or state-stale factor still solves exactly. A
     solve may start from a seed x0 (the secant-extrapolated previous
     adjoint): one sweep fewer for the same certificate, and a bad seed
     only fails the certificate.

The factor is amortized across Newton and optimizer iterations; the
certificate |dx_n| / |x| of every refinement solve drives the policy that
decides when to add sweeps or refactor (the reference's ρ policy, with the
sweep count as a plain runtime loop bound).

The policy is written once over an opaque solver state (a tuple whose last
entry is the displacement d); the problem enters only through the hooks
`_assemble`, `_operator`, `_drift`, `_subst` and `_after_factor`.
`PersistentDeviceFactor` is the fixed-intersection problem with state
(cp, h, d); solver/system_mi.PersistentDeviceFactorMI is the
moving-intersection one with state (cp, h, xi, d).

An indefinite K (possible at a cold or trial state) makes `chol_factor`
report info != 0 (`torch.linalg.cholesky_ex`'s meaning). The factor and its
diagonal inverses are then filled with NaN, so every solve against it
returns a non-finite certificate and goes through the same policy as any
non-finite certificate; the failure is also logged in `refactor_log` and
counted in `n_factor_failed`. The LU variant is for
tangents that are indefinite by nature (past a limit point: solver/riks.py);
it fails only on an exactly singular K (`lu_factor_ex` info != 0), with the
same bookkeeping. A caller picks the variant by name; a failed Cholesky
never turns into an LU by itself.
"""

from __future__ import annotations

import math
import warnings

import torch

from goldfish_tpu_torch.solver.cholesky import chol_factor, chol_solve
from goldfish_tpu_torch.solver.system import (
    SystemData,
    agree,
    assemble_K_from,
    jet_hessians,
    jet_tables,
    tangent_matvec_from,
)

__all__ = ["PersistentDeviceFactor"]


class PersistentDeviceFactor:
    """ONE f64 factorization amortized across Newton AND optimizer
    iterations.

    - `direction_slope(r)`: substitution-only Newton direction for -r and
      its Armijo slope (inexact, safe under the energy line search);
    - `newton_direction(cp, h, d, r)`: certificate-validated IR-exact
      direction (forcing tolerance 1e-3);
    - `exact_solve(cp, h, d, b, x0=None)`: self-validating IR solve (1e-6),
      optionally seeded;
    - `ensure(cp, h, d)`: refactor only when the state drifted more than
      `stale_tol` since the last factorization.

    `kind` is "cholesky" (the default) or "lu".
    """

    _RHO0 = 1e-3        # optimistic initial contraction estimate
    _MAX_SWEEPS = 16
    _DIR_TOL = 1e-3     # inexact-Newton forcing of IR directions
    _ADJOINT_TOL = 1e-6  # certificate gate of adjoint-grade solves
    stale_tol = 5e-3    # relative state drift that makes a factor stale
    # measured-contraction refresh threshold (devicechol.py:335-354 of the
    # reference): a factor pinned at a bad state keeps passing certificates
    # at rho ~0.26-0.6; healthy one-step-stale factors measure 0.07-0.18
    rho_refresh = 0.22

    def __init__(self, data: SystemData, kind: str = "cholesky"):
        if kind not in ("cholesky", "lu"):
            raise ValueError(f"kind: 'cholesky' or 'lu', not {kind!r}")
        self.kind = kind
        self.data = data
        self.tables = jet_tables(data)
        self.rho_est = self._RHO0
        self._ref = None         # solver state at factor time
        self._L = None           # Cholesky factor, or (LU, pivots)
        self._invs = None        # its diagonal blocks' inverses (K13)
        self._dscale = None
        self.factor_ok = False
        self.n_factor = 0
        self.n_factor_failed = 0
        self.last_ratio = 0.0    # certificate of the last IR solve
        self.nonconverged = False
        self.refactor_log = []   # (why, drift) per factorization
        self.failed_info = []    # chol_factor / lu_factor_ex info of each
                                 # failed one
        self.cert_log = []       # (tag, n_ir, ratio) per IR attempt

    # ------------------------------------------------------------ hooks
    def _assemble(self, s):
        """Dense BC-reduced tangent at state s."""
        cp, h, d = s
        return assemble_K_from(self.tables, jet_hessians(self.data, d, cp, h))

    def _operator(self, s):
        """The exact tangent product v -> K(d) v at state s (jet Hessians
        computed once)."""
        cp, h, d = s
        Hs = jet_hessians(self.data, d, cp, h)
        return lambda v: tangent_matvec_from(self.tables, Hs, v)

    @staticmethod
    def _drift(s, ref):
        """Relative state drift since the factorization, each field
        normalized by its own scale; the tiny floor on the d-scale makes
        any first step from d0 = 0 register as full drift."""
        (cp, h, d), (cp0, h0, d0) = s, ref
        dcp = torch.linalg.norm(cp - cp0) / (torch.linalg.norm(cp0) + 1e-300)
        dh = torch.linalg.norm(h - h0) / (torch.linalg.norm(h0) + 1e-300)
        d_scale = torch.linalg.norm(d0) + 1e-6 * torch.linalg.norm(cp0) \
            + 1e-300
        dd = torch.linalg.norm(d - d0) / d_scale
        return torch.maximum(torch.maximum(dcp, dh), dd)

    def _after_factor(self, s):
        """Called after every factorization at state s."""

    def _agree(self, where, *values):
        """The decision guard of a patch-sharded system (`system.agree`):
        the factor is replicated, so its certificates and drifts must have
        the same bits on every rank."""
        agree(self.data, where, *values)

    def _fac_solve(self, B):
        """K_fac^-1 B for B (N, k) through the equilibrated factor."""
        if self.kind == "lu":
            dsc = self._dscale[:, None]
            return dsc * torch.linalg.lu_solve(*self._L, dsc * B)
        return chol_solve(self._L, self._dscale, B, self._invs)

    def _subst(self, b):
        """K_fac^-1 b (the preconditioner of every refinement sweep)."""
        return self._fac_solve(b.reshape(-1, 1))[:, 0].reshape(b.shape)

    # ------------------------------------------------------------ factor
    def _ensure(self, s, force=False, why="", stale_tol=None):
        """Refactor at state s if it drifted more than `stale_tol`
        (default the instance's) or when forced; True when a factorization
        ran."""
        drift = -1.0
        if self._ref is not None and not force:
            drift = float(self._drift(s, self._ref))
            if drift <= (self.stale_tol if stale_tol is None else stale_tol):
                return False
        K = self._assemble(s)
        dsc = torch.rsqrt(K.diagonal().abs() + 1e-300)
        K.mul_(dsc[:, None]).mul_(dsc[None, :])   # equilibrate in place
        invs = None
        if self.kind == "lu":
            LU, piv, info = torch.linalg.lu_factor_ex(K)
            L = (LU, piv)
        else:
            L, info, invs = chol_factor(K)   # K consumed on the card
            LU = L
        del K
        self.factor_ok = int(info) == 0
        self._agree("factor", drift, int(info))
        why = why or "drift"
        if not self.factor_ok:
            LU.fill_(float("nan"))
            if invs is not None:
                invs.fill_(float("nan"))
            self.n_factor_failed += 1
            self.failed_info.append(int(info))
            why += "/indefinite"
        self._L, self._invs, self._dscale = L, invs, dsc
        self._ref = s
        self.n_factor += 1
        self.rho_est = self._RHO0
        self.refactor_log.append((why, drift))
        self._after_factor(s)
        return True

    def ensure(self, cp, h, d, force=False, why=""):
        """Refactor if stale (or forced); True when a factorization ran."""
        return self._ensure((cp, h, d), force, why)

    def _drift_now(self, s):
        return None if self._ref is None else self._drift(s, self._ref)

    def drift_scalar(self, cp, h, d):
        """State drift vs the factor reference (0-dim tensor), or None
        when no factor exists yet."""
        return self._drift_now((cp, h, d))

    def direction_slope(self, r):
        """Substitution-only direction for -r (free-masked) and the Armijo
        slope r . delta (0-dim tensor)."""
        delta = self._subst(-r) * self.data.free
        return delta, torch.sum(r * delta)

    # ------------------------------------------------------------ IR solves
    def _ir_solve(self, s, b, n_ir: int, x0=None):
        """n_ir refinement sweeps against K(d) at state s (the matvec's jet
        Hessians computed once), from the substitution of b or from the
        seed x0. Returns (x, ratio, rho_last) with ratio = |dx_n| / |x| the
        certificate and rho_last = |dx_n| / |dx_{n-1}| the last sweep's
        contraction."""
        matvec = self._operator(s)
        free = self.data.free
        x = self._subst(b) if x0 is None else x0
        last = prev = torch.linalg.norm(x)
        for _ in range(n_ir):
            res = (b - matvec(x)) * free
            dx = self._subst(res)
            x = x + dx
            prev, last = last, torch.linalg.norm(dx)
        ratio = last / (torch.linalg.norm(x) + 1e-300)
        return x, ratio, last / (prev + 1e-300)

    def _ir_dir(self, s, r, n_ir: int):
        """IR-exact direction for -r: (delta, ratio, slope, rho_last)."""
        x, ratio, rho_last = self._ir_solve(s, -r, n_ir)
        delta = x * self.data.free
        return delta, ratio, torch.sum(r * delta), rho_last

    # ------------------------------------------------------------ ρ policy
    def _n_for(self, tol, rho, seeded=False):
        """Sweeps for a certificate below tol at contraction rho (a plain
        runtime count in 1.._MAX_SWEEPS); a good seed's entry error is
        already small, so a seeded solve takes one sweep fewer."""
        if not math.isfinite(rho):
            rho = 0.9
        rho = min(max(rho, 1e-4), 0.9)
        n = math.ceil(math.log(tol) / math.log(rho)) + 1
        if seeded:
            n -= 1
        return min(max(n, 1), self._MAX_SWEEPS)

    @staticmethod
    def _inputs_finite(*tensors):
        return all(bool(torch.isfinite(t).all()) for t in tensors)

    def _rho(self, n_ir):
        """Per-sweep contraction ratio^(1/n) of the last certificate."""
        if not math.isfinite(self.last_ratio):
            return 0.9
        if self.last_ratio <= 0.0:
            return 1e-4
        return self.last_ratio ** (1.0 / n_ir)

    def _rho_meas(self, n_ir, rho_last=None):
        """min(rho_last, ratio^(1/n)): ratio^(1/n) is tol-biased high,
        rho_last is noise at the roundoff floor; the min is right in
        both regimes."""
        base = self._rho(n_ir)
        if rho_last is not None and math.isfinite(rho_last) \
                and rho_last > 0.0:
            return min(max(min(float(rho_last), base), 1e-4), 0.9)
        return base

    def _rho_entry_refresh(self, s):
        """Refresh a persistently mediocre factor (rho_est above
        rho_refresh) at the current state when it has drifted; never at a
        non-finite state."""
        if self._ref is None or self.rho_est <= self.rho_refresh:
            return
        drift = float(self._drift(s, self._ref))
        if drift > self.stale_tol and self._inputs_finite(*s):
            self._ensure(s, force=True, why="rho-refresh")

    def _newton_direction(self, s, r, tol=None):
        tol = self._DIR_TOL if tol is None else tol
        d = s[-1]
        self._rho_entry_refresh(s)
        rho_entry = self.rho_est
        refactored = False
        for attempt in range(5):
            n_ir = self._n_for(tol, self.rho_est)
            delta, ratio, slope, rho_last_ = self._ir_dir(s, r, n_ir)
            self.last_ratio = float(ratio)
            rho_last = float(rho_last_)
            self._agree("direction certificate", self.last_ratio, rho_last)
            self.cert_log.append(("dir", n_ir, self.last_ratio))
            if not math.isfinite(self.last_ratio):
                if not self._inputs_finite(r, d):
                    # garbage in: return the non-finite direction (the line
                    # search rejects it), keep the factor and the estimate
                    self.rho_est = rho_entry
                    return delta, float("nan")
                if refactored:
                    return delta, float("nan")
            if self.last_ratio <= tol or (
                    attempt >= 1 and self.last_ratio <= 10.0 * tol):
                self.rho_est = max(self._rho_meas(n_ir, rho_last),
                                   self._RHO0)
                break
            self.rho_est = self._rho_meas(n_ir, rho_last)
            if not refactored and (self.rho_est > 0.5 or attempt >= 3
                                   or n_ir >= self._MAX_SWEEPS):
                self._ensure(s, force=True, why="dir-cert")
                refactored = True
        return delta, float(slope)

    def newton_direction(self, cp, h, d, r):
        """Certificate-validated IR-exact Newton direction for -r;
        returns (delta, slope). The certificate must reach the forcing
        tolerance _DIR_TOL; a retry within 10x of it is accepted (near
        miss)."""
        return self._newton_direction((cp, h, d), r)

    def ir_solve_async_dir(self, cp, h, d, b):
        """Adjoint-grade solve of K x = b through the direction solve
        (r = -b). Returns (x, ratio, n, rho_last); `finish_ir` books the
        certificate."""
        s = (cp, h, d)
        self._rho_entry_refresh(s)
        n = self._n_for(self._ADJOINT_TOL, self.rho_est)
        x, ratio, _, rho_last = self._ir_dir(s, -b, n)
        return x, ratio, n, rho_last

    def _solve_once(self, s, b, x0=None, tol=None):
        """One IR solve of K x = b sized from the measured contraction
        (seeded from x0 when given): (x, ratio, n, rho_last)."""
        tol = self._ADJOINT_TOL if tol is None else tol
        self._rho_entry_refresh(s)
        n = self._n_for(tol, self.rho_est, seeded=x0 is not None)
        x, ratio, rho_last = self._ir_solve(s, b, n, x0)
        return x, ratio, n, rho_last

    def finish_ir(self, n, ratio, rho_last=None, tol=None, tag="dir-pipe"):
        """Certificate bookkeeping for a solve of `_solve_once` /
        `ir_solve_async_dir` against `tol` (default the adjoint gate): True
        when it passed. A non-finite certificate is left to `exact_solve`
        to triage."""
        tol = self._ADJOINT_TOL if tol is None else tol
        self.last_ratio = float(ratio)
        self._agree(tag, self.last_ratio)
        self.cert_log.append((tag, n, self.last_ratio))
        if self.last_ratio <= tol:
            self.rho_est = max(self._rho_meas(n, rho_last), self._RHO0)
            return True
        if not math.isfinite(self.last_ratio):
            return False
        self.rho_est = self._rho_meas(n, rho_last)
        return False

    def _exact_solve(self, s, b, x0=None):
        tol = self._ADJOINT_TOL
        d = s[-1]
        self._rho_entry_refresh(s)
        if x0 is not None:
            n = self._n_for(tol, self.rho_est, seeded=True)
            x, ratio, rho_last = self._ir_solve(s, b, n, x0)
            r = float(ratio)
            self.cert_log.append(("exact-x0", n, r))
            if r <= tol:
                self.last_ratio = r
                self.rho_est = max(self._rho_meas(n, float(rho_last)),
                                   self._RHO0)
                return x
            # bad seed or stale factor: fall through unseeded
        rho_entry = self.rho_est
        refactored = False
        for attempt in range(5):
            n = self._n_for(tol, self.rho_est)
            x, ratio, rho_last_ = self._ir_solve(s, b, n)
            self.last_ratio = float(ratio)
            rho_last = float(rho_last_)
            self._agree("exact certificate", self.last_ratio, rho_last)
            self.cert_log.append(("exact", n, self.last_ratio))
            if not math.isfinite(self.last_ratio):
                if not self._inputs_finite(b, d):
                    self.rho_est = rho_entry
                    return x
                if refactored:
                    break
            if self.last_ratio <= tol:
                self.rho_est = max(self._rho_meas(n, rho_last), self._RHO0)
                return x
            self.rho_est = self._rho_meas(n, rho_last)
            if not refactored and (self.rho_est > 0.5 or attempt >= 3
                                   or n >= self._MAX_SWEEPS):
                self._ensure(s, force=True, why="exact-cert")
                refactored = True
        self.nonconverged = True
        warnings.warn(
            f"{type(self).__name__}.exact_solve: IR certificate did not "
            f"contract (last correction ratio {self.last_ratio:.3e} > tol "
            f"{tol:.1e}) even after a fresh factorization; the returned "
            "solve (and any gradient built on it) may be inaccurate.",
            RuntimeWarning, stacklevel=3)
        return x

    def exact_solve(self, cp, h, d, b, x0=None):
        """K(d) x = b by IR to the adjoint gate, self-validating: grow the
        sweep count from the measured contraction or refactor at the
        current state and redo. A seed x0 (the reference's seeded IR solve)
        is tried first with one sweep fewer; a bad seed only fails its
        certificate and the solve falls through unseeded. If the
        certificate still fails after a fresh factor, warn and set
        `nonconverged` rather than return silently."""
        return self._exact_solve((cp, h, d), b, x0)
