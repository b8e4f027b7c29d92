"""Implicit displacement operation: the framework-agnostic adapter surface.

Port of goldfish_tpu/operations/disp_imop.py (`DispImOperation`, the
6-method protocol the OpenMDAO / CSDL components drive):

    apply_nonlinear   R(d; cp, h), BC-masked
    solve_nonlinear   R = 0 by `newton_solve_host` on one persistent factor
                      (the port's `implicit._Solver`), secant warm start
    linearize         keep the state (cp, h, d)
    apply_linear_fwd  dR = dR/dcp dcp + dR/dh dh + dR/dd dd
    apply_linear_rev  (dR/dcp, dR/dh, dR/dd)^T d_r
    solve_linear_*    K x = rhs (K symmetric: fwd == rev)

Vectors at the boundary are flat real-dof numpy arrays (node-major xyz,
clamped dofs included), as in the JAX package; inside they are padded
tensors on the system's device. dR/dd products are kernel K4 on the jet
Hessians (K1/K2 mode b) at the linearized state, unmasked on the input side
as the JAX package's jvp of the masked residual is; (dR/d(cp, h))^T is
`system.residual_vjp` (K1/K2 mode c), with the JAX package's + sign, and
dR/d(cp, h) applied forward `system.residual_jvp` (K1/K2's design-tangent
modes, K8 mode c, K12 mode 3 for contact; the plain versions on CPU
tensors). The linear solves are the certificate-gated refinement on the
persistent factor (`implicit.adjoint_lambda`), with the identity on clamped
dofs (the JAX package's BC-reduced K), to the certificate `LINEAR_TOL`:
forward-mode totals solve K against dR/d(cp, h) tangents, whose answers lie
in the soft modes, and the adjoint gate of 1e-6 left them ~4e-7 from the
reverse totals (the MI T-beam's CSDL graph); at 1e-10 the two agree to
~5e-10.
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
from goldfish_tpu_torch.solver.implicit import _Solver, adjoint_lambda
from goldfish_tpu_torch.solver.system import (
    jet_hessians,
    jet_tables,
    residual,
    residual_jvp,
    residual_vjp,
    tangent_matvec_from,
)

__all__ = ["DispImOperation", "LINEAR_TOL"]

# IR certificate (last correction over the solution) of the operations'
# solve_linear_* (the Newton directions keep their own forcing tolerance)
LINEAR_TOL = 1e-10


class DispImOperation:
    """Implicit operation R(d; cp, h) = 0 over flat real-dof vectors."""

    def __init__(self, system, rtol=1e-10, max_it=30, warm_start=True):
        self.system = system
        self.data = system.data
        self.device = system.device
        self.layout = CPLayout(system.metas, system.stack.max_cp,
                               system.device)
        self.vec_size = self.layout.n_flat * 3
        self.h_size = self.layout.n_flat
        self.solver = _Solver(self.data, rtol, 1e-14, max_it)
        self.factor = self.solver.factor
        self.factor._ADJOINT_TOL = LINEAR_TOL
        # secant extrapolation of successive converged states across
        # optimizer iterations (opt/warmstart.py)
        self._ws = SecantWarmStart() if warm_start else None
        # the jet tables with every dof free: dR/dd is H v with v unmasked
        tables = jet_tables(self.data)
        self._tables = tables._replace(free=torch.ones_like(tables.free))
        self._state = None
        self._Hs = None

    # ------------------------------------------------------- conversions
    def _t(self, a):
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            device=self.device)

    def _pad3(self, a):
        return self.layout.to_padded(self._t(a).reshape(-1, 3))

    def _flat(self, x):
        return self.layout.to_flat(x).reshape(-1).cpu().numpy()

    def _H_v(self, v):
        """H(d) v at the linearized state, unmasked (P, C, 3)."""
        if self._Hs is None:
            cp, h, d = self._state
            self._Hs = jet_hessians(self.data, d, cp, h)
        return tangent_matvec_from(self._tables, self._Hs, v)

    # ------------------------------------------------------- protocol
    @torch.no_grad()
    def apply_nonlinear(self, cp, h, d):
        return self._flat(residual(self.data, self._pad3(d), self._pad3(cp),
                                   self.layout.to_padded(self._t(h))))

    @torch.no_grad()
    def solve_nonlinear(self, cp, h, d0=None):
        cp_t, h_t = self._t(cp), self._t(h)
        d0_t = (torch.zeros(self.vec_size, dtype=cp_t.dtype,
                            device=self.device) if d0 is None
                else self._t(d0))
        x = torch.cat([cp_t.reshape(-1), h_t.reshape(-1)])
        if self._ws is not None:
            d0_t = self._ws.predict(x, d0_t)
        lay = self.layout
        d = self.solver.solve(lay.to_padded(cp_t.reshape(-1, 3)),
                              lay.to_padded(h_t),
                              lay.to_padded(d0_t.reshape(-1, 3)))
        d_f = lay.to_flat(d).reshape(-1)
        if self._ws is not None:
            self._ws.update(x, d_f)
        return d_f.cpu().numpy()

    def linearize(self, cp, h, d):
        self._state = (self._pad3(cp), self.layout.to_padded(self._t(h)),
                       self._pad3(d))
        self._Hs = None

    @torch.no_grad()
    def apply_linear_fwd(self, d_cp=None, d_h=None, d_d=None):
        """dR = dR/dcp dcp + dR/dh dh + dR/dd dd."""
        cp, h, d = self._state
        free = self.data.free
        out = torch.zeros_like(d)
        if d_d is not None:
            out = out + self._H_v(self._pad3(d_d)) * free
        design = [a is not None and np.any(np.asarray(a) != 0.0)
                  for a in (d_cp, d_h)]
        if any(design):
            tcp = self._pad3(d_cp) if design[0] else torch.zeros_like(cp)
            th = (self.layout.to_padded(self._t(d_h)) if design[1]
                  else torch.zeros_like(h))
            out = out + residual_jvp(self.data, d, cp, h, tcp, th)
        return self._flat(out)

    @torch.no_grad()
    def apply_linear_rev(self, d_r):
        """(cp_bar, h_bar, d_bar) = (dR/d.)^T d_r."""
        cp, h, d = self._state
        lam = self._pad3(d_r)
        dcp, dh = residual_vjp(self.data, d, cp, h, lam)  # -lam^T dR/d.
        d_bar = self._H_v(lam * self.data.free)
        return self._flat(-dcp), self._flat(-dh), self._flat(d_bar)

    @torch.no_grad()
    def solve_linear_fwd(self, rhs):
        """K dd = rhs (the Newton/tangent solve; identity on clamped
        dofs)."""
        cp, h, d = self._state
        b = self._pad3(rhs)
        free = self.data.free
        x = adjoint_lambda(self.data, self.factor, d, cp, h, b)
        return self._flat(x + b * (1.0 - free))

    def solve_linear_rev(self, rhs):
        """K^T lam = rhs; K symmetric (potential Hessian) -> same solve."""
        return self.solve_linear_fwd(rhs)
