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
`system.residual_vjp` (K1/K2 mode c), with the JAX package's + sign. The
linear solves are the certificate-gated refinement on the persistent factor
(`implicit.adjoint_lambda`), with the identity on clamped dofs (the JAX
package's BC-reduced K).

dR/d(cp, h) applied forward has no kernel mode: on CPU tensors it is a
plain torch forward-over-reverse derivative of the potential; on the card
it raises (the reverse-mode totals of the OpenMDAO driver never call it).
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
from goldfish_tpu_torch.physics import coupling, kl_shell
from goldfish_tpu_torch.physics.loads import external_work
from goldfish_tpu_torch.solver.implicit import _Solver, adjoint_lambda
from goldfish_tpu_torch.solver.system import (
    jet_hessians,
    jet_tables,
    residual,
    residual_vjp,
    tangent_matvec_from,
)

__all__ = ["DispImOperation"]


def _potential_plain(data, d, cp, h):
    """Pi(d, cp, h) in plain torch (shell + penalty - dead/point/edge
    work): the CPU path of the design tangent."""
    if data.pressure is not None:
        raise NotImplementedError(
            "the forward design tangent with a follower pressure is not "
            "ported (ROADMAP Queue B, K1/K2 forward design-tangent mode)")
    st = data.stack
    Eq, nuq, wq = kl_shell._qp_params(st, data.E, data.nu)
    W = kl_shell.shell_density(kl_shell.jets(st, cp), kl_shell.jets(st, d),
                               kl_shell.h_at_qps(st, h), Eq, nuq, wq).sum()
    if data.ifs is not None:
        ifs = data.ifs
        X, z, hA, hB, Ei, ad, ar = coupling._qp_inputs(ifs, d, cp, h, data.E)
        W = W + coupling.penalty_density(X, z, hA, hB, ifs.dxiA, ifs.dxiB,
                                         Ei, ad, ar, ifs.w).sum()
    return W - external_work(st, d, cp, data.f_areal, data.point_loads, None,
                             data.edge_loads)


def _design_jvp_plain(data, d, cp, h, tcp, th):
    """free * (dR/dcp tcp + dR/dh th) on CPU tensors."""
    grad_d = torch.func.grad(_potential_plain, argnums=1)
    _, jv = torch.func.jvp(lambda c, hh: grad_d(data, d, c, hh), (cp, h),
                           (tcp, th))
    return jv * data.free


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
            if d.is_cuda:
                raise NotImplementedError(
                    "apply_linear_fwd in (cp, h) has no kernel mode (ROADMAP "
                    "Queue B: a forward design-tangent mode of K1/K2)")
            tcp = self._pad3(d_cp) if design[0] else torch.zeros_like(cp)
            th = (self.layout.to_padded(self._t(d_h)) if design[1]
                  else torch.zeros_like(h))
            with torch.enable_grad():
                out = out + _design_jvp_plain(self.data, d, cp, h, tcp, th)
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
