"""Moving-intersection implicit operations: the adapter surface.

Port of goldfish_tpu/operations/disp_mi_imop.py: the CP -> xi operation
(`CPIGA2XiImOperation`) and the displacement operation with the xi input
(`DispMintImOperation`), each the 6-method protocol the OpenMDAO
components drive. Vectors at the boundary are flat numpy (cp node-major
xyz, h one per CP, xi in the (I, N, 2, 2) order of `CPIGA2Xi.xi0_flat`,
padded points included); inside they are tensors on the system's device.

`CPIGA2XiImOperation` (R(xi; cp) = 0, kernel K7):

    solve_nonlinear   the batched xi Newton (`c2x_newton`: K7 mode 2, the
                      fused step), secant warm start over cp clamped to
                      [0, 1]
    apply_nonlinear   R from K7 mode 0 (residual only)
    vjp               dxi/dcp^T xi_bar (`c2x_adjoint`: K7 mode 3)
    linearize         R and J = dR/dxi once (K7 mode 0), J kept
    apply_linear_*    dR/dxi from the kept J; dR/dcp dcp by K7 mode 4,
                      (dR/dcp)^T d_r by K7 mode 1
    solve_linear_*    J or J^T by batched f64 `torch.linalg.solve`

`DispMintImOperation` (R(d; cp, h, xi) = 0, the MI residual at xi):

    solve_nonlinear   `newton_solve_mi_host` on one persistent MI factor
                      with the Woodbury seam correction (`_SolverMI`),
                      secant warm start over (cp, h, xi)
    apply_linear_fwd  dR/d(cp, h) (dcp, dh) by K1/K2's design-tangent
                      modes on K5's rows, dR/dxi dxi by K6 mode 1
                      (`residual_jvp_mi`), dR/dd dd by K4
    apply_linear_rev  (dR/d(cp, h, xi))^T d_r by K1/K2 mode c on K5's rows
                      and K6 (`_res_vjp_mi`), with the JAX package's + sign;
                      (dR/dd)^T d_r by K4 on the MI jet Hessians at the
                      linearized state, unmasked on the input side
    solve_linear_*    certificate-gated IR on the persistent factor
                      (`adjoint_lambda_mi`, to `disp_imop.LINEAR_TOL`), the
                      identity on clamped dofs (the JAX package's
                      BC-reduced K)

On CPU tensors every product runs the kernels' plain versions.
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.operations.disp_imop import LINEAR_TOL
from goldfish_tpu_torch.geometry.cpiga2xi import (
    c2x_adjoint,
    c2x_res_jac,
    c2x_res_jvp,
    c2x_res_vjp,
)
from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
from goldfish_tpu_torch.solver.system import jet_hessians, tangent_matvec_from
from goldfish_tpu_torch.solver.system_mi import (
    _res_vjp_mi,
    _SolverMI,
    adjoint_lambda_mi,
    adjoint_solve_mi,
    residual_jvp_mi,
    residual_mi,
)

__all__ = ["CPIGA2XiImOperation", "DispMintImOperation"]


def _nonzero(a):
    return a is not None and bool(np.any(np.asarray(a) != 0.0))


class _Flat:
    """Flat numpy <-> tensors on the system's device. With a `key`, the
    last tensor made for that key is handed out again while the numbers
    are the same, so that the factor's caches keyed on tensor identity
    (the seam correction, the rows at xi) hit across the protocol calls of
    one state."""

    def __init__(self, system):
        self.device = system.device
        self.layout = CPLayout(system.metas, system.stack.max_cp,
                               system.device)
        self._last = {}

    def _make(self, a, key, shape):
        a = np.asarray(a, dtype=np.float64)
        hit = self._last.get(key)
        if hit is not None and np.array_equal(hit[0], a):
            return hit[1]
        out = torch.tensor(a, device=self.device)
        if shape is not None:
            out = self.layout.to_padded(out.reshape(shape))
        if key is not None:
            self._last[key] = (a.copy(), out)
        return out

    def t(self, a, key=None):
        return self._make(a, key, None)

    def cp(self, a, key=None):
        """Flat xyz -> padded (P, C, 3)."""
        return self._make(a, key, (-1, 3))

    def h(self, a, key=None):
        """Flat per-CP values -> padded (P, C)."""
        return self._make(a, key, (-1,))

    def flat(self, x):
        return self.layout.to_flat(x).reshape(-1).cpu().numpy()


class CPIGA2XiImOperation:
    """Implicit CP -> xi solve with the linearize / solve_linear protocol
    over flat vectors."""

    def __init__(self, mi_system, warm_start=True):
        self.sys = mi_system
        self.c2x = mi_system.c2x
        self._io = _Flat(mi_system)
        self.layout = self._io.layout
        self.xi_shape = tuple(self.c2x.xi0_flat.shape)
        self.xi_size = int(np.prod(self.xi_shape))
        # secant-extrapolated xi warm starts: a warm xi0 cuts the xi Newton
        # to one or two fused steps
        self._ws = SecantWarmStart() if warm_start else None
        self._state = None
        self._J = None

    def _args(self):
        c = self.c2x
        return c.ss, c.p, c.q, c.mi

    def _xi(self, a):
        return self._io.t(a).reshape(self.xi_shape)

    # ------------------------------------------------------- protocol
    @torch.no_grad()
    def solve_nonlinear(self, cp_flat):
        x = self._io.t(cp_flat)
        cp = self.layout.to_padded(x.reshape(-1, 3))
        xi0 = None
        if self._ws is not None:
            xi0 = self._ws.predict(x, None)
            if xi0 is not None:
                # an overshooting secant seed outside the parametric domain
                # can settle Newton on a spurious root or stall it across a
                # knot line: clamp
                xi0 = xi0.clamp(0.0, 1.0)
        xi = self.c2x.solve(cp, xi0)
        if self._ws is not None:
            self._ws.update(x, xi)
        return xi.reshape(-1).cpu().numpy()

    @torch.no_grad()
    def apply_nonlinear(self, cp_flat, xi_flat):
        r, _ = c2x_res_jac(*self._args(), self._io.cp(cp_flat),
                           self._xi(xi_flat), jac=False)
        return r.reshape(-1).cpu().numpy()

    @torch.no_grad()
    def vjp(self, cp_flat, xi_flat, xi_bar):
        """d(xi)/d(cp)^T xi_bar by the implicit-function adjoint."""
        dcp = c2x_adjoint(*self._args(), self._io.cp(cp_flat),
                          self._xi(xi_flat), self._xi(xi_bar).contiguous())
        return self._io.flat(dcp)

    @torch.no_grad()
    def linearize(self, cp_flat, xi_flat):
        cp, x = self._io.cp(cp_flat), self._xi(xi_flat)
        self._state = (cp, x)
        self._J = c2x_res_jac(*self._args(), cp, x)[1]

    @torch.no_grad()
    def apply_linear_fwd(self, d_cp=None, d_xi=None):
        """dR = dR/dcp dcp + dR/dxi dxi."""
        cp, x = self._state
        out = torch.zeros_like(x)
        if d_xi is not None:
            out = out + (self._J @ self._xi(d_xi)[..., None])[..., 0]
        if _nonzero(d_cp):
            out = out + c2x_res_jvp(*self._args(), cp, x, self._io.cp(d_cp))
        return out.reshape(-1).cpu().numpy()

    @torch.no_grad()
    def apply_linear_rev(self, d_r):
        """(cp_bar, xi_bar) = (dR/d.)^T d_r."""
        cp, x = self._state
        lam = self._xi(d_r).contiguous()
        dcp = c2x_res_vjp(*self._args(), cp, x, lam)   # -lam^T dR/dcp
        dxi = (self._J.transpose(-1, -2) @ lam[..., None])[..., 0]
        return self._io.flat(-dcp), dxi.reshape(-1).cpu().numpy()

    @torch.no_grad()
    def solve_linear_fwd(self, rhs):
        r = self._xi(rhs)
        return torch.linalg.solve(self._J, r[..., None])[..., 0] \
            .reshape(-1).cpu().numpy()

    @torch.no_grad()
    def solve_linear_rev(self, rhs):
        r = self._xi(rhs)
        return torch.linalg.solve(self._J.transpose(-1, -2), r[..., None]) \
            [..., 0].reshape(-1).cpu().numpy()


class DispMintImOperation:
    """Implicit displacement R(d; cp, h, xi) = 0 over flat vectors."""

    def __init__(self, mi_system, rtol=1e-10, max_it=30, warm_start=True):
        self.sys = mi_system
        self.data = mi_system.data
        self._io = _Flat(mi_system)
        self.layout = self._io.layout
        self.device = mi_system.device
        self.rtol = rtol
        self.max_it = max_it
        self.vec_size = self.layout.n_flat * 3
        self.h_size = self.layout.n_flat
        self.xi_shape = tuple(mi_system.c2x.xi0_flat.shape)
        self.solver = _SolverMI(*mi_system.mi_args, rtol, 1e-14, max_it)
        self.factor = self.solver.factor
        self.factor._ADJOINT_TOL = LINEAR_TOL
        self._ws = SecantWarmStart() if warm_start else None
        self._state = None
        self._Hs = None

    # ------------------------------------------------------- conversions
    def _inputs(self, cp, h, xi):
        io = self._io
        return (io.cp(cp, "cp"), io.h(h, "h"),
                io.t(xi, "xi").reshape(self.xi_shape))

    def _H_v(self, v):
        """dR/dd v unmasked on the input side, at the linearized state
        (K4 on the MI jet Hessians)."""
        cp, h, xi, d = self._state
        dx, tab = self.factor._at(xi)
        if self._Hs is None:
            self._Hs = jet_hessians(dx, d, cp, h)
        return tangent_matvec_from(
            tab._replace(free=torch.ones_like(tab.free)), self._Hs, v)

    # ------------------------------------------------------- protocol
    @torch.no_grad()
    def solve_nonlinear(self, cp, h, xi, d0=None):
        cp_t, h_t, xi_t = self._inputs(cp, h, xi)
        io = self._io
        d0_t = (torch.zeros(self.vec_size, dtype=cp_t.dtype,
                            device=self.device) if d0 is None
                else io.t(d0))
        if self._ws is not None:
            x = torch.cat([io.t(cp), io.t(h), xi_t.reshape(-1)])
            d0_t = self._ws.predict(x, d0_t)
        d = self.solver.solve(cp_t, h_t, xi_t,
                              self.layout.to_padded(d0_t.reshape(-1, 3)))
        d_f = self.layout.to_flat(d).reshape(-1)
        if self._ws is not None:
            self._ws.update(x, d_f)
        return d_f.cpu().numpy()

    @torch.no_grad()
    def apply_nonlinear(self, cp, h, xi, d):
        cp_t, h_t, xi_t = self._inputs(cp, h, xi)
        return self._io.flat(residual_mi(*self.sys.mi_args, self._io.cp(d),
                                         cp_t, h_t, xi_t))

    def linearize(self, cp, h, xi, d):
        self._state = (*self._inputs(cp, h, xi), self._io.cp(d, "d"))
        self._Hs = None

    @torch.no_grad()
    def apply_linear_fwd(self, d_cp=None, d_h=None, d_xi=None, d_d=None):
        """dR = dR/dcp dcp + dR/dh dh + dR/dxi dxi + dR/dd dd."""
        cp, h, xi, d = self._state
        io = self._io
        free = self.data.free
        out = torch.zeros_like(d)
        if d_d is not None:
            out = out + self._H_v(io.cp(d_d)) * free
        tcp = io.cp(d_cp) if _nonzero(d_cp) else None
        th = io.h(d_h) if _nonzero(d_h) else None
        txi = io.t(d_xi).reshape(self.xi_shape) if _nonzero(d_xi) else None
        if tcp is not None or th is not None or txi is not None:
            out = out + residual_jvp_mi(*self.sys.mi_args, d, cp, h, xi, tcp,
                                        th, txi)
        return io.flat(out)

    @torch.no_grad()
    def apply_linear_rev(self, d_r):
        """(cp_bar, h_bar, xi_bar, d_bar) = (dR/d.)^T d_r."""
        cp, h, xi, d = self._state
        lam = self._io.cp(d_r)
        dcp, dh, dxi = _res_vjp_mi(*self.sys.mi_args, d, cp, h, xi,
                                   lam)     # -lam^T dR/d.
        d_bar = self._H_v(lam * self.data.free)
        return (self._io.flat(-dcp), self._io.flat(-dh),
                (-dxi).reshape(-1).cpu().numpy(), self._io.flat(d_bar))

    @torch.no_grad()
    def solve_linear_fwd(self, rhs):
        """K dd = rhs (identity on clamped dofs)."""
        cp, h, xi, d = self._state
        b = self._io.cp(rhs)
        x = adjoint_lambda_mi(*self.sys.mi_args, d, cp, h, xi, b,
                              device_fac=self.factor)
        return self._io.flat(x + b * (1.0 - self.data.free))

    def solve_linear_rev(self, rhs):
        """K^T lam = rhs; K symmetric (potential Hessian): the same solve."""
        return self.solve_linear_fwd(rhs)

    @torch.no_grad()
    def solve_linear_rev_and_accumulate(self, dJ_dd_flat):
        """One-call reverse mode: lam = K^-T g, then (cp_bar, h_bar,
        xi_bar) = -(dR/d.)^T lam (`adjoint_solve_mi`), the composition the
        OpenMDAO adapter performs by solve_linear + apply_linear."""
        cp, h, xi, d = self._state
        dcp, dh, dxi = adjoint_solve_mi(
            *self.sys.mi_args, d, cp, h, xi, self._io.cp(dJ_dd_flat),
            device_fac=self.factor, lam_ws=self.solver.lam_ws)
        return (self._io.flat(dcp), self._io.flat(dh),
                dxi.reshape(-1).cpu().numpy())
