"""Explicit operations: objectives with their partials, adapter-ready.

Port of goldfish_tpu/operations/exops.py (`IntEnergyExOperation`,
`VolumeExOperation`, `ComplianceExOperation`, `MaxvMStressExOperation`,
`IntEnergyReguExOperation`, `VMStressExOperation`):
the explicit-operation protocol (`compute` + per-input `gradients`) over
flat real-dof numpy vectors (node-major xyz). Inside, the vectors become
padded tensors on the system's device; each gradient is one torch autograd
pass through the ported objective (the stress through kernel K9's VJP).
The stress field's operation calls K9's three modes directly: the value,
the VJP and, for its dense Jacobians, every qp's own row.
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.physics import kl_shell, objectives

__all__ = ["IntEnergyExOperation", "VolumeExOperation",
           "ComplianceExOperation", "MaxvMStressExOperation",
           "IntEnergyReguExOperation", "VMStressExOperation"]


class _FlatOp:
    """Flat numpy dof vectors <-> tensors on the system's device."""

    def __init__(self, system):
        self.system = system
        self.data = system.data
        self.device = system.device
        self.layout = CPLayout(system.metas, system.stack.max_cp,
                               system.device)

    def _tensor(self, a):
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            device=self.device)


class _ExOpBase(_FlatOp):
    """Scalar objectives: autograd partials. `fn(data, d, cp, h)` returns
    a 0-dim tensor."""

    def __init__(self, system, fn):
        super().__init__(system)
        self._fn = fn

    def _value(self, cp_f, h_f, d_f):
        lay = self.layout
        return self._fn(self.data, lay.to_padded(d_f.reshape(-1, 3)),
                        lay.to_padded(cp_f.reshape(-1, 3)),
                        lay.to_padded(h_f))

    def compute(self, cp, h, d):
        with torch.no_grad():
            return float(self._value(*(self._tensor(a) for a in (cp, h, d))))

    def gradients(self, cp, h, d):
        """(dJ/dcp, dJ/dh, dJ/dd) as flat numpy arrays."""
        args = tuple(self._tensor(a).requires_grad_(True)
                     for a in (cp, h, d))
        with torch.enable_grad():
            g = torch.autograd.grad(self._value(*args), args,
                                    allow_unused=True)
        return tuple(np.zeros(a.numel()) if gi is None
                     else gi.detach().cpu().numpy() for a, gi in zip(args, g))


class IntEnergyExOperation(_ExOpBase):
    def __init__(self, system):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.internal_energy(data, d, cp, h))


class VolumeExOperation(_ExOpBase):
    def __init__(self, system):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.volume(data, cp, h))


class ComplianceExOperation(_ExOpBase):
    def __init__(self, system):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.compliance(data, d, cp, h))


class MaxvMStressExOperation(_ExOpBase):
    def __init__(self, system, rho=100.0, method="KS", through="top"):
        super().__init__(system, lambda data, d, cp, h:
                         objectives.max_vm_stress(data, d, cp, h, rho=rho,
                                                  method=method,
                                                  through=through))


class IntEnergyReguExOperation(_ExOpBase):
    """W_int + the per-patch CP-smoothness regularization (the reference
    eVTOL driver's objective); the regularization's reference state is
    the system's initial control net."""

    def __init__(self, system, regu_para=1.0, field=2, h_regu=1e-3):
        cp_init = system.cp
        super().__init__(system, lambda data, d, cp, h:
                         objectives.internal_energy_regu(
                             data, d, cp, h, cp_init, regu_para,
                             field=field, h_regu=h_regu))


class VMStressExOperation(_FlatOp):
    """Per-quadrature-point von Mises stress FIELD (vector output) at the
    qps of positive weight, in flat (P, E, Q) order (void and padded qps
    are left out, as the reference does): compute() gives the values (K9
    mode 0), jacobians() the dense d(sigma)/d(cp, h, d) (K9 mode 2's rows
    scattered into the flat real-dof columns on the device, then one copy
    to the host; demo-scale sizes only) and vjp() the adjoint product (K9
    mode 1)."""

    def __init__(self, system, through: str = "top"):
        super().__init__(system)
        self.zeta = kl_shell.ZETA[through]
        stack = system.stack
        wq = stack.wq.reshape(-1).cpu().numpy()
        self._keep = torch.tensor(np.nonzero(wq > 0)[0], device=self.device)
        self.out_size = int(self._keep.numel())
        # flat real-CP index of every (kept qp, local node); padding CPs
        # map to n_flat, a column dropped at the end
        P, C = stack.cp_mask.shape
        node = (stack.conn.long() + C * torch.arange(
            P, device=self.device)[:, None, None])          # (P, E, L)
        Q = stack.wq.shape[2]
        node = node[:, :, None, :].expand(-1, -1, Q, -1).reshape(
            P * stack.wq.shape[1] * Q, -1)[self._keep]      # (S, L)
        self._col = self.layout._idx.reshape(-1)[node]

    def _padded(self, cp, h, d):
        lay = self.layout
        return (lay.to_padded(self._tensor(d).reshape(-1, 3)),
                lay.to_padded(self._tensor(cp).reshape(-1, 3)),
                lay.to_padded(self._tensor(h)))

    def compute(self, cp, h, d):
        s = kl_shell.vm_stress_value(self.data.stack, *self._padded(cp, h, d),
                                     self.data.E, self.data.nu, self.zeta)
        return s.reshape(-1)[self._keep].cpu().numpy()

    def jacobians(self, cp, h, d):
        """(dS/dcp, dS/dh, dS/dd) dense (S, 3 n), (S, n), (S, 3 n)."""
        stack = self.data.stack
        rows = kl_shell.vm_stress_rows(stack, *self._padded(cp, h, d),
                                       self.data.E, self.data.nu, self.zeta)
        L = rows.shape[3]
        rows = rows.reshape(-1, L, 7)[self._keep]           # (S, L, 7)
        S, n = self.out_size, self.layout.n_flat
        col = self._col

        def dense(r):  # (S, L, k) -> (S, (n + 1) k) -> (S, n k)
            k = r.shape[-1]
            out = r.new_zeros(S, n + 1, k)
            out.scatter_add_(1, col[..., None].expand(-1, -1, k), r)
            return out[:, :n].reshape(S, n * k)

        J = torch.cat([dense(rows[..., 3:6]), dense(rows[..., 6:7]),
                       dense(rows[..., 0:3])], dim=1).cpu().numpy()
        return J[:, :3 * n], J[:, 3 * n:4 * n], J[:, 4 * n:]

    def vjp(self, cp, h, d, ct):
        """ct (S,) -> (ct . dS/dcp, ct . dS/dh, ct . dS/dd) flat."""
        stack = self.data.stack
        gbar = torch.zeros(stack.wq.numel(), dtype=torch.float64,
                           device=self.device)
        gbar[self._keep] = self._tensor(ct)
        dd, dcp, dh = kl_shell.vm_stress_vjp(
            stack, *self._padded(cp, h, d), self.data.E, self.data.nu,
            self.zeta, gbar.reshape(stack.wq.shape))
        lay = self.layout
        return tuple(lay.to_flat(g).reshape(-1).cpu().numpy()
                     for g in (dcp, dh, dd))
