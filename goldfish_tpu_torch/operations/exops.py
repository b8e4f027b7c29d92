"""Explicit operations: objectives with their partials, adapter-ready.

Port of goldfish_tpu/operations/exops.py (`IntEnergyExOperation`,
`VolumeExOperation`, `ComplianceExOperation`, `MaxvMStressExOperation`):
the explicit-operation protocol (`compute` + per-input `gradients`) over
flat real-dof numpy vectors (node-major xyz). Inside, the vectors become
padded tensors on the system's device; each gradient is one torch autograd
pass through the ported objective (the stress through kernel K9's VJP).
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.design.pipeline import CPLayout
from goldfish_tpu_torch.physics import objectives

__all__ = ["IntEnergyExOperation", "VolumeExOperation",
           "ComplianceExOperation", "MaxvMStressExOperation"]


class _ExOpBase:
    """Shared machinery: flat numpy <-> padded tensors, autograd partials.
    `fn(data, d, cp, h)` returns a 0-dim tensor."""

    def __init__(self, system, fn):
        self.system = system
        self.data = system.data
        self.device = system.device
        self.layout = CPLayout(system.metas, system.stack.max_cp,
                               system.device)
        self._fn = fn

    def _tensor(self, a):
        return torch.tensor(np.asarray(a, dtype=np.float64),
                            device=self.device)

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
