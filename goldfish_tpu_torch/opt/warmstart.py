"""Secant warm-start extrapolation across optimizer iterations.

Port of goldfish_tpu/opt/warmstart.py. Extrapolating the converged state
along the last design step,

    d0 = d_prev + a * (d_prev - d_prev2),
    a  = <dx_new, dx_prev> / |dx_prev|^2   (clipped to [-2, 2]),

makes a warm solve's entry residual second-order in the step. A wrong
prediction costs at most an extra Newton iteration; the line search
guards descent.
"""

from __future__ import annotations

import torch

__all__ = ["SecantWarmStart"]


def _alpha(dx_new, dx_old):
    num = torch.dot(dx_old, dx_new)
    den = torch.dot(dx_old, dx_old) + 1e-300
    a = torch.clamp(num / den, -2.0, 2.0)
    # non-finite step metrics must yield a = 0, not poison the prediction
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))


def _extrapolate(d, d2, a):
    out = d + a * (d - d2)
    # a seed is only a seed: fall back to the last converged state (or 0)
    # elementwise where the extrapolation is non-finite
    safe_d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
    return torch.where(torch.isfinite(out), out, safe_d)


class SecantWarmStart:
    """Track (design, state) pairs; predict the next warm start."""

    def __init__(self):
        self._x = None
        self._d = None
        self._x2 = None
        self._d2 = None

    def predict(self, x, default):
        """Warm start for design point `x`; `default` when history is
        insufficient (cold start / first iteration)."""
        if self._x is None:
            return default
        if self._x2 is None:
            return self._d
        a = _alpha(x.detach().reshape(-1) - self._x.reshape(-1),
                   self._x.reshape(-1) - self._x2.reshape(-1))
        return _extrapolate(self._d, self._d2, a)

    def update(self, x, d):
        """Record the converged state at design point `x`."""
        self._x2, self._d2 = self._x, self._d
        self._x, self._d = x.detach(), d.detach()
