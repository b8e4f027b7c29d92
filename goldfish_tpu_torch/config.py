"""Dtype and device helpers.

The port works in float64 throughout: KL-shell tangents have condition
numbers of 1e10-1e12 even after equilibration, so no lower precision is
usable in the solves. The dtype is passed explicitly everywhere; nothing
here changes torch's global defaults.
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float64      # states, residuals, tables, linear algebra
INDEX_DTYPE = torch.int32  # connectivity and dof maps


def as_device(device=None) -> torch.device:
    """Normalize a device argument (None means CPU; nothing moves to CUDA
    unless the caller asks for it)."""
    return torch.device("cpu") if device is None else torch.device(device)


def tensor(x, device=None, dtype=DTYPE) -> torch.Tensor:
    """Host array -> tensor on `device` with an exact copy of the values."""
    return torch.tensor(np.asarray(x), dtype=dtype, device=as_device(device))
