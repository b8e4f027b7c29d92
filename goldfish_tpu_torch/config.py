"""Dtype and device helpers.

The port works in float64 throughout: KL-shell tangents have condition
numbers of 1e10-1e12 even after equilibration, so no lower precision is
usable in the solves. The dtype is passed explicitly everywhere; nothing
here changes torch's global defaults.

Every entry point resolves its `device` argument through `as_device`: the
port runs on the current CUDA device unless the caller asks for another
one (`device="cpu"` for the plain PyTorch path the CPU tests use).
"""

from __future__ import annotations

import numpy as np
import torch

DTYPE = torch.float64      # states, residuals, tables, linear algebra
INDEX_DTYPE = torch.int32  # connectivity and dof maps


def as_device(device=None) -> torch.device:
    """Normalize a device argument. None means the current CUDA device; it
    raises when CUDA is absent (no silent CPU fallback)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "goldfish_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device=\"cpu\" to run the plain PyTorch "
            "path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def tensor(x, device=None, dtype=DTYPE) -> torch.Tensor:
    """Host array -> contiguous tensor on `device` with an exact copy of the
    values (the kernels index raw pointers; torch.tensor would keep a
    Fortran-ordered array's strides)."""
    return torch.tensor(np.asarray(x, order="C"), dtype=dtype,
                        device=as_device(device))
