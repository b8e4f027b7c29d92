"""Shared inputs for the PyTorch-port parity tests (test_torch_*.py).

The small wing: `wing.build(n_chord=2, n_span=2, num_el=3, p=3)`, 4
patches, 20 (padded) elements each, N = 672 dofs. Both packages build it
from the same host code; `from_numpy_tree` hands the JAX package's arrays
to the port bit for bit. Seeded states come from numpy, so both packages
see identical inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WING_SMALL = dict(n_chord=2, n_span=2, num_el=3, p=3)
FFD_SMALL = dict(num_els=(2, 2, 1), p=(2, 2, 1))


@functools.lru_cache(maxsize=1)
def jax_wing():
    from goldfish_tpu.models import wing

    return wing.build(**WING_SMALL)


@functools.lru_cache(maxsize=1)
def port_data():
    from goldfish_tpu_torch.bridge import from_numpy_tree

    return from_numpy_tree(jax_wing().data)


def seeded_state(seed=0, system=None):
    """(cp, h, d, lam, v) as numpy: d ~ 1e-3 |cp| on free dofs, lam and v
    standard normal. `system` defaults to the JAX package's small wing;
    the port's own (CPU) small wing gives the same arrays without JAX."""
    s = jax_wing() if system is None else system
    cp = np.asarray(s.cp)
    h = np.asarray(s.h_init)
    free = np.asarray(s.data.free)
    rng = np.random.default_rng(seed)
    scale = np.linalg.norm(cp) / np.sqrt(cp.size)
    d = 1e-3 * scale * rng.normal(size=cp.shape) * free
    lam = rng.normal(size=cp.shape)
    v = rng.normal(size=cp.shape)
    return cp, h, d, lam, v


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def rel(a, b):
    """Relative error in norm of a against the reference b."""
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))
