"""Turn the JAX package's problem pytrees into the port's tensors.

`from_numpy_tree` maps `PatchStack`, `InterfaceStack`, `PointLoads`,
`EdgeLoads`, `ContactPairs` and `SystemData` (any NamedTuple with one of
those names; the follower `pressure` is a plain array leaf) field by field
onto
the port's classes of the same name; every array leaf goes through
`np.asarray`, so the values arrive bit for bit and nothing of the JAX
package is imported here. Tests use it to hand both packages identical
data.
"""

from __future__ import annotations

import numpy as np
import torch

from goldfish_tpu_torch.config import as_device
from goldfish_tpu_torch.geometry.patch_stack import PatchStack
from goldfish_tpu_torch.physics.contact import ContactPairs
from goldfish_tpu_torch.physics.coupling import InterfaceStack
from goldfish_tpu_torch.physics.loads import EdgeLoads, PointLoads
from goldfish_tpu_torch.solver.system import SystemData

__all__ = ["from_numpy_tree"]

_PORT_TYPES = {cls.__name__: cls
               for cls in (PatchStack, InterfaceStack, PointLoads, EdgeLoads,
                           ContactPairs, SystemData)}


def _leaf(x, device):
    a = np.asarray(x)
    if a.dtype.kind == "f":
        a = a.astype(np.float64, copy=False)
    elif a.dtype.kind in "iu":
        a = a.astype(np.int32, copy=False)
    return torch.from_numpy(np.array(a, order="C")).to(device)


def from_numpy_tree(tree, device=None):
    """Convert a (nested) PatchStack / InterfaceStack / ContactPairs /
    SystemData or a single array into tensors on `device`."""
    device = as_device(device)
    if tree is None:
        return None
    fields = getattr(type(tree), "_fields", None)
    if fields is not None:
        cls = _PORT_TYPES.get(type(tree).__name__)
        if cls is None:
            raise NotImplementedError(
                f"{type(tree).__name__} has no counterpart in the port yet")
        return cls(**{f: from_numpy_tree(getattr(tree, f), device)
                      for f in fields if f in cls._fields})
    return _leaf(tree, device)
