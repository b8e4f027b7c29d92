"""External loads (port of goldfish_tpu/physics/loads.py, dead load only).

The dead areal load is linear in d, so its work is one elementwise product
and one reduction (plain PyTorch, no kernel) and its d-gradient is a
constant force vector. Point, edge, follower-pressure and field loads
are not ported yet (ROADMAP Queue A7) and raise.
"""

from __future__ import annotations

import torch

from goldfish_tpu_torch.geometry.patch_stack import PatchStack
from goldfish_tpu_torch.physics.kl_shell import (
    dead_load_force,
    external_work_dead_load,
)

__all__ = ["external_work", "external_force"]


def _only_dead_load(point_loads, pressure, edge_loads, f_field):
    for name, v in (("point_loads", point_loads), ("pressure", pressure),
                    ("edge_loads", edge_loads), ("f_field", f_field)):
        if v is not None:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP Queue A7)")


def external_work(stack: PatchStack, d, cp, f_areal=None, point_loads=None,
                  pressure=None, edge_loads=None, f_field=None):
    """W_ext (0-dim tensor)."""
    _only_dead_load(point_loads, pressure, edge_loads, f_field)
    if f_areal is None:
        return torch.zeros((), dtype=d.dtype, device=d.device)
    return external_work_dead_load(stack, d, cp, f_areal)


def external_force(stack: PatchStack, cp, f_areal=None):
    """dW_ext/dd (P, C, 3), constant in d."""
    if f_areal is None:
        return torch.zeros_like(cp)
    return dead_load_force(stack, cp, f_areal)
