"""Template for user-defined explicit operations.

Port of goldfish_tpu/operations/custom_exop.py. A custom operation is a
differentiable function of (data, d, cp, h) on the padded device tensors;
the base class wires the flat-vector adapter surface and every partial by
torch autograd: nothing to derive by hand.

Example::

    from goldfish_tpu_torch.operations.custom_exop import CustomExOperation

    def tip_deflection(data, d, cp, h):
        # any torch expression of the padded state/design tensors
        return d[0, -1, 2]

    op = CustomExOperation(system, tip_deflection)
    val = op.compute(cp_flat, h_flat, d_flat)
    d_cp, d_h, d_d = op.gradients(cp_flat, h_flat, d_flat)
"""

from __future__ import annotations

from goldfish_tpu_torch.operations.exops import _ExOpBase

__all__ = ["CustomExOperation"]


class CustomExOperation(_ExOpBase):
    """CustomExOperation(system, fn): fn(data, d, cp, h) -> scalar;
    partials come from autograd."""
