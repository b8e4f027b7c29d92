"""Objective / constraint functionals over the shell state.

Port of goldfish_tpu/physics/objectives.py (`internal_energy`, `volume`,
`compliance`, `max_vm_stress`): plain functions of (data, d, cp, h),
differentiable by torch autograd. The von Mises field comes from
`kl_shell.qp_stress_vm` (kernel K9 on CUDA tensors, its VJP in backward);
the two-level aggregation is plain torch on top of it, since it needs the
per-patch maximum before its exponential sums.
"""

from __future__ import annotations

import torch

from goldfish_tpu_torch.geometry.patch_stack import PatchStack
from goldfish_tpu_torch.physics import kl_shell
from goldfish_tpu_torch.physics.loads import external_work
from goldfish_tpu_torch.solver.system import SystemData

__all__ = ["internal_energy", "volume", "compliance", "max_vm_stress"]


def internal_energy(data: SystemData, d, cp, h):
    """W_int."""
    return kl_shell.internal_energy(data.stack, d, cp, h, data.E, data.nu)


def volume(data: SystemData, cp, h):
    """Material volume."""
    return kl_shell.volume(data.stack, cp, h)


def compliance(data: SystemData, d, cp, h):
    """External-load work at equilibrium."""
    return external_work(data.stack, d, cp, data.f_areal, data.point_loads,
                         data.pressure, data.edge_loads, data.f_field)


def _patch_areas(stack: PatchStack, cp):
    dA = kl_shell._ref_area(stack, cp)              # (P, E, Q)
    el_area = dA.sum(-1)                            # (P, E)
    n_el = (el_area > 0).sum(-1)                    # real elements per patch
    mean_el_area = el_area.sum(-1) / n_el.clamp_min(1)
    return dA, mean_el_area


def max_vm_stress(data: SystemData, d, cp, h, rho: float = 100.0,
                  method: str = "KS", through: str = "top"):
    """Smooth aggregated maximum von Mises stress, two-level: a continuous
    aggregation of the qp stress field over each patch, then a discrete one
    across patches. m_i / m are the current per-patch / global maxima and
    alpha the smallest mean element area over the real patches, held
    constant (detached) in the gradient, as the JAX package's
    stop_gradient does.

    method: 'KS' | 'pnorm' | 'induced power'."""
    stack = data.stack
    s = kl_shell.qp_stress_vm(stack, d, cp, h, data.E, data.nu,
                              through=through)  # (P, E, Q)
    dA, mean_el_area = _patch_areas(stack, cp)
    s_masked = torch.where(dA > 0, s.detach(), 0.0)
    m_list = s_masked.amax(dim=(1, 2)).clamp_min(1e-30)
    m_glob = m_list.max()
    alpha = torch.where(mean_el_area > 0, mean_el_area.detach(),
                        torch.inf).min()

    ml = m_list[:, None, None]
    if method == "KS":
        integ = (torch.exp(rho * (s - ml)) * dA).sum((1, 2))
        sub = m_list + (1.0 / rho) * torch.log(integ / alpha + 1e-300)
        glob = m_glob + (1.0 / rho) * torch.log(
            torch.exp(rho * (sub - m_glob)).sum() / alpha + 1e-300)
    elif method == "pnorm":
        integ = ((s / ml) ** rho * dA).sum((1, 2))
        sub = m_list * (integ / alpha) ** (1.0 / rho)
        glob = m_glob * (((sub / m_glob) ** rho).sum() / alpha) ** (1.0 / rho)
    elif method == "induced power":
        num = ((s / ml) ** (rho + 1.0) * dA).sum((1, 2))
        den = ((s / ml) ** rho * dA).sum((1, 2))
        sub = m_list * num / den.clamp_min(1e-300)
        gnum = ((sub / m_glob) ** (rho + 1.0)).sum()
        gden = ((sub / m_glob) ** rho).sum()
        glob = m_glob * gnum / gden.clamp_min(1e-300)
    else:
        raise ValueError(f"unsupported aggregation method {method!r}")
    return glob
