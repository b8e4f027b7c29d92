"""Objective / constraint functionals over the shell state.

Port of goldfish_tpu/physics/objectives.py (`internal_energy`, `volume`,
`compliance`, `cp_regu_energy`, `internal_energy_regu`, `max_vm_stress`):
plain functions of (data, d, cp, h), differentiable by torch autograd.
The CP-smoothness regularization is an exact quadratic in cp on the
initial geometry, so plain torch computes it. The von Mises field comes from
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

__all__ = ["internal_energy", "volume", "compliance", "cp_regu_energy",
           "internal_energy_regu", "max_vm_stress"]


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


def cp_regu_energy(data: SystemData, cp, cp_init, regu_para,
                   field: int = 2, h_regu: float = 1e-3):
    """Per-patch CP-smoothness regularization energies (P,):

        r_s = kappa_s * int_s |grad(cp_f - cp_f,init)|^2 dA,
        kappa_s = regu_para * E_s * h_regu^3 / (12 h_a,s (1 - nu_s^2))

    the reference eVTOL driver's regularization term: a bending-stiffness
    scaled penalty on the surface gradient of the optimized CP field's
    deviation from the initial design, h_a,s the patch's mean element size.
    The gradient and dA are taken on the initial geometry, so the term is
    an exact quadratic in cp."""
    stack = data.stack
    f = (cp - cp_init)[..., field] * stack.cp_mask            # (P, C)
    fe = kl_shell.gather(f[..., None], stack.conn)[..., 0]    # (P, E, L)
    fu = torch.einsum("peql,pel->peq", stack.R10, fe)
    fv = torch.einsum("peql,pel->peq", stack.R01, fe)
    ce = kl_shell.gather(cp_init, stack.conn)
    A1 = torch.einsum("peql,pelk->peqk", stack.R10, ce)
    A2 = torch.einsum("peql,pelk->peqk", stack.R01, ce)
    a11 = (A1 * A1).sum(-1)
    a12 = (A1 * A2).sum(-1)
    a22 = (A2 * A2).sum(-1)
    det = a11 * a22 - a12 * a12
    # |grad f|^2 = f,_alpha a^{alpha beta} f,_beta (padded qps replicate
    # real geometry with zero weight, so det > 0 there too)
    grad2 = (a22 * fu * fu - 2.0 * a12 * fu * fv + a11 * fv * fv) / det
    J = torch.linalg.norm(torch.linalg.cross(A1, A2, dim=-1), dim=-1)
    per_patch = (grad2 * J * stack.wq).sum((-2, -1))          # (P,)
    _, mean_el_area = _patch_areas(stack, cp_init)
    ha = torch.sqrt(mean_el_area.clamp_min(1e-300))
    kappa = regu_para * data.E * h_regu ** 3 / (12.0 * ha
                                                * (1.0 - data.nu ** 2))
    return kappa * per_patch


def internal_energy_regu(data: SystemData, d, cp, h, cp_init, regu_para,
                         field: int = 2, h_regu: float = 1e-3):
    """W_int + the CP-smoothness regularization (the reference eVTOL
    objective); W_int through kernel K1 on CUDA tensors."""
    return internal_energy(data, d, cp, h) + cp_regu_energy(
        data, cp, cp_init, regu_para, field=field, h_regu=h_regu).sum()


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
