"""Vortex-lattice aerodynamics on the (deformed) wing midsurface.

Port of goldfish_tpu/physics/vlm.py: a steady horseshoe-vortex lattice
whose corner nodes ride the deformed shell midsurface, so that the coupled
fluid-structure gradient comes out of autograd through both solvers.

- `build_lattice_param` (host NumPy, a copy of the reference's): the
  lattice's patch ids and patch-local coordinates, and the panel of every
  flat CP for the force-to-field map;
- `lattice_points`: midsurface + displacement at the lattice's fixed
  parametric points, on K5's rows (`lattice_rows`, one
  `bspline_traced.traced_rows` launch; they depend on neither cp nor d,
  so the coupled demo computes them once); autograd flows through the
  coefficient gather into d and cp;
- `aic`: the aerodynamic influence matrix, AIC[i, j] = (v_hs(c_i; A_j, B_j)
  + v_hs(c_i; m B_j, m A_j)) . n_i with the mirror m = (1, -1, 1), as a
  `torch.autograd.Function` over kernel K11 `vlm_aic`
  (csrc/vlm_aic.cu: mode 0 the value, mode 1 its VJP in the collocation
  points, normals and bound-segment ends) on CUDA tensors, and over its
  plain PyTorch version (`aic_plain`, the reference's `_horseshoe_induced`
  composition with its exact regularization) on CPU tensors;
- `solve_panel_forces`: panel geometry in plain torch, Gamma by
  `torch.linalg.solve` (the library call in place of the reference's
  jnp.linalg.solve; its adjoint by autograd), Kutta-Joukowski forces;
- `forces_to_cp_field`: panel force densities gathered to the CPs, padded.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.ops.bspline_traced import SurfSet, traced_rows
from goldfish_tpu_torch.physics.kl_shell import _cross, _dot

__all__ = ["Lattice", "build_lattice_param", "lattice_rows",
           "lattice_points", "aic_plain",
           "aic_vjp_plain", "aic_value", "aic_vjp", "aic", "panel_geometry",
           "wake_direction", "solve_panel_forces",
           "forces_to_cp_field"]

CORE = 1e-8            # vortex-core regularization (the reference's)
MIRROR = (1.0, -1.0, 1.0)


class Lattice(NamedTuple):
    """Static parametric layout of the lattice on a patch grid."""

    ip: torch.Tensor        # (Mc+1, Ns+1) int32 patch id per corner node
    xi: torch.Tensor        # (Mc+1, Ns+1, 2) patch-local coords
    panel_cp: torch.Tensor  # (n_cp_total,) int32 panel id of each flat CP
    n_chord: int
    n_span: int


def build_lattice_param(n_chord_patches, n_span_patches, mc, ns,
                        cp_uv=None, device=None) -> Lattice:
    """Lattice of mc x ns panels over an n_chord x n_span patch grid whose
    global parametrization is (u, v) in [0, 1]^2, patch (i, j) covering
    [i/nc, (i+1)/nc] x [j/ns, (j+1)/ns] (the layout of models/wing.build).
    `cp_uv` (optional, (n_cp_total, 2) global CP parametric locations)
    fills `panel_cp`. A copy of the reference's host code: ip, xi and
    panel_cp are bit for bit the reference's."""
    device = as_device(device)
    nc, nsp = n_chord_patches, n_span_patches
    u = np.linspace(0.0, 1.0, mc + 1)
    v = np.linspace(0.0, 1.0, ns + 1)
    U, V = np.meshgrid(u, v, indexing="ij")
    i = np.minimum((U * nc).astype(np.int64), nc - 1)
    j = np.minimum((V * nsp).astype(np.int64), nsp - 1)
    ip = (j * nc + i).astype(np.int32)
    xi = np.stack([U * nc - i, V * nsp - j], axis=-1)

    panel_cp = np.zeros(0, dtype=np.int32)
    if cp_uv is not None:
        pu = np.clip((np.asarray(cp_uv)[:, 0] * mc).astype(np.int64),
                     0, mc - 1)
        pv = np.clip((np.asarray(cp_uv)[:, 1] * ns).astype(np.int64),
                     0, ns - 1)
        panel_cp = (pu * ns + pv).astype(np.int32)
    return Lattice(ip=tensor(ip, device, INDEX_DTYPE), xi=tensor(xi, device),
                   panel_cp=tensor(panel_cp, device, INDEX_DTYPE),
                   n_chord=mc, n_span=ns)


def lattice_rows(ss: SurfSet, p: int, q: int, lat: Lattice):
    """The K5 rows of the lattice's corners, one launch: ((patch, CP)
    gather index, R0 (M, L)). They depend on neither cp nor d, so a caller
    that evaluates the lattice again and again computes them once and
    passes them to `lattice_points`."""
    ip = lat.ip.reshape(-1).contiguous()
    conn, R = traced_rows(ss, p, q, ip, lat.xi.reshape(-1, 2).contiguous())
    return (ip.long()[:, None], conn.long()), R[0]


def lattice_points(ss: SurfSet, p: int, q: int, lat: Lattice, cp, d,
                   rows=None):
    """Deformed corner nodes (Mc+1, Ns+1, 3): midsurface + displacement at
    the lattice's fixed parametric points, on `rows` (`lattice_rows`; one
    K5 launch here when None); the two rational interpolations are
    gathers, differentiable in cp and d."""
    idx, R0 = lattice_rows(ss, p, q, lat) if rows is None else rows
    x = torch.einsum("ml,mlk->mk", R0, cp[idx])
    u = torch.einsum("ml,mlk->mk", R0, d[idx])
    return (x + u).reshape(lat.ip.shape + (3,))


# ------------------------------------------------------------ plain version
def _norm(x):
    return torch.sqrt(_dot(x, x))


def _seg_induced(P, A, B):
    """Biot-Savart velocity of a unit-strength finite segment A->B at
    points P: P (N, 3), A/B (M, 3) -> (N, M, 3)."""
    r1 = P[:, None, :] - A[None, :, :]
    r2 = P[:, None, :] - B[None, :, :]
    cr = _cross(r1, r2)
    cr2 = _dot(cr, cr)
    n1 = _norm(r1)
    n2 = _norm(r2)
    r0 = B[None] - A[None]
    num = _dot(r0, r1) / (n1 + 1e-300) - _dot(r0, r2) / (n2 + 1e-300)
    k = num / (4.0 * math.pi * (cr2 + CORE))
    return cr * k[..., None]


def _semiinf_induced(P, A, direction):
    """Semi-infinite vortex from A along the unit `direction` at P:
    (N, M, 3) for unit strength (leg running A -> infinity)."""
    r = P[:, None, :] - A[None, :, :]
    d = direction.expand_as(r)
    cr = _cross(d, r)
    cr2 = _dot(cr, cr)
    rn = _norm(r)
    cosv = _dot(d, r) / (rn + 1e-300)
    k = (1.0 + cosv) / (4.0 * math.pi * (cr2 + CORE))
    return cr * k[..., None]


def _horseshoe_induced(P, A, B, wake_dir):
    """Unit horseshoe: bound A->B plus trailing legs (B -> inf) and
    (inf -> A), wake along `wake_dir`."""
    vb = _seg_induced(P, A, B)
    vB = _semiinf_induced(P, B, wake_dir)
    vA = _semiinf_induced(P, A, wake_dir)
    return vb + vB - vA


def aic_plain(colloc, nhat, A, B, wake, symmetric=True):
    """The plain version of K11 mode 0: (N, N) AIC through the (N, N, 3)
    temporaries of the reference."""
    vind = _horseshoe_induced(colloc, A, B, wake)
    if symmetric:
        mir = torch.tensor(MIRROR, dtype=A.dtype, device=A.device)
        vind = vind + _horseshoe_induced(colloc, B * mir, A * mir, wake)
    return _dot(vind, nhat[:, None, :])


# ------------------------------------------------------------ K11 wrappers
def _check_aic(colloc, nhat, A, B, wake, gbar=None):
    N = colloc.shape[0]
    dev = colloc.device
    for name, t in (("colloc", colloc), ("nhat", nhat), ("A", A), ("B", B)):
        _cuda.check(t, name, DTYPE, (N, 3), dev)
    _cuda.check(wake, "wake", DTYPE, (3,), dev)
    if gbar is not None:
        _cuda.check(gbar, "gbar", DTYPE, (N, N), dev)
    return N


def aic_value(colloc, nhat, A, B, wake, symmetric=True):
    """K11 mode 0: the (N, N) AIC from the collocation points, unit normals
    and bound-segment ends (N, 3) and the unit wake direction (3,)."""
    N = _check_aic(colloc, nhat, A, B, wake)
    if not _cuda.on_cuda(colloc):
        return aic_plain(colloc, nhat, A, B, wake, symmetric)
    out = torch.empty(N, N, dtype=DTYPE, device=colloc.device)
    p = _cuda.ptr
    _cuda.launch("vlm_aic/value", "gf_vlm_aic", 0, p(colloc), p(nhat), p(A),
                 p(B), p(wake), None, p(out), None, None, None, None, N,
                 int(symmetric))
    return out


def aic_vjp_plain(colloc, nhat, A, B, wake, gbar, symmetric=True):
    """The plain version of K11 mode 1: autograd through `aic_plain`."""
    with torch.enable_grad():
        _, vjp = torch.func.vjp(
            lambda c, n, a, b: aic_plain(c, n, a, b, wake, symmetric),
            colloc, nhat, A, B)
        return vjp(gbar)


def aic_vjp(colloc, nhat, A, B, wake, gbar, symmetric=True):
    """K11 mode 1: the cotangents (d colloc, d nhat, d A, d B), each (N, 3),
    of gbar (N, N) through the AIC."""
    N = _check_aic(colloc, nhat, A, B, wake, gbar)
    if not _cuda.on_cuda(colloc):
        return aic_vjp_plain(colloc, nhat, A, B, wake, gbar, symmetric)
    outs = torch.zeros(4, N, 3, dtype=DTYPE, device=colloc.device)
    p = _cuda.ptr
    _cuda.launch("vlm_aic/vjp", "gf_vlm_aic", 1, p(colloc), p(nhat), p(A),
                 p(B), p(wake), p(gbar), None, *(p(o) for o in outs), N,
                 int(symmetric))
    return tuple(outs)


class _AIC(torch.autograd.Function):

    @staticmethod
    def forward(ctx, colloc, nhat, A, B, wake, symmetric):
        ctx.save_for_backward(colloc, nhat, A, B, wake)
        ctx.symmetric = symmetric
        return aic_value(colloc, nhat, A, B, wake, symmetric)

    @staticmethod
    def backward(ctx, gbar):
        colloc, nhat, A, B, wake = ctx.saved_tensors
        dc, dn, dA, dB = aic_vjp(colloc, nhat, A, B, wake,
                                 gbar.contiguous(), ctx.symmetric)
        return dc, dn, dA, dB, None, None


def aic(colloc, nhat, A, B, wake, symmetric=True):
    """The AIC (N, N), differentiable in colloc, nhat, A and B (K11 value
    forward, K11 VJP backward on CUDA tensors)."""
    return _AIC.apply(colloc.contiguous(), nhat.contiguous(), A.contiguous(),
                      B.contiguous(), wake.contiguous(), bool(symmetric))


# ------------------------------------------------------------ VLM solve
def panel_geometry(corners):
    """(A, B, colloc, nhat, area) of the corner grid (Mc+1, Ns+1, 3): the
    bound segments' ends at the quarter chord, the collocation points at
    the 3/4 chord, unit normals (each (Mc Ns, 3)) and panel areas
    (Mc, Ns)."""
    c00 = corners[:-1, :-1]
    c10 = corners[1:, :-1]
    c01 = corners[:-1, 1:]
    c11 = corners[1:, 1:]

    A = (c00 + 0.25 * (c10 - c00)).reshape(-1, 3)    # quarter chord, n
    B = (c01 + 0.25 * (c11 - c01)).reshape(-1, 3)    # quarter chord, n+1
    colloc = (0.5 * (c00 + c01)
              + 0.75 * (0.5 * (c10 + c11) - 0.5 * (c00 + c01))
              ).reshape(-1, 3)
    nvec = _cross(c11 - c00, c01 - c10)
    area = 0.5 * _norm(nvec)
    nhat = (nvec / (2.0 * area[..., None] + 1e-300)).reshape(-1, 3)
    return A, B, colloc, nhat, area


def wake_direction(device):
    """The reference's wake direction (cos(alpha) * 0 + 1, 0, 0),
    normalized: +x."""
    return torch.tensor([1.0, 0.0, 0.0], dtype=DTYPE, device=device)


def solve_panel_forces(corners, alpha, V_inf=1.0, rho=1.225,
                       symmetric=True):
    """VLM solve on the corner grid (Mc+1, Ns+1, 3). Returns (F, aux): F
    (Mc, Ns, 3) panel forces; aux {"gamma" (Mc, Ns), "area" (Mc, Ns),
    "lift" (0-dim)}. alpha is the freestream angle of attack in the x-z
    plane."""
    Mc = corners.shape[0] - 1
    Ns = corners.shape[1] - 1
    A, B, colloc, nhat, area = panel_geometry(corners)
    alpha = torch.as_tensor(alpha, dtype=DTYPE, device=corners.device)
    wake = wake_direction(corners.device)
    Vvec = V_inf * torch.stack([torch.cos(alpha), torch.zeros_like(alpha),
                                torch.sin(alpha)])

    AIC = aic(colloc, nhat, A, B, wake, symmetric)
    rhs = -_dot(Vvec, nhat)
    gamma = torch.linalg.solve(AIC, rhs)

    lvec = B - A
    F = rho * gamma[:, None] * _cross(Vvec.expand_as(lvec), lvec)
    F = F.reshape(Mc, Ns, 3)
    aux = {"gamma": gamma.reshape(Mc, Ns),
           "area": area,
           "lift": F[..., 2].sum()}
    return F, aux


def forces_to_cp_field(lat: Lattice, F, area, layout_to_padded):
    """Panel forces -> (P, C, 3) CP coefficient force-density field (the f
    input of `implicit.build_field_solve_fn`): each CP samples the force
    density F_panel / A_panel of the panel containing its parametric
    location."""
    dens = F.reshape(-1, 3) / (area.reshape(-1, 1) + 1e-300)
    return layout_to_padded(dens[lat.panel_cp.long()])
