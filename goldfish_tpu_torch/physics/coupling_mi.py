"""Penalty coupling with moving intersections: the coupling energy as a
function of the intersection coordinates xi.

Port of goldfish_tpu/physics/coupling_mi.py. The penalty density is the
fixed-intersection one (physics/coupling.py); only where it is evaluated
moves. So the port builds, at the current xi, an `InterfaceStack` whose
basis rows kernel K5 (`ops.bspline_traced.traced_rows`) evaluates at the
intersection points, with the trapezoid weights `w_s` and the curve
tangents of `_curve_tangents`. On that stack kernel K2 gives the energy,
the residual, the 18x18 jet Hessians and the (cp, h) adjoint, and K3/K4
assemble and multiply, exactly as for fixed intersections. The one new
derivative, d(lambda^T r_pen)/dxi, is kernel K6 `mi_penalty_xi`
(csrc/mi_penalty_xi.cu) per point, chained through the tangents' linear
neighbour map by torch autograd. Its forward counterpart, d r_pen/dxi
applied to a tangent t_xi, is K6's mode 1 (`penalty_xi_jvp`: the curve
tangents' tangent is `_curve_tangents(t_xi)`, the map being linear).

Quadrature: the xi sample points themselves, trapezoid weights in the
curve parameter s in [0, 1]; curve tangents dxi/ds from neighbour
differences (one-sided at the ends). Padded points carry zero weight and
replicate the last real point and its tangent.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.geometry.cpiga2xi import MovingIntersections
from goldfish_tpu_torch.ops.bspline_traced import (
    SurfSet,
    _rows_plain,
    _surf_set_args,
    _surf_set_dims,
    traced_rows,
)
from goldfish_tpu_torch.physics import coupling
from goldfish_tpu_torch.physics.coupling import InterfaceStack

__all__ = ["MICoupling", "build_mi_coupling", "interface_stack_mi",
           "penalty_energy_mi", "interface_hessians_mi", "mi_penalty_xi",
           "penalty_xi_vjp", "mi_penalty_xi_fwd", "penalty_xi_jvp"]


class MICoupling(NamedTuple):
    """Penalty scales + quadrature weights; I intersections, N points."""

    w_s: torch.Tensor       # (I, N) trapezoid weights (0 on padding)
    ad_scale: torch.Tensor  # (I,) penalty_coefficient / h_m
    ar_scale: torch.Tensor  # (I,)


def build_mi_coupling(surfs, mi: MovingIntersections,
                      penalty_coefficient: float = 1.0e3,
                      device=None) -> MICoupling:
    """Trapezoid weights + penalty scales from the initial geometry (h_m
    frozen at setup, PENGoLINS' mortar-size convention)."""
    device = as_device(device)
    I, N = mi.n_int, mi.n_max
    w = np.zeros((I, N))
    ad = np.zeros(I)
    n_pts = mi.n_pts.cpu().numpy()
    xi0 = mi.xi0.cpu().numpy()
    pairA = mi.pairA.cpu().numpy()
    for i in range(I):
        n = int(n_pts[i])
        w[i, :n] = 1.0 / (n - 1)
        w[i, 0] = w[i, n - 1] = 0.5 / (n - 1)
        sA = surfs[pairA[i]]
        pts = np.stack([
            sA.evaluate(np.array([xi0[i, k, 0, 0]]),
                        np.array([xi0[i, k, 0, 1]]))[0, 0]
            for k in range(n)])
        length = float(np.sum(np.linalg.norm(np.diff(pts, axis=0), axis=-1)))
        h_m = max(length / (n - 1), 1e-14)
        ad[i] = penalty_coefficient / h_m
    return MICoupling(w_s=tensor(w, device), ad_scale=tensor(ad, device),
                      ar_scale=tensor(ad, device))


def _curve_tangents(xiS, n_pts):
    """dxi/ds at every sample of one curve side: (I, N, 2) from (I, N, 2).

    Central differences in the interior, one-sided at the real ends.
    Padded rows (k > n_pts-1) replicate the last real point, so their
    neighbour differences are exactly zero, which would feed unit(0) NaNs
    into the penalty density that the zero quadrature weight cannot mask
    (0 * NaN = NaN): padded rows carry the last real point's tangent
    instead. Linear in xiS."""
    I, N = xiS.shape[:2]
    n1 = (n_pts - 1).to(xiS.dtype)[:, None, None]
    fwd = torch.roll(xiS, -1, 1) - xiS
    bwd = xiS - torch.roll(xiS, 1, 1)
    k = torch.arange(N, device=xiS.device)[None, :]
    last = (n_pts.long() - 1)[:, None]
    interior = ((k > 0) & (k < last))[..., None]
    dxi = torch.where(interior, 0.5 * (fwd + bwd) * n1,
                      torch.where((k == 0)[..., None], fwd * n1, bwd * n1))
    dxi_last = dxi[torch.arange(I, device=xiS.device), last[:, 0]]
    return torch.where((k > last)[..., None], dxi_last[:, None, :], dxi)


def interface_stack_mi(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                       co: MICoupling, xi, plain: bool = False
                       ) -> InterfaceStack:
    """The coupling's InterfaceStack at intersection coordinates xi
    (I, 4N): both sides' rows from one K5 launch (points ordered side,
    intersection, point), the trapezoid weights and the curve tangents.
    `plain` takes the plain rows on any device (differentiable in xi; the
    plain version of K6 differentiates through them)."""
    I, N = mi.n_int, mi.n_max
    xi4 = xi.reshape(I, N, 2, 2)
    ip = torch.cat([mi.pairA[:, None].expand(I, N).reshape(-1),
                    mi.pairB[:, None].expand(I, N).reshape(-1)]).contiguous()
    pts = xi4.permute(2, 0, 1, 3).reshape(2 * I * N, 2).contiguous()
    rows = _rows_plain if plain else traced_rows
    conn, R = rows(ss, p, q, ip, pts)
    L = conn.shape[-1]
    conn = conn.reshape(2, I, N, L)
    R = R.reshape(3, 2, I, N, L)
    return InterfaceStack(
        pairA=mi.pairA, pairB=mi.pairB, connA=conn[0], connB=conn[1],
        RA00=R[0, 0], RA10=R[1, 0], RA01=R[2, 0],
        RB00=R[0, 1], RB10=R[1, 1], RB01=R[2, 1],
        w=co.w_s,
        dxiA=_curve_tangents(xi4[:, :, 0], mi.n_pts).contiguous(),
        dxiB=_curve_tangents(xi4[:, :, 1], mi.n_pts).contiguous(),
        ad_scale=co.ad_scale, ar_scale=co.ar_scale)


def penalty_energy_mi(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                      co: MICoupling, xi, d, cp, h_coef, E):
    """Total coupling penalty at the current intersection coordinates xi
    (I, 4N) (0-dim tensor)."""
    return coupling.penalty_energy(interface_stack_mi(ss, p, q, mi, co, xi),
                                   d, cp, h_coef, E)


def interface_hessians_mi(ss, p, q, mi: MovingIntersections, co: MICoupling,
                          xi, d, cp, h_coef, E):
    """Exact coupling stiffness blocks at xi: (I, N, 6L, 6L) Hessians with
    respect to the stacked [deA; deB] locals, plus the (I, N, L) conn
    arrays that scatter them (for tests and diagnostics)."""
    ifs = interface_stack_mi(ss, p, q, mi, co, xi)
    return (coupling.interface_hessians(ifs, d, cp, h_coef, E), ifs.connA,
            ifs.connB)


# ------------------------------------------------------------ K6
def _xi_grad_plain(ss, p, q, mi, co, xi4, dxiA, dxiB, d, cp, h, E, lam):
    """Plain K6: autograd through the plain rows."""
    I, N = mi.n_int, mi.n_max
    with torch.enable_grad():
        xv = xi4.detach().requires_grad_(True)
        dA = dxiA.detach().requires_grad_(True)
        dB = dxiB.detach().requires_grad_(True)
        ifs = interface_stack_mi(ss, p, q, mi, co, xv.reshape(I, 4 * N),
                                 plain=True)
        ifs = ifs._replace(dxiA=dA, dxiB=dB)
        X, z, hA, hB, Ei, ad, ar = coupling._qp_inputs(ifs, d, cp, h, E)
        lz = coupling._qp_inputs(ifs, lam, cp, h, E)[1]
        f = coupling.penalty_density(X, z, hA, hB, dA, dB, Ei, ad, ar,
                                     ifs.w)
        gz = torch.autograd.grad(f.sum(), z, create_graph=True)[0]
        g = torch.autograd.grad((gz * lz).sum(), (xv, dA, dB),
                                allow_unused=True)
    g = [torch.zeros_like(t) if gi is None else gi
         for gi, t in zip(g, (xv, dA, dB))]
    return torch.cat([g[0].reshape(I, N, 4), g[1], g[2]], -1)


def mi_penalty_xi(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                  co: MICoupling, xi, dxiA, dxiB, d, cp, h, E, lam):
    """K6: per point, d/d(xiA, xiB, dxiA, dxiB) of lambda_z .
    grad_z(w * density): (I, N, 8). xi (I, N, 2, 2); dxiA, dxiB (I, N, 2)
    the curve tangents at xi."""
    I, N = mi.n_int, mi.n_max
    P, C = d.shape[0], d.shape[1]
    dev = d.device
    _cuda.check(xi, "xi", DTYPE, (I, N, 2, 2), dev)
    _cuda.check(dxiA, "dxiA", DTYPE, (I, N, 2), dev)
    _cuda.check(dxiB, "dxiB", DTYPE, (I, N, 2), dev)
    _cuda.check(co.w_s, "w_s", DTYPE, (I, N), dev)
    _cuda.check(co.ad_scale, "ad_scale", DTYPE, (I,), dev)
    _cuda.check(co.ar_scale, "ar_scale", DTYPE, (I,), dev)
    _cuda.check(mi.pairA, "pairA", INDEX_DTYPE, (I,), dev)
    _cuda.check(mi.pairB, "pairB", INDEX_DTYPE, (I,), dev)
    for name, t in (("d", d), ("cp", cp), ("lam", lam)):
        _cuda.check(t, name, DTYPE, (P, C, 3), dev)
    _cuda.check(h, "h", DTYPE, (P, C), dev)
    _cuda.check(E, "E", DTYPE, (P,), dev)
    if not _cuda.on_cuda(d):
        return _xi_grad_plain(ss, p, q, mi, co, xi, dxiA, dxiB, d, cp, h, E,
                              lam)
    out = torch.empty(I, N, 8, dtype=DTYPE, device=dev)
    P_ = _cuda.ptr
    _cuda.launch("mi_penalty_xi", "gf_mi_penalty_xi", *_surf_set_args(ss),
                 P_(mi.pairA), P_(mi.pairB), P_(xi), P_(dxiA), P_(dxiB),
                 P_(co.w_s), P_(co.ad_scale), P_(co.ar_scale), P_(d), P_(cp),
                 P_(h), P_(E), P_(lam), P_(out), *_surf_set_dims(ss, p, q),
                 I, N)
    return out


def penalty_xi_vjp(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                   co: MICoupling, xi, d, cp, h, E, lam):
    """-lam^T d r_pen / d xi (I, 4N): K6 per point, chained through the
    curve tangents' linear neighbour map (autograd of `_curve_tangents`)."""
    I, N = mi.n_int, mi.n_max
    xi4 = xi.reshape(I, N, 2, 2).contiguous()
    with torch.enable_grad():
        xv = xi4.detach().requires_grad_(True)
        dA = _curve_tangents(xv[:, :, 0], mi.n_pts)
        dB = _curve_tangents(xv[:, :, 1], mi.n_pts)
    g8 = mi_penalty_xi(ss, p, q, mi, co, xi4, dA.detach().contiguous(),
                       dB.detach().contiguous(), d, cp, h, E, lam)
    with torch.enable_grad():
        g_t = torch.autograd.grad(
            (dA * g8[..., 4:6]).sum() + (dB * g8[..., 6:8]).sum(), xv)[0]
    return -(g8[..., :4].reshape(I, N, 2, 2) + g_t).reshape(I, 4 * N)


def _xi_fwd_plain(ss, p, q, mi, co, xi4, dxiA, dxiB, d, cp, h, E, txi4,
                  tdxA, tdxB):
    """Plain K6 mode 1: torch.func.jvp of the plain r_pen on the plain rows
    in (xi, dxiA, dxiB)."""
    I, N = mi.n_int, mi.n_max

    def r_pen(x4, dA, dB):
        ifs = interface_stack_mi(ss, p, q, mi, co, x4.reshape(I, 4 * N),
                                 plain=True)._replace(dxiA=dA, dxiB=dB)
        return coupling._value_grad_plain(ifs, d, cp, h, E)[1]

    return torch.func.jvp(r_pen, (xi4, dxiA, dxiB), (txi4, tdxA, tdxB))[1]


def mi_penalty_xi_fwd(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                      co: MICoupling, xi, dxiA, dxiB, d, cp, h, E, txi, tdxA,
                      tdxB):
    """K6 mode 1: d r_pen/d(xi, dxiA, dxiB) along (txi, tdxA, tdxB), (P, C,
    3) (unmasked). xi, txi (I, N, 2, 2); dxiA, dxiB and their tangents
    tdxA, tdxB (I, N, 2). A warp a point: the rows' xi-derivatives and the
    penalty sweep's forward tangent, one f64 atomic a node and component;
    its plain version (`_xi_fwd_plain`) on CPU tensors."""
    I, N = mi.n_int, mi.n_max
    P, C = d.shape[0], d.shape[1]
    dev = d.device
    for name, t in (("xi", xi), ("txi", txi)):
        _cuda.check(t, name, DTYPE, (I, N, 2, 2), dev)
    for name, t in (("dxiA", dxiA), ("dxiB", dxiB), ("tdxA", tdxA),
                    ("tdxB", tdxB)):
        _cuda.check(t, name, DTYPE, (I, N, 2), dev)
    _cuda.check(co.w_s, "w_s", DTYPE, (I, N), dev)
    _cuda.check(co.ad_scale, "ad_scale", DTYPE, (I,), dev)
    _cuda.check(co.ar_scale, "ar_scale", DTYPE, (I,), dev)
    _cuda.check(mi.pairA, "pairA", INDEX_DTYPE, (I,), dev)
    _cuda.check(mi.pairB, "pairB", INDEX_DTYPE, (I,), dev)
    for name, t in (("d", d), ("cp", cp)):
        _cuda.check(t, name, DTYPE, (P, C, 3), dev)
    _cuda.check(h, "h", DTYPE, (P, C), dev)
    _cuda.check(E, "E", DTYPE, (P,), dev)
    if not _cuda.on_cuda(d):
        return _xi_fwd_plain(ss, p, q, mi, co, xi, dxiA, dxiB, d, cp, h, E,
                             txi, tdxA, tdxB)
    out = torch.zeros_like(d)
    P_ = _cuda.ptr
    _cuda.launch("mi_penalty_xi/xi_fwd", "gf_mi_penalty_xi_fwd",
                 *_surf_set_args(ss), P_(mi.pairA), P_(mi.pairB), P_(xi),
                 P_(dxiA), P_(dxiB), P_(txi), P_(tdxA), P_(tdxB),
                 P_(co.w_s), P_(co.ad_scale), P_(co.ar_scale), P_(d),
                 P_(cp), P_(h), P_(E), P_(out), *_surf_set_dims(ss, p, q), I,
                 N)
    return out


def penalty_xi_jvp(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                   co: MICoupling, xi, d, cp, h, E, txi):
    """d r_pen/dxi . txi (P, C, 3), r_pen = dW_pen/dd at xi (I, 4N), for a
    tangent txi (I, 4N) (unmasked; the caller masks): K6 mode 1
    (`mi_penalty_xi_fwd`) with the curve tangents at xi and theirs,
    `_curve_tangents(txi)` (the map is linear)."""
    I, N = mi.n_int, mi.n_max
    xi4 = xi.reshape(I, N, 2, 2).contiguous()
    t4 = txi.reshape(I, N, 2, 2).contiguous()
    tang = [_curve_tangents(x[:, :, k], mi.n_pts).contiguous()
            for x in (xi4, t4) for k in (0, 1)]
    return mi_penalty_xi_fwd(ss, p, q, mi, co, xi4, tang[0], tang[1], d, cp,
                             h, E, t4, tang[2], tang[3])
