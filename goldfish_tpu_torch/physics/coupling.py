"""Penalty coupling of non-matching patches at interface quadrature points.

Port of goldfish_tpu/physics/coupling.py. Both patches' rational bases are
evaluated at shared interface quadrature points (the host builder
`build_interfaces`, NumPy, unchanged), and the displacement + rotational
continuity penalties of Herrema et al. (CMAME 2019)

  W_pen = sum_qp w dl [ alpha_d/2 |u_A - u_B|^2
        + alpha_r/2 ((a3A.a3B - A3A.A3B)^2 + (a3A.anB - A3A.AnB)^2) ]

are one more energy term. The density depends on the displacement only
through the 18-jet z = (uA, uA_u, uA_v, uB, uB_u, uB_v), so, as for the
shell, every derivative is a per-qp jet derivative:

- `penalty_value_grad`: per-interface energy, r_pen = dW/dd, dW/dh;
- `penalty_hessians`: the per-qp 18x18 jet Hessian (I, N, 18, 18);
- `penalty_adjoint`: -d/d(cp, h) of lambda^T r_pen;
- `penalty_design_jvp`: d r_pen along a design tangent (tcp, th).

Each runs the CUDA kernel K2 `penalty_qp` (csrc/penalty_qp.cu) on CUDA
tensors and its plain PyTorch version on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.ops.bspline import rational_basis_2d
from goldfish_tpu_torch.ops.quadrature import gauss_points_1d
from goldfish_tpu_torch.physics.kl_shell import _cross, _dot

__all__ = ["InterfaceStack", "InterfaceSpec", "build_interfaces",
           "penalty_density", "penalty_value_grad", "penalty_hessians",
           "penalty_adjoint", "penalty_design_jvp", "penalty_energy",
           "interface_hessians"]

NZ = 18  # (uA, uAu, uAv, uB, uBu, uBv) x 3


class InterfaceSpec(NamedTuple):
    """Host-side description of one patch-patch intersection (straight
    parametric segments by their endpoints, or parametric polylines)."""

    pair: tuple  # (patch_A, patch_B)
    xi_ends_A: np.ndarray  # (2, 2) segment endpoints in A's parametric space
    xi_ends_B: np.ndarray  # (2, 2)
    n_mortar_el: int       # quadrature resolution along the interface
    xi_pts_A: np.ndarray | None = None  # (m, 2) parametric polyline
    xi_pts_B: np.ndarray | None = None  # (m, 2)


def spec_polylines(spec: InterfaceSpec):
    """(ptsA, ptsB) polylines of a spec (2-point for straight segs)."""
    if spec.xi_pts_A is not None:
        return (np.asarray(spec.xi_pts_A, dtype=np.float64),
                np.asarray(spec.xi_pts_B, dtype=np.float64))
    return (np.asarray(spec.xi_ends_A, dtype=np.float64),
            np.asarray(spec.xi_ends_B, dtype=np.float64))


def polyline_interp(pts: np.ndarray, s: np.ndarray):
    """Piecewise-linear interpolation of a (m, 2) polyline at curve
    parameter s in [0, 1] (uniform per segment). Returns (xi, dxi/ds)."""
    m = pts.shape[0]
    if m == 2:
        xi = (1 - s)[:, None] * pts[0] + s[:, None] * pts[1]
        dxi = np.broadcast_to(pts[1] - pts[0], xi.shape)
        return xi, np.array(dxi)
    t = s * (m - 1)
    j = np.clip(np.floor(t).astype(int), 0, m - 2)
    f = (t - j)[:, None]
    xi = (1 - f) * pts[j] + f * pts[j + 1]
    dxi = (pts[j + 1] - pts[j]) * (m - 1)
    return xi, dxi


class InterfaceStack(NamedTuple):
    """Padded tensors; I = interfaces, N = max qps, L = max local."""

    pairA: torch.Tensor  # (I,) int32
    pairB: torch.Tensor
    connA: torch.Tensor  # (I, N, L) int32
    connB: torch.Tensor
    RA00: torch.Tensor   # (I, N, L)
    RA10: torch.Tensor
    RA01: torch.Tensor
    RB00: torch.Tensor
    RB10: torch.Tensor
    RB01: torch.Tensor
    w: torch.Tensor      # (I, N) quadrature weights in s (0 on padding)
    dxiA: torch.Tensor   # (I, N, 2) d xi_A / ds
    dxiB: torch.Tensor
    ad_scale: torch.Tensor  # (I,) penalty_coefficient / h_m
    ar_scale: torch.Tensor  # (I,)

    @property
    def n_interfaces(self):
        return self.pairA.shape[0]


def _segment_quadrature(n_el: int, nq: int = 2):
    """Gauss points/weights on [0,1] split into n_el elements."""
    g, wg = gauss_points_1d(nq)
    edges = np.linspace(0.0, 1.0, n_el + 1)
    s = []
    w = []
    for a, b in zip(edges[:-1], edges[1:]):
        s.append(0.5 * (a + b) + 0.5 * (b - a) * g)
        w.append(0.5 * (b - a) * wg)
    return np.concatenate(s), np.concatenate(w)


def build_interfaces(surfs: list[NURBS], specs: list[InterfaceSpec],
                     penalty_coefficient: float = 1.0e3, nq_per_el: int = 2,
                     device=None) -> InterfaceStack | None:
    """Precompute interface quadrature + both sides' basis tables (the
    reference's NumPy builder, unchanged, ending in tensors on `device`).

    alpha_d = c E h / h_m, alpha_r = c E h^3 / (12 h_m) with h_m the mortar
    element size; E and h are evaluated on the fly at the interface."""
    device = as_device(device)
    if not specs:
        return None
    per = []
    for spec in specs:
        iA, iB = spec.pair
        sA, sB = surfs[iA], surfs[iB]
        s, w = _segment_quadrature(spec.n_mortar_el, nq_per_el)
        plA, plB = spec_polylines(spec)
        xiA, dxiA = polyline_interp(plA, s)
        xiB, dxiB = polyline_interp(plB, s)

        pA, qA = sA.degree
        pB, qB = sB.degree
        connA, tabA = rational_basis_2d(
            sA.knots[0], sA.knots[1], pA, qA, sA.weights, xiA, nd=1)
        connB, tabB = rational_basis_2d(
            sB.knots[0], sB.knots[1], pB, qB, sB.weights, xiB, nd=1)

        # physical interface length on reference geometry of side A
        PA = sA.points.reshape(-1, 3)
        Xu = np.einsum("nl,nlk->nk", tabA[(1, 0)], PA[connA])
        Xv = np.einsum("nl,nlk->nk", tabA[(0, 1)], PA[connA])
        dXds = Xu * dxiA[:, :1] + Xv * dxiA[:, 1:]
        length = float(np.sum(np.linalg.norm(dXds, axis=-1) * w))
        h_m = length / spec.n_mortar_el

        per.append(dict(
            iA=iA, iB=iB, connA=connA, connB=connB,
            RA=tabA, RB=tabB, w=w, dxiA=dxiA, dxiB=dxiB,
            ad=penalty_coefficient / h_m,
            ar=penalty_coefficient / h_m,
        ))

    N = max(p["w"].shape[0] for p in per)
    L = max(max(p["connA"].shape[1], p["connB"].shape[1]) for p in per)

    def padN(a, n_target, axis=0, mode="zero"):
        """Pad axis to n_target; 'repeat' replicates entry 0 (padded
        interface qps evaluate real geometry with zero weight, so no
        0/0 -> NaN in unit normals)."""
        k = n_target - a.shape[axis]
        if k <= 0:
            return a
        if mode == "repeat":
            filler = np.repeat(np.take(a, [0], axis=axis), k, axis=axis)
            return np.concatenate([a, filler], axis=axis)
        pad = [(0, 0)] * a.ndim
        pad[axis] = (0, k)
        return np.pad(a, pad)

    def pack(key, tab_key=None):
        outs = []
        for p in per:
            a = p[key] if tab_key is None else p[key][tab_key]
            a = padN(a, L, axis=1)                  # local pad: zeros
            a = padN(a, N, axis=0, mode="repeat")   # qp pad: replicate
            outs.append(a)
        return np.stack(outs)

    w = np.stack([padN(p["w"], N) for p in per])  # zero weights on padding
    dxiA = np.stack([padN(p["dxiA"], N, mode="repeat") for p in per])
    dxiB = np.stack([padN(p["dxiB"], N, mode="repeat") for p in per])

    def t(a, dtype=DTYPE):
        return tensor(a, device, dtype)

    return InterfaceStack(
        pairA=t([p["iA"] for p in per], INDEX_DTYPE),
        pairB=t([p["iB"] for p in per], INDEX_DTYPE),
        connA=t(pack("connA"), INDEX_DTYPE),
        connB=t(pack("connB"), INDEX_DTYPE),
        RA00=t(pack("RA", (0, 0))),
        RA10=t(pack("RA", (1, 0))),
        RA01=t(pack("RA", (0, 1))),
        RB00=t(pack("RB", (0, 0))),
        RB10=t(pack("RB", (1, 0))),
        RB01=t(pack("RB", (0, 1))),
        w=t(w),
        dxiA=t(dxiA),
        dxiB=t(dxiB),
        ad_scale=t([p["ad"] for p in per]),
        ar_scale=t([p["ar"] for p in per]),
    )


# ------------------------------------------------------------ density
def _unit(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def penalty_density(X, z, hA, hB, dxA, dxB, E, ad, ar, w):
    """w * density * dl per interface qp. X: (..., 12) = (XAu, XAv, XBu,
    XBv); z: (..., 18) displacement jets; hA, hB, E, ad, ar, w: (...);
    dxA, dxB: (..., 2). The plain version of K2's and K6's density (K2
    and K6 sweep the same formula back by hand, csrc/penalty_sweep.cuh)."""
    XAu, XAv, XBu, XBv = (X[..., 3 * k:3 * k + 3] for k in range(4))
    uA, uB = z[..., 0:3], z[..., 9:12]
    h = 0.5 * (hA + hB)
    dX = XAu * dxA[..., 0:1] + XAv * dxA[..., 1:2]
    dl = torch.sqrt(_dot(dX, dX))
    A3A = _unit(_cross(XAu, XAv))
    A3B = _unit(_cross(XBu, XBv))
    a3A = _unit(_cross(XAu + z[..., 3:6], XAv + z[..., 6:9]))
    xBu, xBv = XBu + z[..., 12:15], XBv + z[..., 15:18]
    a3B = _unit(_cross(xBu, xBv))
    TB = _unit(XBu * dxB[..., 0:1] + XBv * dxB[..., 1:2])
    tB = _unit(xBu * dxB[..., 0:1] + xBv * dxB[..., 1:2])
    AnB = _cross(A3B, TB)
    anB = _cross(a3B, tB)
    dphi = _dot(a3A, a3B) - _dot(A3A, A3B)
    dbeta = _dot(a3A, anB) - _dot(A3A, AnB)
    du = uA - uB
    du2 = _dot(du, du)
    alpha_d = (ad * E) * h
    alpha_r = (ar * E) * (h * h * h) / 12.0
    dens = 0.5 * (alpha_d * du2) \
        + 0.5 * (alpha_r * (dphi * dphi + dbeta * dbeta))
    return w * (dens * dl)


def _side_coef(coef, pair, conn):
    """(P, C, k) -> (I, N, L, k) on one side."""
    return coef[pair.long()[:, None, None], conn.long()]


def _ev(R, c):
    return torch.einsum("inl,inlk->ink", R, c)


def _qp_inputs(ifs: InterfaceStack, d, cp, h, E):
    """Per-qp density inputs (X, z, hA, hB, E, ad, ar), each (I, N, ...)."""
    cA = _side_coef(cp, ifs.pairA, ifs.connA)
    cB = _side_coef(cp, ifs.pairB, ifs.connB)
    dA = _side_coef(d, ifs.pairA, ifs.connA)
    dB = _side_coef(d, ifs.pairB, ifs.connB)
    X = torch.cat([_ev(ifs.RA10, cA), _ev(ifs.RA01, cA),
                   _ev(ifs.RB10, cB), _ev(ifs.RB01, cB)], -1)
    z = torch.cat([_ev(ifs.RA00, dA), _ev(ifs.RA10, dA), _ev(ifs.RA01, dA),
                   _ev(ifs.RB00, dB), _ev(ifs.RB10, dB), _ev(ifs.RB01, dB)],
                  -1)
    hA = _ev(ifs.RA00, _side_coef(h[..., None], ifs.pairA, ifs.connA))[..., 0]
    hB = _ev(ifs.RB00, _side_coef(h[..., None], ifs.pairB, ifs.connB))[..., 0]
    shp = ifs.w.shape
    Ei = torch.maximum(E[ifs.pairA.long()], E[ifs.pairB.long()])
    return (X, z, hA, hB, Ei[:, None].expand(shp),
            ifs.ad_scale[:, None].expand(shp),
            ifs.ar_scale[:, None].expand(shp))


def _scatter_side(R3, pair, conn, g, P, C):
    """(I, N, 9) jet cotangents of one side (value, d/du, d/dv) ->
    (P, C, 3)."""
    contrib = sum(torch.einsum("inl,ink->inlk", R, g[..., 3 * j:3 * j + 3])
                  for j, R in enumerate(R3))
    node = (pair.long()[:, None, None] * C + conn.long()).reshape(-1)
    out = torch.zeros(P * C, 3, dtype=g.dtype, device=g.device)
    out.index_add_(0, node, contrib.reshape(-1, 3))
    return out.reshape(P, C, 3)


def _scatter_h_side(R00, pair, conn, gh, P, C):
    node = (pair.long()[:, None, None] * C + conn.long()).reshape(-1)
    out = torch.zeros(P * C, dtype=gh.dtype, device=gh.device)
    out.index_add_(0, node, (R00 * gh[..., None]).reshape(-1))
    return out.reshape(P, C)


def _scatter(ifs, gz, ghA, ghB, P, C):
    A3 = (ifs.RA00, ifs.RA10, ifs.RA01)
    B3 = (ifs.RB00, ifs.RB10, ifs.RB01)
    f = (_scatter_side(A3, ifs.pairA, ifs.connA, gz[..., :9], P, C)
         + _scatter_side(B3, ifs.pairB, ifs.connB, gz[..., 9:], P, C))
    hh = (_scatter_h_side(ifs.RA00, ifs.pairA, ifs.connA, ghA, P, C)
          + _scatter_h_side(ifs.RB00, ifs.pairB, ifs.connB, ghB, P, C))
    return f, hh


# ------------------------------------------------------------ plain versions
def _value_grad_plain(ifs, d, cp, h, E):
    X, z, hA, hB, Ei, ad, ar = _qp_inputs(ifs, d, cp, h, E)

    def f(zz, a, b):
        return penalty_density(X, zz, a, b, ifs.dxiA, ifs.dxiB, Ei, ad, ar,
                               ifs.w)

    vals, vjp = torch.func.vjp(f, z, hA, hB)
    gz, ghA, ghB = vjp(torch.ones_like(vals))
    r, dh = _scatter(ifs, gz, ghA, ghB, d.shape[0], d.shape[1])
    return vals.sum(-1), r, dh


def _hessians_plain(ifs, d, cp, h, E):
    X, z, hA, hB, Ei, ad, ar = _qp_inputs(ifs, d, cp, h, E)
    shp = ifs.w.shape

    def flat(t, k=None):
        return t.reshape(-1) if k is None else t.reshape(-1, k)

    # reverse over reverse: in eager PyTorch ~4x faster than hessian's
    # forward over reverse, the same values to rounding
    H = torch.func.vmap(torch.func.jacrev(
        torch.func.grad(penalty_density, argnums=1), argnums=1))(
        flat(X, 12), flat(z, NZ), flat(hA), flat(hB), flat(ifs.dxiA, 2),
        flat(ifs.dxiB, 2), flat(Ei), flat(ad), flat(ar), flat(ifs.w))
    return H.reshape(shp + (NZ, NZ))


def _adjoint_plain(ifs, d, cp, h, E, lam):
    X, z, hA, hB, Ei, ad, ar = _qp_inputs(ifs, d, cp, h, E)
    lz = _qp_inputs(ifs, lam, cp, h, E)[1]

    def lam_dot_grad(XX, a, b):
        gz = torch.func.grad(lambda zz: penalty_density(
            XX, zz, a, b, ifs.dxiA, ifs.dxiB, Ei, ad, ar, ifs.w).sum())(z)
        return (gz * lz).sum()

    gX, ghA, ghB = torch.func.grad(lam_dot_grad, argnums=(0, 1, 2))(
        X, hA, hB)
    zero = torch.zeros_like(gX[..., :3])
    gz = torch.cat([zero, gX[..., 0:6], zero, gX[..., 6:12]], -1)
    f, hh = _scatter(ifs, gz, ghA, ghB, d.shape[0], d.shape[1])
    return -f, -hh


def _design_jvp_plain(ifs, d, cp, h, E, tcp, th):
    return torch.func.jvp(lambda c, hh: _value_grad_plain(ifs, d, c, hh,
                                                          E)[1],
                          (cp, h), (tcp, th))[1]


# ------------------------------------------------------------ K2 wrappers
_TABLES = ("RA00", "RA10", "RA01", "RB00", "RB10", "RB01")


def _check_inputs(ifs, d, cp, h, E, lam=None, th=None):
    I_, N, L = ifs.RA00.shape
    P, C = d.shape[0], d.shape[1]
    dev = d.device
    for name in _TABLES:
        _cuda.check(getattr(ifs, name), name, DTYPE, (I_, N, L), dev)
    for name in ("connA", "connB"):
        _cuda.check(getattr(ifs, name), name, INDEX_DTYPE, (I_, N, L), dev)
    for name in ("pairA", "pairB"):
        _cuda.check(getattr(ifs, name), name, INDEX_DTYPE, (I_,), dev)
    _cuda.check(ifs.w, "w", DTYPE, (I_, N), dev)
    _cuda.check(ifs.dxiA, "dxiA", DTYPE, (I_, N, 2), dev)
    _cuda.check(ifs.dxiB, "dxiB", DTYPE, (I_, N, 2), dev)
    _cuda.check(ifs.ad_scale, "ad_scale", DTYPE, (I_,), dev)
    _cuda.check(ifs.ar_scale, "ar_scale", DTYPE, (I_,), dev)
    _cuda.check(d, "d", DTYPE, (P, C, 3), dev)
    _cuda.check(cp, "cp", DTYPE, (P, C, 3), dev)
    _cuda.check(h, "h", DTYPE, (P, C), dev)
    _cuda.check(E, "E", DTYPE, (P,), dev)
    if lam is not None:
        _cuda.check(lam, "lam", DTYPE, (P, C, 3), dev)
    if th is not None:
        _cuda.check(th, "th", DTYPE, (P, C), dev)
    return I_, N, L, C


def _launch(mode, counter, ifs, d, cp, h, E, lam, out_w, out_f, out_h, dims,
            th=None):
    p = _cuda.ptr
    _cuda.launch(counter, "gf_penalty_qp", mode,
                 *(p(getattr(ifs, n)) for n in _TABLES),
                 p(ifs.connA), p(ifs.connB), p(ifs.pairA), p(ifs.pairB),
                 p(ifs.w), p(ifs.dxiA), p(ifs.dxiB), p(ifs.ad_scale),
                 p(ifs.ar_scale), p(d), p(cp), p(h), p(E), p(lam), p(th),
                 p(out_w), p(out_f), p(out_h), *dims)


def penalty_value_grad(ifs: InterfaceStack, d, cp, h, E):
    """K2 mode (a): (W_i (I,) per-interface energy, r_pen (P, C, 3),
    dW/dh (P, C))."""
    dims = _check_inputs(ifs, d, cp, h, E)
    if not _cuda.on_cuda(d):
        return _value_grad_plain(ifs, d, cp, h, E)
    Wq = torch.empty(dims[0], dims[1], dtype=DTYPE, device=d.device)
    r = torch.zeros_like(d)
    dh = torch.zeros_like(h)
    _launch(0, "penalty_qp/value_grad", ifs, d, cp, h, E, None, Wq, r, dh,
            dims)
    return Wq.sum(-1), r, dh


def penalty_hessians(ifs: InterfaceStack, d, cp, h, E):
    """K2 mode (b): per-qp jet Hessians (I, N, 18, 18)."""
    dims = _check_inputs(ifs, d, cp, h, E)
    if not _cuda.on_cuda(d):
        return _hessians_plain(ifs, d, cp, h, E)
    H = torch.empty(dims[0], dims[1], NZ, NZ, dtype=DTYPE, device=d.device)
    _launch(1, "penalty_qp/hess", ifs, d, cp, h, E, None, None, H, None,
            dims)
    return H


def penalty_adjoint(ifs: InterfaceStack, d, cp, h, E, lam):
    """K2 mode (c): -d/d(cp, h) of lam^T r_pen -> ((P, C, 3), (P, C))."""
    dims = _check_inputs(ifs, d, cp, h, E, lam)
    if not _cuda.on_cuda(d):
        return _adjoint_plain(ifs, d, cp, h, E, lam)
    dcp = torch.zeros_like(d)
    dh = torch.zeros_like(h)
    _launch(2, "penalty_qp/adjoint", ifs, d, cp, h, E, lam, None, dcp, dh,
            dims)
    return dcp, dh


def penalty_design_jvp(ifs: InterfaceStack, d, cp, h, E, tcp, th):
    """K2 mode (d): d/de r_pen(d; cp + e tcp, h + e th) (P, C, 3) at fixed
    d and fixed rows (tcp, th unmasked; the caller masks). The plain
    version is torch.func.jvp of mode (a)'s plain r in (cp, h)."""
    dims = _check_inputs(ifs, d, cp, h, E, tcp, th)
    if not _cuda.on_cuda(d):
        return _design_jvp_plain(ifs, d, cp, h, E, tcp, th)
    dr = torch.zeros_like(d)
    _launch(3, "penalty_qp/design_fwd", ifs, d, cp, h, E, tcp, None, dr,
            None, dims, th=th)
    return dr


# ------------------------------------------------------------ public API
def penalty_energy(ifs: InterfaceStack | None, d, cp, h_coef, E, nu=None):
    """Total coupling penalty energy (0-dim tensor)."""
    if ifs is None or ifs.n_interfaces == 0:
        return torch.zeros((), dtype=d.dtype, device=d.device)
    return penalty_value_grad(ifs, d, cp, h_coef, E)[0].sum()


def interface_hessians(ifs: InterfaceStack, d, cp, h_coef, E):
    """Per-qp coupling stiffness blocks (I, N, 6L, 6L) w.r.t. the stacked
    local vector [deA.ravel(), deB.ravel()] (for tests and diagnostics;
    the solver assembles from the jet Hessians directly)."""
    H = penalty_hessians(ifs, d, cp, h_coef, E)
    I_, N, L = ifs.RA00.shape
    H = H.reshape(I_, N, 6, 3, 6, 3)
    Rs = interface_rows(ifs)
    tmp = torch.einsum("injxky,inkm->injxmy", H, Rs)
    Ki = torch.einsum("injxmy,injl->inlxmy", tmp, Rs)
    return Ki.reshape(I_, N, 6 * L, 6 * L)


def interface_rows(ifs: InterfaceStack):
    """(I, N, 6, 2L) basis rows of the 18-jet over the stacked [A; B]
    locals (zero on the other side's half)."""
    RsA = torch.stack([ifs.RA00, ifs.RA10, ifs.RA01], dim=-2)
    RsB = torch.stack([ifs.RB00, ifs.RB10, ifs.RB01], dim=-2)
    return torch.cat([torch.cat([RsA, torch.zeros_like(RsA)], -1),
                      torch.cat([torch.zeros_like(RsB), RsB], -1)], -2)
