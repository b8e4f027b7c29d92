"""Shell-shell contact as a differentiable pair potential.

Port of goldfish_tpu/physics/contact.py. For each screened patch pair
(A, B) the contact potential is a double sum over the deformed quadrature
points of both patches,

    W_c = sum_{a in A, b in B} phi(|x_a - x_b|) w_a w_b,
    phi(r) = k/6 (r_max - r)^3   for r < r_max, else 0,

with x = (cp + d) on the R00 rows and w = |X_u x X_v| wq (0 on padded
qps). The qp inputs are plain torch contractions on the stack's rows (as
the dead load's); the pair sums are kernel K12 `contact_pairs`
(csrc/contact_pairs.cu), in closed form per qp pair:

- `contact_value_grad`: W_c, the per-qp forces dW_c/dx and U = dW_c/dw;
- `contact_hvp`: the per-qp K_c v for a qp field v, and T, the w-cotangent
  of v . dW_c/dx (the adjoint's cp pullback through the weights);
- `contact_assemble`: K_c into a dense K: the cross quadrants by K12, the
  own-side 3x3 sums per qp through K3 as a one-jet group on the R00 rows;
- `contact_force_jvp`: the per-qp force's tangent along a design change
  (dx, dw) of the qp positions and weights (`contact_design_jvp`, the
  residual's forward tangent in cp).

On the card each first lists the cell pairs that may hold a qp pair within
r_max (`contact_cells`: K12's cull; cells of `q` consecutive qps, 16 by
default, an element's Q where the package calls them) and then works on
that list only; a caller whose (x, w) stay fixed over many calls (the
tangent's K_c v in every sweep of one Newton step, `system.jet_hessians`)
builds the list once and passes it as `cells`.
Each runs K12 on CUDA tensors and its plain PyTorch version, the dense
(EQ, EQ) composition after the JAX formula, on CPU tensors;
`candidate_pairs` is the cull's plain twin.
`contact_energy` is differentiable in (d, cp) by autograd, through K12's
value_grad mode.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.geometry.patch_stack import PatchStack
from goldfish_tpu_torch.physics.kl_shell import (
    _cross,
    _dot,
    _index_add_nodes,
    _ref_area,
    gather,
)

__all__ = ["ContactPairs", "ContactCells", "build_contact", "qp_field",
           "qp_scatter", "qp_weights", "contact_cells", "candidate_pairs",
           "energy_plain", "contact_value_grad", "contact_hvp",
           "contact_force_jvp", "qp_weights_jvp", "contact_design_jvp",
           "contact_hess", "contact_assemble", "contact_energy",
           "contact_value_force", "contact_adjoint"]


class ContactPairs(NamedTuple):
    """Patch pairs screened for contact; K pairs."""

    pa: torch.Tensor      # (K,) int32
    pb: torch.Tensor      # (K,) int32
    k_pen: torch.Tensor   # (K,) penalty stiffness (energy/(len^2 area^2))
    r_max: torch.Tensor   # (K,) interaction cutoff


class ContactCells(NamedTuple):
    """Cell pairs that may hold a qp pair within r_max (`contact_cells`):
    pair (k, a, b), cell a of patch pa[k] with cell b of patch pb[k], is
    listed as (k ncell + a) ncell + b, ncell = ceil(EQ / cell)."""

    index: torch.Tensor   # (capacity,) int32: the first `count` are listed
    count: torch.Tensor   # (1,) int32, on the device that holds the list
    cell: int             # qps per cell


def build_contact(pairs, k_pen, r_max, device=None) -> ContactPairs:
    """pairs: [(pa, pb), ...]; k_pen, r_max scalars or per pair."""
    device = as_device(device)
    K = len(pairs)
    return ContactPairs(
        pa=tensor([p[0] for p in pairs], device, INDEX_DTYPE),
        pb=tensor([p[1] for p in pairs], device, INDEX_DTYPE),
        k_pen=tensor(np.broadcast_to(np.asarray(k_pen, dtype=np.float64),
                                     (K,)), device),
        r_max=tensor(np.broadcast_to(np.asarray(r_max, dtype=np.float64),
                                     (K,)), device))


# ------------------------------------------------------------ qp inputs
def qp_field(stack: PatchStack, coef):
    """(P, C, 3) field -> its values (P, E*Q, 3) at the qps (R00 rows)."""
    P = coef.shape[0]
    return torch.einsum("peql,pelk->peqk", stack.R00,
                        gather(coef, stack.conn)).reshape(P, -1, 3)


def qp_scatter(stack: PatchStack, y, C: int):
    """R00^T y: per-qp vectors (P, E*Q, 3) -> (P, C, 3)."""
    P, E, Q, _ = stack.R00.shape
    contrib = torch.einsum("peql,peqk->pelk", stack.R00,
                           y.reshape(P, E, Q, 3))
    return _index_add_nodes(stack.conn, contrib, P, C)


def qp_weights(stack: PatchStack, cp):
    """w = |X_u x X_v| wq at the qps: (P, E*Q), 0 on padded qps."""
    return _ref_area(stack, cp).reshape(cp.shape[0], -1)


# ------------------------------------------------------------ plain versions
_CHUNK = 1 << 22   # qp pairs per block of the plain versions (memory)


def _pairs(contact: ContactPairs, x, w, align=1):
    """The JAX formula's dense terms, per pair k and block [a0, a1) of A's
    qps (a multiple of `align` long): (A, B, a0, a1, dx (n, EQ, 3), r, phi,
    phi', phi'', w_a w_b)."""
    EQ = w.shape[1]
    step = max(align, (_CHUNK // EQ) // align * align)
    pa, pb = contact.pa.tolist(), contact.pb.tolist()
    for k, (A, B) in enumerate(zip(pa, pb)):
        kk, rm = contact.k_pen[k], contact.r_max[k]
        for a0 in range(0, EQ, step):
            a1 = min(EQ, a0 + step)
            dx = x[A, a0:a1, None, :] - x[B][None, :, :]
            r = torch.sqrt((dx * dx).sum(-1) + 1e-30)
            gap = torch.clamp(rm - r, min=0.0)
            yield (A, B, a0, a1, dx, r, (kk / 6.0) * gap * gap * gap,
                   -0.5 * kk * gap * gap, kk * gap,
                   w[A, a0:a1, None] * w[B][None, :])


def energy_plain(contact, x, w):
    """W_c at qp positions x (P, EQ, 3) and weights w (P, EQ) by the dense
    JAX formula alone: differentiable (twice) by autograd and torch.func
    in x and w (the design tangent of `operations.disp_imop`)."""
    W = torch.zeros((), dtype=x.dtype, device=x.device)
    for *_, phi, _, _, ww in _pairs(contact, x, w):
        W = W + (phi * ww).sum()
    return W


def _value_grad_plain(contact, x, w):
    W = torch.zeros((), dtype=x.dtype, device=x.device)
    G, U = torch.zeros_like(x), torch.zeros_like(w)
    for A, B, a0, a1, dx, r, phi, dphi, _, ww in _pairs(contact, x, w):
        W = W + (phi * ww).sum()
        g = (ww * dphi / r)[..., None] * dx
        G[A, a0:a1] += g.sum(1)
        G[B] -= g.sum(0)
        U[A, a0:a1] += (phi * w[B][None, :]).sum(1)
        U[B] += (phi * w[A, a0:a1, None]).sum(0)
    # as K12, which skips a pair with a zero weight: U = dW_c/dw is 0 on
    # padded qps, whose weight has no tangent (wq = 0)
    return W, G, U * (w != 0)


def _hvp_plain(contact, x, w, v):
    Y, T = torch.zeros_like(x), torch.zeros_like(w)
    for A, B, a0, a1, dx, r, _, dphi, ddphi, ww in _pairs(contact, x, w):
        rh = dx / r[..., None]
        dv = v[A, a0:a1, None, :] - v[B][None, :, :]
        s = (rh * dv).sum(-1)
        y = ww[..., None] * ((ddphi * s)[..., None] * rh
                             + (dphi / r)[..., None] * (dv - s[..., None]
                                                        * rh))
        Y[A, a0:a1] += y.sum(1)
        Y[B] -= y.sum(0)
        T[A, a0:a1] += (dphi * s * w[B][None, :]).sum(1)
        T[B] += (dphi * s * w[A, a0:a1, None]).sum(0)
    return Y, T * (w != 0)


def _design_jvp_plain(contact, x, w, v, dw):
    """The force's tangent along (dx, dw) = (v, dw): H_x v plus the weights'
    part, sum_b (dw_a w_b + w_a dw_b) phi' rhat."""
    Y = torch.zeros_like(x)
    for A, B, a0, a1, dx, r, _, dphi, ddphi, ww in _pairs(contact, x, w):
        rh = dx / r[..., None]
        dv = v[A, a0:a1, None, :] - v[B][None, :, :]
        s = (rh * dv).sum(-1)
        t = dphi / r
        dww = (dw[A, a0:a1, None] * w[B][None, :]
               + w[A, a0:a1, None] * dw[B][None, :]) * (ww != 0)
        y = ww[..., None] * ((ddphi * s)[..., None] * rh
                             + t[..., None] * (dv - s[..., None] * rh)) \
            + (dww * t)[..., None] * dx
        Y[A, a0:a1] += y.sum(1)
        Y[B] -= y.sum(0)
    return Y


def _hess_plain(K, contact, x, w, R, gi, free):
    """The closed-form block H_ab = d^2 W / dx_a^2 of every qp pair (a qp
    with itself left out of a self pair: its potential is constant), its
    own-side sums S and the cross quadrants -R_a^T H_ab R_b into K."""
    P = x.shape[0]
    G, Q, _, L = R.shape
    E = G // P
    S = torch.zeros(P, E * Q, 3, 3, dtype=x.dtype, device=x.device)
    gl = gi.long().reshape(P, E, L * 3)
    Rp = R.reshape(P, E, Q, L)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    for A, B, a0, a1, dx, r, _, dphi, ddphi, ww in _pairs(contact, x, w,
                                                          align=Q):
        rh = dx / r[..., None]
        t = dphi / r
        H = ww[..., None, None] * (
            (ddphi - t)[..., None, None] * rh[..., :, None] * rh[..., None, :]
            + t[..., None, None] * eye)
        if A == B:
            i = torch.arange(a1 - a0, device=x.device)
            H[i, a0 + i] = 0.0
        S[A, a0:a1] += H.sum(1)
        S[B] += H.sum(0)
        e0, e1 = a0 // Q, a1 // Q
        blk = -torch.einsum("aql,aqbsxy,bsm->alxbmy", Rp[A, e0:e1],
                            H.reshape(e1 - e0, Q, E, Q, 3, 3),
                            Rp[B]).reshape(e1 - e0, 3 * L, E, 3 * L)
        rows = gl[A, e0:e1, :, None, None].expand_as(blk)
        cols = gl[B][None, None, :, :].expand_as(blk)
        blk = blk * free[rows] * free[cols]
        K.index_put_((rows, cols), blk, accumulate=True)
        K.index_put_((cols, rows), blk, accumulate=True)
    return S


# ------------------------------------------------------------ the cull
CELL = 16   # qps per cell of the cull where the caller names none


def _cells_of(EQ, q):
    nc = CELL if q is None else int(q)
    if nc <= 0:
        raise ValueError(f"cell size {nc}: must be positive")
    return nc, -(-EQ // nc)


def candidate_pairs(contact: ContactPairs, x, w, q=None):
    """The cull's plain twin: the sorted (k ncell + a) ncell + b (int64) of
    every cell pair (cells of `q` consecutive qps, default CELL) that the
    box rule of K12 keeps: both cells have a nonzero weight and their
    bounding boxes lie at most r_max apart (squared gap summed as (g0^2 +
    g1^2) + g2^2 against r_max^2 (1 + 1e-12), every product and sum
    rounded)."""
    P, EQ = w.shape
    nc, ncell = _cells_of(EQ, q)
    pad = ncell * nc - EQ
    xc = torch.cat([x, x[:, -1:].expand(P, pad, 3)], 1).reshape(
        P, ncell, nc, 3)
    wc = torch.cat([w, w.new_zeros(P, pad)], 1).reshape(P, ncell, nc)
    lo, hi, live = xc.amin(2), xc.amax(2), (wc != 0).any(2)
    out = []
    for k, (A, B) in enumerate(zip(contact.pa.tolist(),
                                   contact.pb.tolist())):
        g = torch.clamp(torch.maximum(lo[B][None] - hi[A][:, None],
                                      lo[A][:, None] - hi[B][None]), min=0.0)
        s = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) \
            + g[..., 2] * g[..., 2]
        rm = float(contact.r_max[k])
        keep = live[A][:, None] & live[B][None, :] \
            & ~(s > rm * rm * (1.0 + 1e-12))
        a, b = keep.nonzero(as_tuple=True)
        out.append((k * ncell + a) * ncell + b)
    return torch.sort(torch.cat(out)).values if out else \
        torch.zeros(0, dtype=torch.int64, device=x.device)


def contact_cells(contact: ContactPairs, x, w, q=None) -> ContactCells:
    """K12's cull at qp positions x (P, EQ, 3) and weights w (P, EQ): the
    cell pairs (cells of `q` consecutive qps, default CELL; elements
    where q is an element's Q) that may hold a qp pair within r_max, as a
    device list whose length stays on the device. On CPU tensors:
    `candidate_pairs`."""
    P, EQ, Kp = _check(contact, x, w)
    nc, ncell = _cells_of(EQ, q)
    if not _cuda.on_cuda(x):
        idx = candidate_pairs(contact, x, w, nc).to(INDEX_DTYPE)
        return ContactCells(idx, torch.tensor([idx.numel()],
                                              dtype=INDEX_DTYPE), nc)
    total = Kp * ncell * ncell
    if total >= 2 ** 31:
        raise ValueError(f"{total} cell pairs: the list's int32 index "
                         f"overflows; use larger cells")
    box = torch.empty(P * ncell * 6, dtype=DTYPE, device=x.device)
    ibuf = torch.empty(1 + P * ncell + total, dtype=INDEX_DTYPE,
                       device=x.device)
    count, flag, index = ibuf[:1], ibuf[1:1 + P * ncell], ibuf[1 + P * ncell:]
    p, c = _cuda.ptr, contact
    _cuda.launch("contact_pairs/cull", "gf_contact_cull", p(x), p(w),
                 p(c.pa), p(c.pb), p(c.r_max), p(box), p(flag), p(index),
                 p(count), Kp, P, EQ, nc)
    return ContactCells(index, count, nc)


# ------------------------------------------------------------ K12
def _check(contact: ContactPairs, x, w, v=None, dw=None):
    dev = x.device
    P, EQ = w.shape
    _cuda.check(x, "x", DTYPE, (P, EQ, 3), dev)
    _cuda.check(w, "w", DTYPE, (P, EQ), dev)
    if v is not None:
        _cuda.check(v, "v", DTYPE, (P, EQ, 3), dev)
    if dw is not None:
        _cuda.check(dw, "dw", DTYPE, (P, EQ), dev)
    Kp = contact.pa.shape[0]
    for name in ("pa", "pb"):
        _cuda.check(getattr(contact, name), name, INDEX_DTYPE, (Kp,), dev)
    for name in ("k_pen", "r_max"):
        _cuda.check(getattr(contact, name), name, DTYPE, (Kp,), dev)
    return P, EQ, Kp


def _list_of(contact, x, w, cells, q=None):
    """`cells`, checked, or the cull's list at (x, w)."""
    if cells is None:
        return contact_cells(contact, x, w, q)
    for name in ("index", "count"):
        _cuda.check(getattr(cells, name), f"cells.{name}", INDEX_DTYPE,
                    None, x.device)
    if q is not None and int(cells.cell) != q:
        raise ValueError(f"cells of {cells.cell} qps, expected {q}")
    return cells


def _launch(mode, counter, contact, x, w, v, R, gi, free, vec, scal, S, K,
            cells, active, L, ndof, dw=None):
    p = _cuda.ptr
    c = contact
    EQ = w.shape[1]
    nc = int(cells.cell)
    _cuda.launch(counter, "gf_contact_pairs", mode, p(x), p(w), p(v), p(dw),
                 p(c.pa), p(c.pb), p(c.k_pen), p(c.r_max), p(R), p(gi),
                 p(free), p(vec), p(scal), p(S), p(K), p(cells.index),
                 p(cells.count), p(active), c.pa.shape[0], -(-EQ // nc), nc,
                 EQ, L, ndof)


def contact_value_grad(contact: ContactPairs, x, w, active=None,
                       cells=None, q=None):
    """K12 mode 0: (W_c (0-dim), G = dW_c/dx (P, EQ, 3), U = dW_c/dw
    (P, EQ)) at qp positions x (P, EQ, 3) and weights w (P, EQ). W_c =
    1/2 sum w U. `cells`: `contact_cells` of these x, w, built here (cells
    of q qps) when None. `active` (int32 (1,), CUDA only) gains the number
    of cell pairs that ran."""
    _check(contact, x, w)
    if not _cuda.on_cuda(x):
        return _value_grad_plain(contact, x, w)
    cells = _list_of(contact, x, w, cells, q)
    G, U = torch.zeros_like(x), torch.zeros_like(w)
    _launch(0, "contact_pairs/value_grad", contact, x, w, None, None, None,
            None, G, U, None, None, cells, active, 0, 0)
    return 0.5 * (w * U).sum(), G, U


def contact_hvp(contact: ContactPairs, x, w, v, cells=None, q=None):
    """K12 mode 1: (Y (P, EQ, 3), T (P, EQ)) for the qp field v: Y = the
    contact Hessian in x applied to v, T = d/dw of v . dW_c/dx. `cells`,
    `q` as for `contact_value_grad`."""
    _check(contact, x, w, v)
    if not _cuda.on_cuda(x):
        return _hvp_plain(contact, x, w, v)
    cells = _list_of(contact, x, w, cells, q)
    Y, T = torch.zeros_like(x), torch.zeros_like(w)
    _launch(1, "contact_pairs/hvp", contact, x, w, v, None, None, None, Y,
            T, None, None, cells, None, 0, 0)
    return Y, T


def contact_force_jvp(contact: ContactPairs, x, w, v, dw, cells=None,
                      q=None):
    """K12 mode 3: the tangent (P, EQ, 3) of the per-qp force G = dW_c/dx
    along a change (v, dw) of the qp positions x and weights w: H_x v +
    (dG/dw) dw. `cells`, `q` as for `contact_value_grad` (the list depends
    on x only)."""
    _check(contact, x, w, v, dw)
    if not _cuda.on_cuda(x):
        return _design_jvp_plain(contact, x, w, v, dw)
    cells = _list_of(contact, x, w, cells, q)
    Y = torch.zeros_like(x)
    _launch(3, "contact_pairs/design_fwd", contact, x, w, v, None, None,
            None, Y, None, None, None, cells, None, 0, 0, dw=dw)
    return Y


def contact_hess(K, contact: ContactPairs, x, w, R, gi, free, active=None,
                 cells=None):
    """K12 mode 2: adds the cross quadrants -R_a^T H_ab R_b (and their
    transposes) of every element pair into K (N, N) in place, over free
    dofs; returns the own-side sums S (P, EQ, 3, 3). R: (P*E, Q, 1, L)
    R00 rows; gi: (P*E, 3L) int32 element dofs; free: (N,). `cells`:
    `contact_cells(contact, x, w, Q)` (cells are elements), built here
    when None; `active` as for `contact_value_grad`."""
    P, EQ, _ = _check(contact, x, w)
    G, Q, nj, L = R.shape
    dev = x.device
    N = free.shape[0]
    _cuda.check(R, "R", DTYPE, (G, Q, 1, L), dev)
    _cuda.check(gi, "gi", INDEX_DTYPE, (G, 3 * L), dev)
    _cuda.check(free, "free", DTYPE, (N,), dev)
    _cuda.check(K, "K", DTYPE, (N, N), dev)
    if G * Q != P * EQ:
        raise ValueError(f"R: {G} x {Q} qps, x has {P} x {EQ}")
    if not _cuda.on_cuda(x):
        return _hess_plain(K, contact, x, w, R, gi, free)
    cells = _list_of(contact, x, w, cells, Q)
    S = torch.zeros(P, EQ, 3, 3, dtype=DTYPE, device=dev)
    _launch(2, "contact_pairs/hess", contact, x, w, None, R, gi, free, None,
            None, S, K, cells, active, L, N)
    return S


def contact_assemble(K, contact: ContactPairs, x, w, R, gi, free,
                     cells=None):
    """K_c into the dense K in place: K12's cross quadrants, then the
    own-side sums through K3 (nj = 1 on the R00 rows R); `cells` as for
    `contact_hess`."""
    from goldfish_tpu_torch.solver.system import jet_assemble

    G, Q, _, _ = R.shape
    S = contact_hess(K, contact, x, w, R, gi, free, cells=cells)
    jet_assemble(K, S.reshape(G, Q, 3, 3), R, gi, free)
    return K


# ------------------------------------------------------------ system terms
def contact_qps(stack: PatchStack, d, cp):
    """(x, w): deformed qp positions X + u and weights, as the JAX
    package's contact_energy forms them."""
    return qp_field(stack, cp) + qp_field(stack, d), qp_weights(stack, cp)


class _ContactEnergy(torch.autograd.Function):
    """W_c from K12 mode 0 (cells of q qps: the stack's elements); its
    gradient in (x, w) from the same launch."""

    @staticmethod
    def forward(ctx, x, w, contact, q):
        W, G, U = contact_value_grad(contact, x.detach().contiguous(),
                                     w.detach().contiguous(), q=q)
        ctx.save_for_backward(G, U)
        return W

    @staticmethod
    def backward(ctx, g):
        G, U = ctx.saved_tensors
        return g * G, g * U, None, None


def contact_energy(contact: ContactPairs | None, stack: PatchStack, d, cp):
    """Total contact potential (0-dim), differentiable in d and cp."""
    if contact is None:
        return torch.zeros((), dtype=d.dtype, device=d.device)
    x, w = contact_qps(stack, d, cp)
    return _ContactEnergy.apply(x, w, contact, stack.R00.shape[2])


def contact_value_force(contact: ContactPairs, stack: PatchStack, d, cp):
    """(W_c, dW_c/dd (P, C, 3)) from one K12 value_grad launch."""
    x, w = contact_qps(stack, d, cp)
    W, G, _ = contact_value_grad(contact, x, w, q=stack.R00.shape[2])
    return W, qp_scatter(stack, G, cp.shape[1])


def contact_adjoint(contact: ContactPairs, stack: PatchStack, d, cp, lam):
    """-lam^T d r_c / dcp (P, C, 3), r_c = dW_c/dd: through x it is K_c lam
    (x depends on cp as on d), through w the cp pullback of T (K12 hvp
    with v = lam), by autograd on the plain weights."""
    x, w = contact_qps(stack, d, cp)
    Y, T = contact_hvp(contact, x, w, qp_field(stack, lam),
                       q=stack.R00.shape[2])
    with torch.enable_grad():
        cpv = cp.detach().requires_grad_(True)
        gw = torch.autograd.grad((qp_weights(stack, cpv) * T).sum(), cpv)[0]
    return -(qp_scatter(stack, Y, cp.shape[1]) + gw)


def qp_weights_jvp(stack: PatchStack, cp, tcp):
    """The tangent of `qp_weights` along tcp (P, E*Q), in closed form:
    dw = n . (dX_u x X_v + X_u x dX_v) wq with n = A3 / |A3|; 0 where
    |A3| = 0 (no division there)."""
    ce, te = gather(cp, stack.conn), gather(tcp, stack.conn)
    Xu = torch.einsum("peql,pelk->peqk", stack.R10, ce)
    Xv = torch.einsum("peql,pelk->peqk", stack.R01, ce)
    dXu = torch.einsum("peql,pelk->peqk", stack.R10, te)
    dXv = torch.einsum("peql,pelk->peqk", stack.R01, te)
    A3 = _cross(Xu, Xv)
    dA3 = _cross(dXu, Xv) + _cross(Xu, dXv)
    nrm = torch.sqrt(_dot(A3, A3))
    live = nrm > 0.0
    dn = torch.where(live, _dot(A3, dA3)
                     / torch.where(live, nrm, torch.ones_like(nrm)), 0.0)
    return (dn * stack.wq).reshape(cp.shape[0], -1)


def contact_design_jvp(contact: ContactPairs, stack: PatchStack, d, cp,
                       tcp):
    """d/de r_c(d; cp + e tcp) (P, C, 3), r_c = dW_c/dd (tcp unmasked; the
    caller masks): x = X + u moves by dx = the qp values of tcp and the
    weights by `qp_weights_jvp`; K12 mode 3 gives the per-qp force's
    tangent on CUDA tensors (its plain version on CPU tensors), scattered
    back by R00^T."""
    x, w = contact_qps(stack, d, cp)
    Y = contact_force_jvp(contact, x, w, qp_field(stack, tcp),
                          qp_weights_jvp(stack, cp, tcp),
                          q=stack.R00.shape[2])
    return qp_scatter(stack, Y, cp.shape[1])
