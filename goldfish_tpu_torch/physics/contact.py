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
  own-side 3x3 sums per qp through K3 as a one-jet group on the R00 rows.

Each runs K12 on CUDA tensors and its plain PyTorch version, the dense
(EQ, EQ) composition after the JAX formula, on CPU tensors.
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
    _index_add_nodes,
    _ref_area,
    gather,
)

__all__ = ["ContactPairs", "build_contact", "qp_field", "qp_scatter",
           "qp_weights", "contact_value_grad", "contact_hvp",
           "contact_hess", "contact_assemble", "contact_energy",
           "contact_value_force", "contact_adjoint"]


class ContactPairs(NamedTuple):
    """Patch pairs screened for contact; K pairs."""

    pa: torch.Tensor      # (K,) int32
    pb: torch.Tensor      # (K,) int32
    k_pen: torch.Tensor   # (K,) penalty stiffness (energy/(len^2 area^2))
    r_max: torch.Tensor   # (K,) interaction cutoff


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
    return W, G, U


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
    return Y, T


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


# ------------------------------------------------------------ K12
def _check(contact: ContactPairs, x, w, v=None):
    dev = x.device
    P, EQ = w.shape
    _cuda.check(x, "x", DTYPE, (P, EQ, 3), dev)
    _cuda.check(w, "w", DTYPE, (P, EQ), dev)
    if v is not None:
        _cuda.check(v, "v", DTYPE, (P, EQ, 3), dev)
    Kp = contact.pa.shape[0]
    for name in ("pa", "pb"):
        _cuda.check(getattr(contact, name), name, INDEX_DTYPE, (Kp,), dev)
    for name in ("k_pen", "r_max"):
        _cuda.check(getattr(contact, name), name, DTYPE, (Kp,), dev)
    return P, EQ, Kp


def _launch(mode, counter, contact, x, w, v, R, gi, free, vec, scal, S, K,
            active, E, Q, L, ndof):
    p = _cuda.ptr
    c = contact
    _cuda.launch(counter, "gf_contact_pairs", mode, p(x), p(w), p(v),
                 p(c.pa), p(c.pb), p(c.k_pen), p(c.r_max), p(R), p(gi),
                 p(free), p(vec), p(scal), p(S), p(K), p(active),
                 c.pa.shape[0], E, Q, L, ndof)


def contact_value_grad(contact: ContactPairs, x, w, active=None):
    """K12 mode 0: (W_c (0-dim), G = dW_c/dx (P, EQ, 3), U = dW_c/dw
    (P, EQ)) at qp positions x (P, EQ, 3) and weights w (P, EQ). W_c =
    1/2 sum w U. `active` (int32 (1,), CUDA only) counts the tiles the
    cutoff did not skip."""
    _check(contact, x, w)
    if not _cuda.on_cuda(x):
        return _value_grad_plain(contact, x, w)
    G, U = torch.zeros_like(x), torch.zeros_like(w)
    _launch(0, "contact_pairs/value_grad", contact, x, w, None, None, None,
            None, G, U, None, None, active, 1, w.shape[1], 1, 0)
    return 0.5 * (w * U).sum(), G, U


def contact_hvp(contact: ContactPairs, x, w, v):
    """K12 mode 1: (Y (P, EQ, 3), T (P, EQ)) for the qp field v: Y = the
    contact Hessian in x applied to v, T = d/dw of v . dW_c/dx."""
    _check(contact, x, w, v)
    if not _cuda.on_cuda(x):
        return _hvp_plain(contact, x, w, v)
    Y, T = torch.zeros_like(x), torch.zeros_like(w)
    _launch(1, "contact_pairs/hvp", contact, x, w, v, None, None, None, Y,
            T, None, None, None, 1, w.shape[1], 1, 0)
    return Y, T


def contact_hess(K, contact: ContactPairs, x, w, R, gi, free, active=None):
    """K12 mode 2: adds the cross quadrants -R_a^T H_ab R_b (and their
    transposes) of every element pair into K (N, N) in place, over free
    dofs; returns the own-side sums S (P, EQ, 3, 3). R: (P*E, Q, 1, L)
    R00 rows; gi: (P*E, 3L) int32 element dofs; free: (N,)."""
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
    S = torch.zeros(P, EQ, 3, 3, dtype=DTYPE, device=dev)
    _launch(2, "contact_pairs/hess", contact, x, w, None, R, gi, free, None,
            None, S, K, active, G // P, Q, L, N)
    return S


def contact_assemble(K, contact: ContactPairs, x, w, R, gi, free):
    """K_c into the dense K in place: K12's cross quadrants, then the
    own-side sums through K3 (nj = 1 on the R00 rows R)."""
    from goldfish_tpu_torch.solver.system import jet_assemble

    G, Q, _, _ = R.shape
    S = contact_hess(K, contact, x, w, R, gi, free)
    jet_assemble(K, S.reshape(G, Q, 3, 3), R, gi, free)
    return K


# ------------------------------------------------------------ system terms
def contact_qps(stack: PatchStack, d, cp):
    """(x, w): deformed qp positions X + u and weights, as the JAX
    package's contact_energy forms them."""
    return qp_field(stack, cp) + qp_field(stack, d), qp_weights(stack, cp)


class _ContactEnergy(torch.autograd.Function):
    """W_c from K12 mode 0; its gradient in (x, w) from the same launch."""

    @staticmethod
    def forward(ctx, x, w, contact):
        W, G, U = contact_value_grad(contact, x.detach().contiguous(),
                                     w.detach().contiguous())
        ctx.save_for_backward(G, U)
        return W

    @staticmethod
    def backward(ctx, g):
        G, U = ctx.saved_tensors
        return g * G, g * U, None


def contact_energy(contact: ContactPairs | None, stack: PatchStack, d, cp):
    """Total contact potential (0-dim), differentiable in d and cp."""
    if contact is None:
        return torch.zeros((), dtype=d.dtype, device=d.device)
    x, w = contact_qps(stack, d, cp)
    return _ContactEnergy.apply(x, w, contact)


def contact_value_force(contact: ContactPairs, stack: PatchStack, d, cp):
    """(W_c, dW_c/dd (P, C, 3)) from one K12 value_grad launch."""
    x, w = contact_qps(stack, d, cp)
    W, G, _ = contact_value_grad(contact, x, w)
    return W, qp_scatter(stack, G, cp.shape[1])


def contact_adjoint(contact: ContactPairs, stack: PatchStack, d, cp, lam):
    """-lam^T d r_c / dcp (P, C, 3), r_c = dW_c/dd: through x it is K_c lam
    (x depends on cp as on d), through w the cp pullback of T (K12 hvp
    with v = lam), by autograd on the plain weights."""
    x, w = contact_qps(stack, d, cp)
    Y, T = contact_hvp(contact, x, w, qp_field(stack, lam))
    with torch.enable_grad():
        cpv = cp.detach().requires_grad_(True)
        gw = torch.autograd.grad((qp_weights(stack, cpv) * T).sum(), cpv)[0]
    return -(qp_scatter(stack, Y, cp.shape[1]) + gw)
