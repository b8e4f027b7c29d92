"""Matrix-free Newton-Krylov path for large patch counts.

Port of goldfish_tpu/solver/krylov.py. The dense tangent of
solver/system.py is O((P*C*3)^2) memory; this path never assembles it:

  - the exact product K(d) v is kernel K4 (`jet_matvec`) on the jet
    Hessians of K1/K2 mode (b), computed once per state;
  - three preconditioners: the reference's coloured multiplicative
    pair-Schwarz sweep (`PairSchwarz`): one dense (6C, 6C) block per
    interface pair, built straight from the jet Hessians by kernel K10
    (`pair_assemble`, csrc/pair_assemble.cu), Jacobi-equilibrated and
    factored by a batched f64 LU; the per-patch block-Jacobi one
    (`patch_block_precond`), K10 with another destination list; and the
    dense one (`full_precond`), K3 into K and an f64 LU. Only the dense one
    converges on wings and box wings (see `PairSchwarz`), so it is the
    solve function's default;
  - restarted GMRES (`gmres_solve`, left-preconditioned like
    `jax.scipy.sparse.linalg.gmres(solve_method="batched")`) with outer
    iterative refinement against the exact K(d) v;
  - damped Newton (`newton_krylov_solve`) with GMRES directions and the
    residual-bounded Armijo line search, as a host loop;
  - `build_solve_fn_krylov`: the differentiable solve, a
    `torch.autograd.Function` whose backward solves K lam = g by GMRES and
    applies the residual VJP (K1/K2 mode c).

Where the reference factored in f32 (the TPU has no batched f64 LU), the
port factors in f64: GMRES iteration counts differ from the JAX package's,
the solutions agree to the solver tolerances. GMRES reads the host once
per restart cycle (its stop tests); the Arnoldi steps run without a host
round trip.

Contact (`SystemData.contact`) has no Krylov route in the JAX package's
tests and none here: every entry point raises on it (ROADMAP Queue B).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, tensor
from goldfish_tpu_torch.solver.system import (
    SystemData,
    assemble_K_from,
    jet_hessians,
    jet_tables,
    potential_and_residual,
    residual_vjp,
    tangent_matvec_from,
)

__all__ = ["SlotTable", "pair_assemble", "assemble_blocks", "PairSchwarz",
           "patch_block_precond", "full_precond", "gmres", "gmres_solve",
           "NewtonKrylovFailure", "newton_krylov_solve",
           "build_solve_fn_krylov"]

_EPS = float(np.finfo(np.float64).eps)


# ------------------------------------------------------------ K10
class SlotTable(NamedTuple):
    """Destination slots of one group type (elements or interface qps) for
    kernel K10, in CSR form over the groups: group g writes to slots
    ptr[g] .. ptr[g+1]-1; slot s adds the group's B^T H B to block
    block[s] through its row map rowmap[s] (local dof -> block-local dof,
    -1 = skip). `group` repeats each slot's group (the plain version's
    gather index)."""

    ptr: torch.Tensor      # (G + 1,) int32
    block: torch.Tensor    # (S,) int32
    rowmap: torch.Tensor   # (S, 3 nloc) int32
    group: torch.Tensor    # (S,) int64


def _slot_table(chunks, n_groups, n3, device):
    """SlotTable from chunks (groups (n,), block, maps (n, n3)): the slots
    sorted by group, in chunk order within a group."""
    if chunks:
        g = np.concatenate([c[0] for c in chunks])
        b = np.concatenate([np.full(len(c[0]), c[1]) for c in chunks])
        m = np.concatenate([c[2] for c in chunks])
    else:
        g = np.zeros(0, np.int64)
        b = np.zeros(0, np.int64)
        m = np.zeros((0, n3), np.int64)
    order = np.argsort(g, kind="stable")
    g, b, m = g[order], b[order], m[order]
    ptr = np.searchsorted(g, np.arange(n_groups + 1))
    return SlotTable(ptr=tensor(ptr, device, INDEX_DTYPE),
                     block=tensor(b, device, INDEX_DTYPE),
                     rowmap=tensor(m.reshape(-1, n3), device, INDEX_DTYPE),
                     group=tensor(g, device, torch.int64))


def _check_pair_args(out, H, R, table):
    G, nq, nj, nloc = R.shape
    dev = H.device
    nz = 3 * nj
    _cuda.check(H, "H", DTYPE, (G, nq, nz, nz), dev)
    _cuda.check(R, "R", DTYPE, (G, nq, nj, nloc), dev)
    _cuda.check(out, "out", DTYPE, None, dev)
    if out.dim() != 3 or out.shape[1] != out.shape[2]:
        raise ValueError(f"out: shape {tuple(out.shape)}, expected (B, nb, "
                         "nb)")
    if not out.is_contiguous():
        raise ValueError("out: must be contiguous")
    _cuda.check(table.ptr, "ptr", INDEX_DTYPE, (G + 1,), dev)
    S = table.block.shape[0]
    _cuda.check(table.block, "block", INDEX_DTYPE, (S,), dev)
    _cuda.check(table.rowmap, "rowmap", INDEX_DTYPE, (S, 3 * nloc), dev)
    return G, nq, nj, nloc


def _pair_assemble_plain(out, H, R, table, chunk=4096):
    """index_put_(accumulate=True) version of K10, in chunks of slots."""
    G, nq, nj, nloc = R.shape
    nb = out.shape[1]
    flat_out = out.view(-1)
    S = table.block.shape[0]
    for s0 in range(0, S, chunk):
        sl = slice(s0, min(S, s0 + chunk))
        grp = table.group[sl]
        ug, inv = torch.unique(grp, return_inverse=True)
        Hr = H[ug].reshape(-1, nq, nj, 3, nj, 3)
        Rg = R[ug]
        tmp = torch.einsum("gqjxky,gqkm->gqjxmy", Hr, Rg)
        Kg = torch.einsum("gqjxmy,gqjl->glxmy", tmp, Rg).reshape(
            -1, 3 * nloc, 3 * nloc)[inv]
        mp = table.rowmap[sl].long()
        blk = table.block[sl].long()
        ok = (mp[:, :, None] >= 0) & (mp[:, None, :] >= 0)
        idx = (blk[:, None, None] * nb + mp[:, :, None]) * nb \
            + mp[:, None, :]
        flat_out.index_put_((idx[ok],), Kg[ok], accumulate=True)


def pair_assemble(out, H, R, table: SlotTable, counter="pair_assemble/pairs"):
    """K10: out[block[s]][map_s, map_s] += sum_q B_q^T H_q B_q for every slot
    s of every group (in place). out: (B, nb, nb); H: (G, nq, 3nj, 3nj);
    R: (G, nq, nj, nloc); `counter` names the launch (pairs or patches)."""
    G, nq, nj, nloc = _check_pair_args(out, H, R, table)
    if not _cuda.on_cuda(H):
        _pair_assemble_plain(out, H, R, table)
        return out
    p = _cuda.ptr
    _cuda.launch(counter, "gf_pair_assemble", p(H), p(R), p(table.ptr),
                 p(table.block), p(table.rowmap), p(out), G, nq, nj, nloc,
                 out.shape[1])
    return out


class BlockTables(NamedTuple):
    """K10's destination lists for one set of blocks: slots of the element
    groups (shell and, with a follower pressure, pressure Hessians share
    them), of the interface groups (None without interfaces), the block
    count and size, and each block's free mask (B, nb)."""

    elem: SlotTable
    iface: SlotTable | None
    n_blocks: int
    nb: int
    free: torch.Tensor


def _local_maps(conn, free_p):
    """(n, L) local CP indices and the patch's (C, 3) free mask -> (n, 3L)
    within-patch dofs, -1 where the dof is not free."""
    dof = conn[..., None] * 3 + np.arange(3)
    ok = free_p.reshape(-1)[dof] > 0
    return np.where(ok, dof, -1).reshape(conn.shape[0], -1)


def _no_contact(data: SystemData):
    if data.contact is not None:
        raise NotImplementedError(
            "contact on the Newton-Krylov route is not ported yet (ROADMAP "
            "Queue B); use the persistent-factor solves of solver/implicit")


def _block_tables(data: SystemData, blocks_of_patch, n_blocks, nb,
                  whole=None, patches=None):
    """BlockTables on the data's device. `blocks_of_patch[p]` lists the
    (block, offset) pairs that patch p's dofs land in (at offset + its
    within-patch dof); `whole[i]` (pairs only) is interface i's own block,
    which takes its qps' full 6L x 6L Hessian, every other block of a side
    only that side's quadrant. `patches` restricts the element groups to
    those patches."""
    _no_contact(data)
    stack, ifs = data.stack, data.ifs
    P, E, Q, L = stack.R00.shape
    C = stack.max_cp
    conn = stack.conn.cpu().numpy().astype(np.int64)
    real_e = stack.wq.cpu().numpy().sum(-1) > 0          # (P, E)
    free = data.free.cpu().numpy()                         # (P, C, 3)
    dev = data.free.device
    chunks = []
    for p in (range(P) if patches is None else patches):
        es = np.nonzero(real_e[p])[0]
        if len(es) == 0:
            continue
        m = _local_maps(conn[p, es], free[p])
        for blk, off in blocks_of_patch[p]:
            chunks.append((p * E + es, blk, np.where(m >= 0, m + off, -1)))
    elem = _slot_table(chunks, P * E, 3 * L, dev)
    iface = None
    if ifs is not None and patches is None:
        I_, Nq, Li = ifs.RA00.shape
        pa = ifs.pairA.cpu().numpy()
        pb = ifs.pairB.cpu().numpy()
        ca = ifs.connA.cpu().numpy().astype(np.int64)
        cb = ifs.connB.cpu().numpy().astype(np.int64)
        real_q = ifs.w.cpu().numpy() > 0                   # (I, Nq)
        chunks = []
        for i in range(I_):
            qs = np.nonzero(real_q[i])[0]
            g = i * Nq + qs
            mA = _local_maps(ca[i, qs], free[pa[i]])
            mB = _local_maps(cb[i, qs], free[pb[i]])
            none = np.full_like(mA, -1)
            for blk, off in blocks_of_patch[pa[i]]:
                if whole is not None and blk == whole[i]:
                    offB = dict(blocks_of_patch[pb[i]])[blk]
                    chunks.append((g, blk, np.concatenate(
                        [np.where(mA >= 0, mA + off, -1),
                         np.where(mB >= 0, mB + offB, -1)], 1)))
                else:
                    chunks.append((g, blk, np.concatenate(
                        [np.where(mA >= 0, mA + off, -1), none], 1)))
            for blk, off in blocks_of_patch[pb[i]]:
                if whole is not None and blk == whole[i]:
                    continue
                chunks.append((g, blk, np.concatenate(
                    [none, np.where(mB >= 0, mB + off, -1)], 1)))
        iface = _slot_table(chunks, I_ * Nq, 6 * Li, dev)
    fb = np.zeros((n_blocks, nb))
    for p in (range(P) if patches is None else patches):
        for blk, off in blocks_of_patch[p]:
            fb[blk, off: off + 3 * C] = free[p].reshape(-1)
    return BlockTables(elem=elem, iface=iface, n_blocks=n_blocks, nb=nb,
                       free=tensor(fb, dev))


def assemble_blocks(bt: BlockTables, tables, Hs, counter):
    """(B, nb, nb) BC-masked blocks from jet Hessians `Hs` (`jet_hessians`)
    through K10, with the identity on fixed dofs."""
    H_e, H_i, H_p = Hs[:3]
    out = torch.zeros(bt.n_blocks, bt.nb, bt.nb, dtype=DTYPE,
                      device=bt.free.device)
    pair_assemble(out, H_e, tables.R_e, bt.elem, counter)
    if bt.iface is not None and H_i is not None:
        pair_assemble(out, H_i, tables.R_i, bt.iface, counter)
    if H_p is not None:
        pair_assemble(out, H_p, tables.R_p, bt.elem, counter)
    out.diagonal(dim1=1, dim2=2).add_(1.0 - bt.free)
    return out


def _factor(K):
    """Symmetric Jacobi equilibration and a batched f64 LU: (lu, piv, dsc,
    info). A block whose LU reports info != 0 is filled with NaN, so every
    solve against it is non-finite (no silent fallback)."""
    dsc = torch.rsqrt(K.diagonal(dim1=-2, dim2=-1).abs() + 1e-300)
    K.mul_(dsc[..., :, None]).mul_(dsc[..., None, :])
    lu, piv, info = torch.linalg.lu_factor_ex(K)
    bad = (info != 0).reshape(info.shape + (1, 1))
    lu = torch.where(bad, torch.full_like(lu, float("nan")), lu)
    return lu, piv, dsc, info


def _patch_blocks_of(P):
    return [[(p, 0)] for p in range(P)]


# ------------------------------------------------------------ preconditioners
def patch_block_precond(data: SystemData, d, cp, h, tables=None, Hs=None):
    """Factored per-patch diagonal blocks of K: (lu, piv, dsc) with lu
    (P, 3C, 3C) f64. The same-patch quadrants of the interface penalty
    Hessians are included: they anchor the rigid-body modes of patches
    without Dirichlet BCs."""
    tables = jet_tables(data) if tables is None else tables
    Hs = jet_hessians(data, d, cp, h) if Hs is None else Hs
    P, C = data.stack.n_patches, data.stack.max_cp
    bt = _block_tables(data, _patch_blocks_of(P), P, 3 * C)
    lu, piv, dsc, _ = _factor(assemble_blocks(bt, tables, Hs,
                                              "pair_assemble/patches"))
    return lu, piv, dsc


def _apply_precond(precond, r):
    """r: (P, C, 3) -> M^{-1} r through the batched equilibrated patch
    LU."""
    lu, piv, dsc = precond
    P = r.shape[0]
    rl = dsc * r.reshape(P, -1)
    z = torch.linalg.lu_solve(lu, piv, rl[..., None])[..., 0]
    return (dsc * z).reshape(r.shape)


def full_precond(data: SystemData, d, cp, h, tables=None, Hs=None):
    """Equilibrated f64 LU of the full dense tangent (K3 assembly). Replaces
    the reference's f32 variant (`full_f32_precond`), whose f32 assembly
    only saved TPU memory."""
    _no_contact(data)
    tables = jet_tables(data) if tables is None else tables
    Hs = jet_hessians(data, d, cp, h) if Hs is None else Hs
    K = assemble_K_from(tables, Hs)
    lu, piv, dsc, _ = _factor(K[None])
    return ("full", (lu[0], piv[0], dsc[0]))


class PairSchwarz:
    """Overlapping Schwarz over INTERFACE PAIRS, applied multiplicatively
    over edge colours.

    Block-Jacobi fails on penalty-coupled patches: the stiffest entries of
    K are the inter-patch penalty blocks, off the patch diagonal. Each
    subdomain here is the coupled 2-patch system of one interface: its
    (6C, 6C) block holds both patches' element stiffness, the full penalty
    block of its own interface, and the self-quadrants of every other
    interface touching either patch. Application is multiplicative over
    the edge colours of the patch graph (parallel within a colour, whose
    pairs touch disjoint patches; one tangent matvec between colours).
    Additive overlap damping does not work: each pair solve satisfies its
    own penalty constraint, and summing overlapping solutions violates the
    neighbours' penalties, amplifying errors by the penalty scale (~1e7).

    The structure (pair lists, `count`, isolated patches, `extra`, the
    greedy edge colouring) is the reference's, on the host. The blocks are
    stored in colour order (`order`), so a colour's factors are one slice.

    On the box wing this one-level sweep leaves eigenvalues of M^-1 K down
    to ~1e-8 (the wing's global bending, which pair solves anchored to
    their neighbours' penalty springs cannot move): GMRES stalls there, in
    both packages (ROADMAP Queue C), and on the 20-patch wing too;
    `build_solve_fn_krylov(precond="full")` is the route that solves them.
    """

    def __init__(self, data: SystemData):
        _no_contact(data)
        assert data.ifs is not None and data.ifs.n_interfaces > 0
        self.P = data.stack.n_patches
        self.C = data.stack.max_cp
        self.pairA = data.ifs.pairA.cpu().numpy().astype(np.int64)
        self.pairB = data.ifs.pairB.cpu().numpy().astype(np.int64)
        self.I = len(self.pairA)
        count = np.zeros(self.P, dtype=np.int64)
        for a, b in zip(self.pairA, self.pairB):
            count[a] += 1
            count[b] += 1
        self.count = count
        self.iso = np.nonzero(count == 0)[0]  # isolated patches
        # per interface i: other interfaces whose A/B side touches side A
        # (patch pairA[i]) or side B
        self.extra = []  # list of (j, src_side, dst_side)
        for i in range(self.I):
            lst = []
            for j in range(self.I):
                if j == i:
                    continue
                for src, pj in (("A", self.pairA[j]), ("B", self.pairB[j])):
                    if pj == self.pairA[i]:
                        lst.append((j, src, 0))
                    if pj == self.pairB[i]:
                        lst.append((j, src, 1))
            self.extra.append(lst)
        # greedy edge colouring: interfaces in one colour touch disjoint
        # patch sets, so their pair solves compose without overlap
        colors: list[list[int]] = []
        for i in range(self.I):
            placed = False
            for col in colors:
                pats = {int(self.pairA[j]) for j in col} | \
                       {int(self.pairB[j]) for j in col}
                if int(self.pairA[i]) not in pats and \
                        int(self.pairB[i]) not in pats:
                    col.append(i)
                    placed = True
                    break
            if not placed:
                colors.append([i])
        self.colors = [np.asarray(c, dtype=np.int64) for c in colors]
        self.order = np.concatenate(self.colors)  # block k <- pair order[k]
        slot = np.empty(self.I, dtype=np.int64)
        slot[self.order] = np.arange(self.I)      # pair i -> its block
        n = 3 * self.C
        blocks_of_patch = [[] for _ in range(self.P)]
        for i in range(self.I):
            blocks_of_patch[self.pairA[i]].append((int(slot[i]), 0))
            blocks_of_patch[self.pairB[i]].append((int(slot[i]), n))
        self.tables = jet_tables(data)
        self.blocks = _block_tables(data, blocks_of_patch, self.I, 2 * n,
                                    whole=slot)
        self.iso_blocks = None
        if len(self.iso):
            self.iso_blocks = _block_tables(
                data, {int(p): [(k, 0)] for k, p in enumerate(self.iso)},
                len(self.iso), n, patches=[int(p) for p in self.iso])
        dev = data.free.device
        self._iso_idx = tensor(self.iso, dev, torch.int64)
        self._spans = []
        k0 = 0
        for col in self.colors:
            self._spans.append((k0, k0 + len(col),
                                tensor(self.pairA[col], dev, torch.int64),
                                tensor(self.pairB[col], dev, torch.int64)))
            k0 += len(col)

    def assemble(self, data: SystemData, d, cp, h, Hs=None):
        """Factored pair blocks at state d: (lu, piv, dsc, iso, info)."""
        Hs = jet_hessians(data, d, cp, h) if Hs is None else Hs
        Kp = assemble_blocks(self.blocks, self.tables, Hs,
                             "pair_assemble/pairs")
        lu, piv, dsc, info = _factor(Kp)
        del Kp
        iso = None
        if self.iso_blocks is not None:
            Ki = assemble_blocks(self.iso_blocks, self.tables, Hs,
                                 "pair_assemble/patches")
            lui, pivi, dsi, infi = _factor(Ki)
            iso = (lui, pivi, dsi)
            info = torch.cat([info, infi])
        return lu, piv, dsc, iso, info

    def apply(self, fac, r, matvec):
        """r: (P, C, 3) -> M^{-1} r: multiplicative sweep over colours (one
        tangent `matvec` between colours), equilibrated f64 pair solves
        within each colour."""
        lu, piv, dsc, iso, _ = fac
        P, n = self.P, 3 * self.C
        rf0 = r.reshape(P, n)
        z = torch.zeros_like(rf0)
        if iso is not None:
            lui, pivi, dsi = iso
            zi = torch.linalg.lu_solve(
                lui, pivi, (dsi * rf0[self._iso_idx])[..., None])[..., 0]
            z[self._iso_idx] = dsi * zi
        rc = rf0
        last = len(self._spans) - 1
        for c, (k0, k1, ia, ib) in enumerate(self._spans):
            dsc_c = dsc[k0:k1]
            rs = dsc_c * torch.cat([rc[ia], rc[ib]], dim=1)
            y = dsc_c * torch.linalg.lu_solve(lu[k0:k1], piv[k0:k1],
                                              rs[..., None])[..., 0]
            z.index_add_(0, ia, y[:, :n])
            z.index_add_(0, ib, y[:, n:])
            if c < last:
                rc = rf0 - matvec(z.reshape(r.shape)).reshape(P, n)
        return z.reshape(r.shape)


# ------------------------------------------------------------ GMRES
def _safe_normalize(x, thresh=_EPS):
    """(x / |x|, |x|), or (0, 0) where |x| <= thresh (0-dim tensors)."""
    nrm = torch.linalg.norm(x)
    use = nrm > thresh
    return (torch.where(use, x / nrm, torch.zeros_like(x)),
            torch.where(use, nrm, torch.zeros_like(nrm)))


def _gmres_cycle(A, M, b, x, unit, rnorm, restart, ptol):
    """One restart: up to `restart` Arnoldi steps on M(A(.)) (left
    preconditioning), the least-squares problem, the new x, its
    preconditioned residual and the norm of its residual.

    The steps run without a host round trip; a step that is not `alive`
    leaves its Hessenberg row at the identity and its basis vector at zero,
    as the reference does after a breakdown (|v| <= eps |M A v_k|). A step
    also ends the live ones once the preconditioned residual of the
    least-squares problem (read off the complete QR of the Hessenberg rows
    so far) is at most `ptol`, the inner test of the reference's
    incremental variant: without it a near-exact preconditioner (the dense
    LU) fills the rest of the basis with roundoff vectors whose
    coefficients spoil x. On the CPU, where the read costs nothing, the
    loop ends at the first dead step (the same result: dead steps add
    nothing).

    The new vector is orthogonalized by two classical Gram-Schmidt passes
    ("twice is enough"; the reference runs one), and the least-squares
    problem min |beta e1 - H^T y| is solved by Householder QR, where the
    reference's normal equations H H^T y = H beta lose positive
    definiteness once H is near rank-deficient (a NaN step)."""
    n = b.numel()
    V = torch.zeros(restart + 1, n, dtype=b.dtype, device=b.device)
    V[0] = unit
    H = torch.eye(restart, restart + 1, dtype=b.dtype, device=b.device)
    beta = torch.zeros(restart + 1, dtype=b.dtype, device=b.device)
    beta[0] = rnorm
    alive = torch.ones((), dtype=torch.bool, device=b.device)
    for k in range(restart):
        v = M(A(V[k]))
        _, v0 = _safe_normalize(v)
        h = V @ v
        v = v - h @ V
        h2 = V @ v
        v = v - h2 @ V
        h = h + h2
        unit_v, v1 = _safe_normalize(v, _EPS * v0)
        h[k + 1] = v1
        H[k] = torch.where(alive, h, H[k])
        V[k + 1] = torch.where(alive, unit_v, V[k + 1])
        Qk, _ = torch.linalg.qr(H[:k + 1, :k + 2].T, mode="complete")
        est = (Qk[:, k + 1] @ beta[:k + 2]).abs()
        alive = alive & (v1 != 0) & (est > ptol)
        if b.device.type == "cpu" and not bool(alive):
            break   # on the CPU the read is free: skip the dead steps
    Qh, Rh = torch.linalg.qr(H.T)
    y = torch.linalg.solve_triangular(Rh, (Qh.T @ beta)[:, None],
                                      upper=True)[:, 0]
    x = x + y @ V[:-1]
    res = b - A(x)
    unit, rnorm = _safe_normalize(M(res))
    return x, unit, rnorm, torch.linalg.norm(res)


def gmres(A, b, M, tol=1e-5, restart=20, maxiter=None):
    """Restarted GMRES for A x = b from x0 = 0 with left preconditioner M,
    after jax.scipy.sparse.linalg.gmres(atol=0, solve_method="batched"):
    full restart cycles of `restart` Arnoldi steps, at most `maxiter` of
    them, while |b - A x| > tol |b|; within a cycle the Arnoldi steps stop
    once the preconditioned residual is at most tol |M b| (`ptol`, as in
    the reference's incremental variant). The cycle's one host read is the
    outer test and two more stops: a zero preconditioned residual (the
    Krylov space has nothing left to add), and stagnation (a cycle that
    took off less than 10% of |b - A x|: the residual sits at its roundoff
    floor, or the preconditioner has stalled).

    The reference compares the preconditioned residual |M(b - A x)| with
    tol |b|, two norms of different units: where M scales like K^-1
    (|M r| / |r| ~ 1e-6 on the box wing) that test passes after one cycle
    or none, far from the solution. A, M act on flat vectors. Returns (x,
    cycles)."""
    n = b.numel()
    restart = min(restart, n)
    maxiter = 10 * n if maxiter is None else maxiter
    x = torch.zeros_like(b)
    res = b - A(x)
    unit, rnorm = _safe_normalize(M(res))
    tnorm = torch.linalg.norm(res)
    atol, t, rr = torch.stack([tol * torch.linalg.norm(b), tnorm,
                               rnorm]).tolist()
    ptol = tol * rnorm
    k = 0
    prev = math.inf
    while k < maxiter and t > atol and rr > 0.0 and t <= 0.9 * prev:
        x, unit, rnorm, tnorm = _gmres_cycle(A, M, b, x, unit, rnorm,
                                             restart, ptol)
        k += 1
        prev = t
        t, rr = torch.stack([tnorm, rnorm]).tolist()
    return x, k


def _mop(precond, op):
    """The preconditioner apply r -> M^{-1} r on (P, C, 3) tensors."""
    if isinstance(precond[0], PairSchwarz):
        ps, fac = precond
        return lambda r: ps.apply(fac, r, op)
    if isinstance(precond[0], str):      # ("full", factor)
        lu, piv, dsc = precond[1]
        return lambda r: (dsc * torch.linalg.lu_solve(
            lu, piv, (dsc * r.reshape(-1))[:, None])[:, 0]).reshape(r.shape)
    return lambda r: _apply_precond(precond, r)


def _gmres_ir(op, Mop, b, rtol, restart, maxiter, n_ir):
    """GMRES with n_ir passes of outer iterative refinement against the
    exact product `op`: (x, total restart cycles)."""
    shape = b.shape
    A = lambda v: op(v.reshape(shape)).reshape(-1)       # noqa: E731
    M = lambda v: Mop(v.reshape(shape)).reshape(-1)      # noqa: E731
    x = torch.zeros_like(b)
    r = b
    cycles = 0
    for _ in range(n_ir):
        dx, k = gmres(A, r.reshape(-1), M, tol=rtol, restart=restart,
                      maxiter=maxiter)
        cycles += k
        x = x + dx.reshape(shape)
        r = b - op(x)
    return x, cycles


def gmres_solve(data: SystemData, d, cp, h, b, precond, rtol=1e-10,
                restart=32, maxiter=20, n_ir=3):
    """Preconditioned GMRES on K(d) x = b (shapes (P, C, 3)) with outer
    iterative refinement: each pass restarts from the exact residual
    b - K x. `precond` is a patch-block factorization, a
    ("full", factor) tuple or a (PairSchwarz, factorization) tuple.
    Returns (x, total GMRES restart cycles)."""
    _no_contact(data)
    tables = precond[0].tables if isinstance(precond[0], PairSchwarz) \
        else jet_tables(data)
    Hs = jet_hessians(data, d, cp, h)
    op = lambda v: tangent_matvec_from(tables, Hs, v)    # noqa: E731
    return _gmres_ir(op, _mop(precond, op), b, rtol, restart, maxiter, n_ir)


# ------------------------------------------------------------ Newton
class NewtonKrylovFailure(RuntimeError):
    """The Newton-Krylov solve ended without convergence."""


def _newton_once(data, cp, h, d0, rtol, cg_rtol, max_newton, max_cg,
                 schwarz, tables, log):
    _no_contact(data)
    free = data.free
    _, r_zero = potential_and_residual(data, torch.zeros_like(d0), cp, h)
    Pi, r = potential_and_residual(data, d0, cp, h)
    r_ref, rn = torch.stack([torch.linalg.norm(r_zero),
                             torch.linalg.norm(r)]).tolist()
    r_ref = max(r_ref, rn * 1e-6, 1e-300)
    eps = _EPS
    d = d0
    it = 0
    pinned = 0
    done = False
    maxiter = max_cg // 32 + 1
    while it < max_newton and not done and rn > rtol * r_ref:
        rn0 = rn
        Hs = jet_hessians(data, d, cp, h)
        op = lambda v, Hs=Hs: tangent_matvec_from(tables, Hs, v)  # noqa
        if schwarz is not None:
            precond = (schwarz, schwarz.assemble(data, d, cp, h, Hs=Hs))
        else:
            precond = full_precond(data, d, cp, h, tables=tables, Hs=Hs)
        delta, cycles = _gmres_ir(op, _mop(precond, op), -r, cg_rtol, 32,
                                  maxiter, 3)
        delta = delta * free
        slope, Pi0 = torch.stack([torch.sum(r * delta), Pi]).tolist()
        done = abs(slope) <= 4.0 * eps * abs(Pi0) + 1e-300
        alpha = 1.0
        accepted = None
        ls_fail = False
        if not done:
            for _ in range(30):
                Pi_t, r_t = potential_and_residual(data, d + alpha * delta,
                                                   cp, h)
                pt, rt = torch.stack([Pi_t, torch.linalg.norm(r_t)]).tolist()
                # SVK energy is not convex far from equilibrium: a full step
                # can lower Pi while |r| explodes into a crumpled state
                # where the next GMRES direction degenerates, so the
                # residual must not blow up either. Inside the Newton basin
                # a step that halves |r| is taken even where Pi cannot
                # resolve its decrease (roundoff in Pi ~ 1e-13 |Pi| on the
                # box wing, far above the 16 eps |Pi| allowance)
                pi_ok = pt <= Pi0 + 1e-4 * alpha * slope + 16 * eps * abs(Pi0)
                basin_ok = rn0 <= 1e-2 * r_ref and rt <= 0.5 * rn0
                if (pi_ok and rt <= 4.0 * max(rn0, r_ref)) or basin_ok:
                    accepted = (Pi_t, r_t, rt)
                    break
                alpha *= 0.5
            else:
                ls_fail = True
        if ls_fail and rn <= 1e-2 * r_ref and slope < 0.0:
            # the line search exhausted in the Newton basin with a descent
            # direction: the energy cannot resolve further progress (the
            # residual floor), as in implicit.damped_newton
            log.append((it, rn, 0.0, cycles))
            return d, it, rn, True
        d = d + alpha * delta
        if accepted is None:
            Pi, r = potential_and_residual(data, d, cp, h)
            rn = float(torch.linalg.norm(r))
        else:
            Pi, r, rn = accepted
        it += 1
        log.append((it, rn, alpha, cycles))
        # the residual pinned at its floor inside the basin
        pinned = pinned + 1 if rn <= 1e-2 * r_ref and rn > 0.98 * rn0 else 0
        if pinned >= 2:
            return d, it, rn, True
    ok = math.isfinite(rn) and (done or rn <= rtol * r_ref)
    return d, it, rn, ok


def newton_krylov_solve(data: SystemData, cp, h, d0, rtol=1e-8,
                        cg_rtol=1e-6, max_newton=30, max_cg=500,
                        schwarz: PairSchwarz | None = None, log=None):
    """Matrix-free damped Newton-Krylov (large-model forward solve).

    The reference's globalization as a host loop: |r(0)| as the scale, a
    GMRES direction (restart 32, max_cg // 32 + 1 cycles, 3 refinement
    passes) with the preconditioner refreshed every iteration (pair-Schwarz
    when `schwarz` is given, else the dense LU), the `done` slope test, and
    the Armijo line search bounded by 4 max(|r|, |r(0)|) with up to 30
    halvings. Returns (d, its, |r|); every iteration appends (it, |r|,
    alpha, GMRES cycles) to `log` when given.

    Inside the Newton basin (|r| <= 1e-2 |r(0)|) the port departs from the
    reference's loop, whose energy test cannot resolve the last steps: a
    trial that halves |r| is accepted whatever Pi says; a line search that
    exhausts its halvings with a descent direction, or two steps that take
    off less than 2% of |r|, end the solve at the residual floor (the
    reference runs on to max_newton). A solve that ends neither converged
    nor at that floor is run once more from d = 0 when it was warm-started,
    then raises `NewtonKrylovFailure`."""
    log = [] if log is None else log
    tables = schwarz.tables if schwarz is not None else jet_tables(data)
    args = (rtol, cg_rtol, max_newton, max_cg, schwarz, tables, log)
    d, it, rn, ok = _newton_once(data, cp, h, d0, *args)
    if not ok and bool(d0.any()):
        log.append(("retry from d = 0",))
        d, it, rn, ok = _newton_once(data, cp, h, torch.zeros_like(d0),
                                     *args)
    if not ok:
        raise NewtonKrylovFailure(
            f"Newton-Krylov did not converge in {max_newton} iterations: "
            f"(it, |r|, alpha, GMRES cycles) log {log[-8:]}")
    return d, it, rn


# ------------------------------------------------------------ adjoint
class _KrylovSolver:
    """State of one solve function: the preconditioner structure (the
    pair-Schwarz one, or None for the dense LU), the tolerances and the
    last solves' statistics."""

    def __init__(self, data, rtol, cg_rtol, max_newton, max_cg, precond):
        if precond not in ("pair_schwarz", "full"):
            raise ValueError(f"precond: {precond!r}, expected "
                             "'pair_schwarz' or 'full'")
        self.data = data
        self.schwarz = PairSchwarz(data) if precond == "pair_schwarz" \
            else None
        self.tables = self.schwarz.tables if self.schwarz is not None \
            else jet_tables(data)
        self.rtol, self.cg_rtol = rtol, cg_rtol
        self.max_newton, self.max_cg = max_newton, max_cg
        self.last_its = None
        self.last_log = []
        self.adjoint_cycles = []

    def solve(self, cp, h, d0):
        log = []
        d, its, _ = newton_krylov_solve(
            self.data, cp, h, d0, rtol=self.rtol, cg_rtol=self.cg_rtol,
            max_newton=self.max_newton, max_cg=self.max_cg,
            schwarz=self.schwarz, log=log)
        self.last_its, self.last_log = its, log
        return d

    def adjoint(self, d, cp, h, g):
        """(dcp, dh) = -lam^T dR/d(cp, h) with K(d) lam = g by GMRES-IR."""
        data, ps = self.data, self.schwarz
        Hs = jet_hessians(data, d, cp, h)
        op = lambda v: tangent_matvec_from(self.tables, Hs, v)  # noqa: E731
        if ps is not None:
            pre = (ps, ps.assemble(data, d, cp, h, Hs=Hs))
        else:
            pre = full_precond(data, d, cp, h, tables=self.tables, Hs=Hs)
        lam, cycles = _gmres_ir(op, _mop(pre, op), g * data.free,
                                self.cg_rtol, 32, self.max_cg // 32 + 1, 3)
        self.adjoint_cycles.append(cycles)
        return residual_vjp(data, d, cp, h, lam * data.free)


class _KrylovSolve(torch.autograd.Function):

    @staticmethod
    def forward(ctx, solver: _KrylovSolver, cp, h, d0):
        d = solver.solve(cp, h, d0)
        ctx.solver = solver
        ctx.save_for_backward(d, cp, h)
        return d

    @staticmethod
    def backward(ctx, g):
        d, cp, h = ctx.saved_tensors
        dcp, dh = ctx.solver.adjoint(d, cp, h, g)
        return None, dcp, dh, None


def build_solve_fn_krylov(data: SystemData, rtol=1e-9, cg_rtol=1e-8,
                          max_newton=30, max_cg=500, precond="full"):
    """Differentiable solve(cp, h, d0) -> d for pegasus-class models:
    Newton-Krylov forward, GMRES-IR adjoint, the exact tangent applied by
    K4 (reference:
    demos_om/thickness_opt/pegasus/pegasus_var_th_opt_wint.py:203-206).

    `precond` picks the GMRES preconditioner: "full" (the default), the
    dense f64 LU of K that the reference's `newton_krylov_solve(schwarz=
    None)` uses (O(N^2) memory), or "pair_schwarz", the reference's
    coloured multiplicative pair-Schwarz (no dense (N, N) matrix anywhere),
    which converges only on models of a few patches (the 3-patch plate; on
    wings and box wings its GMRES stalls and the solve raises
    `NewtonKrylovFailure`). The solver state (`schwarz`, `last_its`,
    `last_log`, `adjoint_cycles`) is `solve.solver`."""
    _no_contact(data)
    solver = _KrylovSolver(data, rtol, cg_rtol, max_newton, max_cg, precond)

    def solve(cp, h, d0):
        return _KrylovSolve.apply(solver, cp, h, d0)

    solve.solver = solver
    return solve
