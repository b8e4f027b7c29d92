"""Matrix-free Newton-Krylov path for large patch counts.

Port of goldfish_tpu/solver/krylov.py. The dense tangent of
solver/system.py is O((P*C*3)^2) memory; this path never assembles it:

  - the exact product K(d) v is kernel K4 (`jet_matvec`) on the jet
    Hessians of K1/K2 mode (b), computed once per state;
  - three preconditioners: the reference's coloured multiplicative
    pair-Schwarz sweep (`PairSchwarz`): one dense (6C, 6C) block per
    interface pair, composed by kernel K10 (csrc/pair_assemble.cu) from
    the patch blocks it sums once from the jet Hessians
    (`patch_assemble`) and the interface's cross quadrant
    (`pair_assemble`), Jacobi-equilibrated and factored by a batched f64
    LU; the per-patch block-Jacobi one (`patch_block_precond`), K10's
    patch blocks alone; and the dense one (`full_precond`), K3 into K and
    an f64 LU. Only the dense one converges on wings and box wings (see
    `PairSchwarz`), so it is the solve function's default;
  - restarted GMRES (`gmres_solve`, left-preconditioned like
    `jax.scipy.sparse.linalg.gmres(solve_method="batched")`) with outer
    iterative refinement against the exact K(d) v;
  - damped Newton (`newton_krylov_solve`) with GMRES directions and the
    residual-bounded Armijo line search, as a host loop;
  - `build_solve_fn_krylov`: the differentiable solve, a
    `torch.autograd.Function` whose backward solves K lam = g by GMRES and
    applies the residual VJP (K1/K2 mode c), with any of the three
    preconditioners (`PRECONDS`).

Where the reference factored in f32 (the TPU has no batched f64 LU), the
port factors in f64: GMRES iteration counts differ from the JAX package's,
the solutions agree to the solver tolerances. GMRES reads the host once
per restart cycle (its stop tests); the Arnoldi steps run without a host
round trip.

Contact (`SystemData.contact`) rides through `system`'s products as in
the reference (krylov.py:318, 356-400 there): the GMRES matvec adds K12's
hvp on the Newton step's cull list (`tangent_matvec_from` on one
`jet_hessians`), the line search's potential and residual its value and
force, the dense preconditioner its assembled blocks (K12 mode 2), the
adjoint's residual VJP `contact_adjoint`. The patch blocks and the pair
blocks leave contact out, as the reference's do (krylov.py:59-88, 178-195
there): their tables have no contact entries.
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

__all__ = ["BlockTables", "patch_assemble", "pair_assemble",
           "assemble_blocks", "PairSchwarz",
           "patch_block_precond", "full_precond", "gmres", "gmres_solve",
           "NewtonKrylovFailure", "newton_krylov_solve",
           "build_solve_fn_krylov"]

_EPS = float(np.finfo(np.float64).eps)


# ------------------------------------------------------------ K10
# entry kinds of K10's work lists (csrc/pair_assemble.cu): an element's shell
# or follower-pressure Hessian, a run of interface qps' side-A or side-B
# self-quadrant, and their cross quadrants (rows on A, columns on B, and the
# transpose side)
SHELL, PRESSURE, SELF_A, SELF_B, CROSS_AB, CROSS_BA = range(6)
QC = 4                   # qps a chunk (pair_assemble.cu: QC)
MAX_LOC = 27             # locals a side: a thread keeps <= 3 (l, m) pairs
SMEM_MAX = 232448        # shared memory of one block (227 KB)
BAND_BYTES = 64 * 1024   # the band's target share of it
_NINT = 97               # ints of shared memory beside the band and staging
_RP, _TP = 24, 56        # row pitches of the tensor-core path (16 locals)


class BlockEntries(NamedTuple):
    """One K10 launch's work list. Entry s adds one group's B^T H B to one
    block quadrant: `kind[s]`; `group[s]`, the element (SHELL, PRESSURE,
    nq = Q) or the first of `nq[s]` consecutive interface qps; the CP of
    each of its row locals and column locals, `cps[s, 0]` and `cps[s, 1]`
    (-1: none); `dest[s]`, the block it adds into (stage 1: the patch;
    stage 2: 2 k + half of pair block k). Band t of destination d (rows
    t band_rows .. of d) walks entries band_ent[band_ptr[d n_bands + t] ..
    band_ptr[d n_bands + t + 1]], those with a row local in those rows, in
    entry order. `stage` and `tsz` size the block's shared memory (doubles
    of its two staging buffers and of a chunk's T) for the kinds present
    (`kinds`)."""

    kind: torch.Tensor       # (S,) int32
    group: torch.Tensor      # (S,) int32
    nq: torch.Tensor         # (S,) int32
    cps: torch.Tensor        # (S, 2, Lw) int32
    dest: torch.Tensor       # (S,) int64
    band_ptr: torch.Tensor   # (D n_bands + 1,) int32
    band_ent: torch.Tensor   # (T,) int32
    n_bands: int
    band_rows: int
    stage: int
    tsz: int
    kinds: tuple


class BlockTables(NamedTuple):
    """K10's tables, built once on the host: stage 1 (`patch`: every patch
    block) and, for pair blocks, stage 2 (`pair`: the cross quadrants of
    pair block k, whose patches are pa[k] and pb[k]); `free` (P, 3C) is
    each patch's mask, n = 3C."""

    patch: BlockEntries
    pair: BlockEntries | None
    pa: torch.Tensor | None   # (B,) int32
    pb: torch.Tensor | None   # (B,) int32
    free: torch.Tensor        # (P, 3C)
    n: int


def _runs(real, *conns):
    """[q0, nq] of the maximal runs of consecutive real qps on which each
    (Nq, L) conn keeps its row."""
    runs = []
    for q in np.nonzero(real)[0]:
        if runs and sum(runs[-1]) == q and all(
                np.array_equal(c[q], c[q - 1]) for c in conns):
            runs[-1][1] += 1
        else:
            runs.append([int(q), 1])
    return runs


def _jets(kind, L, Li):
    """(jets, locals) a side of an entry kind."""
    return (5, L) if kind == SHELL else (3, L) if kind == PRESSURE \
        else (3, Li)


def _entries(ents, n_dest, n, L, Li, dev):
    """BlockEntries from [(kind, group, nq, row CPs, column CPs, dest)]."""
    Lw = max(L, Li)
    S = len(ents)
    cps = np.full((S, 2, Lw), -1, np.int64)
    for s, e in enumerate(ents):
        cps[s, 0, :len(e[3])] = e[3]
        cps[s, 1, :len(e[4])] = e[4]
    col = lambda k: np.array([e[k] for e in ents], np.int64)  # noqa: E731
    kind, group, nq, dest = col(0), col(1), col(2), col(5)
    srt = np.sort(cps, axis=2)
    if ((srt[..., 1:] == srt[..., :-1]) & (srt[..., 1:] >= 0)).any():
        raise ValueError("K10: a group's locals must sit on distinct CPs")
    kinds = tuple(sorted(set(kind.tolist())))
    stage = tsz = 0
    for k in kinds:
        nj, nl = _jets(k, L, Li)
        if nl > MAX_LOC:
            raise ValueError(f"K10: {nl} locals a side; at most {MAX_LOC}")
        # 16 locals a side take the tensor-core path, whose staged rows and
        # T rows are padded (pair_assemble.cu: RP, TP)
        rp, tp = (_RP, _TP) if nl == 16 else (nl, 3 * nl)
        rows = nj * rp * (2 if k >= CROSS_AB else 1)
        stage = max(stage, 2 * QC * (rows + 9 * nj * nj))   # two buffers
        tsz = max(tsz, QC * 3 * nj * tp)                    # a chunk's T
    fixed = (stage + tsz) * 8 + _NINT * 4
    # balanced bands of whole CPs, at most BAND_BYTES where one CP fits
    cps_band = max(1, BAND_BYTES // (24 * n))
    band_rows = 3 * -(-(n // 3) // -(-n // (3 * cps_band)))
    smem = -(-band_rows * n // 2) * 16 + fixed
    if smem > SMEM_MAX:
        raise ValueError(
            f"K10: a band of {band_rows} rows of a {n}-dof block needs "
            f"{smem} B of shared memory, above a block's {SMEM_MAX} B")
    n_bands = -(-n // band_rows)
    rows = cps[:, 0]
    touch = np.zeros((S, n_bands), bool)
    ent, slot = np.nonzero(rows >= 0)
    touch[ent, 3 * rows[ent, slot] // band_rows] = True
    ent, band = np.nonzero(touch)
    key = dest[ent] * n_bands + band
    o = np.lexsort((ent, key))
    ptr = np.searchsorted(key[o], np.arange(n_dest * n_bands + 1))
    idx = lambda a: tensor(a, dev, INDEX_DTYPE)   # noqa: E731
    return BlockEntries(kind=idx(kind), group=idx(group), nq=idx(nq),
                        cps=idx(cps), dest=tensor(dest, dev, torch.int64),
                        band_ptr=idx(ptr), band_ent=idx(ent[o]),
                        n_bands=n_bands, band_rows=band_rows, stage=stage,
                        tsz=tsz, kinds=kinds)


def _block_tables(data: SystemData, order=None):
    """BlockTables on the data's device: every patch block (its real
    elements, with a follower pressure also their pressure Hessians, then
    the runs of every interface side that touches it) and, given `order`
    (block k <- interface order[k]), the pair blocks' cross quadrants.
    Contact has no entries (the reference's blocks leave it out). Bands
    hold about BAND_BYTES of rows. Raises where a group's locals share a
    CP, a side has more than MAX_LOC locals, or a band of 3 rows does not
    fit in a block's shared memory."""
    stack, ifs = data.stack, data.ifs
    P, E, Q, L = stack.R00.shape
    n = 3 * stack.max_cp
    dev = data.free.device
    conn = stack.conn.cpu().numpy().astype(np.int64)
    real_e = stack.wq.cpu().numpy().sum(-1) > 0          # (P, E)
    kinds = (SHELL,) if data.pressure is None else (SHELL, PRESSURE)
    ents = [(k, p * E + e, Q, conn[p, e], conn[p, e], p)
            for p in range(P) for e in np.nonzero(real_e[p])[0]
            for k in kinds]
    Li = 0
    if ifs is not None:
        I_, Nq, Li = ifs.RA00.shape
        pa = ifs.pairA.cpu().numpy().astype(np.int64)
        pb = ifs.pairB.cpu().numpy().astype(np.int64)
        ca = ifs.connA.cpu().numpy().astype(np.int64)
        cb = ifs.connB.cpu().numpy().astype(np.int64)
        real_q = ifs.w.cpu().numpy() > 0                   # (I, Nq)
        for i in range(I_):
            for kind, c, p in ((SELF_A, ca[i], pa[i]), (SELF_B, cb[i], pb[i])):
                ents += [(kind, i * Nq + q0, m, c[q0], c[q0], p)
                         for q0, m in _runs(real_q[i], c)]
    patch = _entries(ents, P, n, L, Li, dev)
    pair = ta = tb = None
    if order is not None:
        ents = []
        for k, i in enumerate(order):
            for q0, m in _runs(real_q[i], ca[i], cb[i]):
                g = i * Nq + q0
                ents += [(CROSS_AB, g, m, ca[i, q0], cb[i, q0], 2 * k),
                         (CROSS_BA, g, m, cb[i, q0], ca[i, q0], 2 * k + 1)]
        pair = _entries(ents, 2 * len(order), n, L, Li, dev)
        ta = tensor(pa[order], dev, INDEX_DTYPE)
        tb = tensor(pb[order], dev, INDEX_DTYPE)
    return BlockTables(patch=patch, pair=pair, pa=ta, pb=tb,
                       free=data.free.reshape(P, n).contiguous(), n=n)


def _add_entries_plain(flat, be: BlockEntries, tables, Hs, n):
    """index_put_(accumulate=True) version of a K10 launch's sums: every
    entry of `be` into flat (D n n,) over its row and column dofs."""
    H_e, H_i, H_p = Hs[:3]
    kind = be.kind.long()
    for k in be.kinds:
        sel = torch.nonzero(kind == k)[:, 0]
        g = be.group[sel].long()
        if k in (SHELL, PRESSURE):
            R = (tables.R_e if k == SHELL else tables.R_p)[g]
            H = (H_e if k == SHELL else H_p)[g]
            s, nqp, nj, nl = R.shape
            Rr = Rc = R
            H = H.reshape(s, nqp, nj, 3, nj, 3)
            own = sel
        else:
            nqs = be.nq[sel].long()
            rep = torch.repeat_interleave(
                torch.arange(len(sel), device=sel.device), nqs)
            first = torch.cumsum(nqs, 0) - nqs
            qi = g[rep] + torch.arange(len(rep), device=sel.device) \
                - first[rep]
            Li = tables.R_i.shape[-1] // 2
            jr, jc = (3 * (k in (SELF_B, CROSS_BA)), 3 * (k in (SELF_B,
                                                               CROSS_AB)))
            R = tables.R_i[qi]                            # (t, 1, 6, 2Li)
            Rr = R[:, :, jr:jr + 3, jr // 3 * Li:(jr // 3 + 1) * Li]
            Rc = R[:, :, jc:jc + 3, jc // 3 * Li:(jc // 3 + 1) * Li]
            H = H_i[qi][:, :, 3 * jr:3 * jr + 9, 3 * jc:3 * jc + 9].reshape(
                -1, 1, 3, 3, 3, 3)
            nl = Li
            own = sel[rep]
        tmp = torch.einsum("gqjxky,gqkm->gqjxmy", H, Rc)
        Kb = torch.einsum("gqjxmy,gqjl->glxmy", tmp, Rr).reshape(
            -1, 3 * nl, 3 * nl)
        cps = be.cps[own].long()
        three = torch.arange(3, device=cps.device)
        ri = (3 * cps[:, 0, :nl, None] + three).reshape(-1, 3 * nl)
        ci = (3 * cps[:, 1, :nl, None] + three).reshape(-1, 3 * nl)
        ok = (ri[:, :, None] >= 0) & (ci[:, None, :] >= 0)
        idx = (be.dest[own][:, None, None] * n + ri[:, :, None]) * n \
            + ci[:, None, :]
        flat.index_put_((idx[ok],), Kb[ok], accumulate=True)


def _patch_assemble_plain(out, bt: BlockTables, tables, Hs):
    P, n = bt.free.shape
    flat = torch.zeros(P * n * n, dtype=DTYPE, device=out.device)
    _add_entries_plain(flat, bt.patch, tables, Hs, n)
    ok = bt.free > 0
    out.copy_(torch.where(ok[:, :, None] & ok[:, None, :],
                          flat.view(P, n, n), 0.0))
    out.diagonal(dim1=1, dim2=2).add_(1.0 - bt.free)


def _pair_assemble_plain(out, Kp, bt: BlockTables, tables, Hs):
    B, n = bt.pa.shape[0], bt.n
    flat = torch.zeros(B * 2 * n * n, dtype=DTYPE, device=out.device)
    _add_entries_plain(flat, bt.pair, tables, Hs, n)
    X = flat.view(B, 2, n, n)
    pa, pb = bt.pa.long(), bt.pb.long()
    fa, fb = bt.free[pa] > 0, bt.free[pb] > 0
    top = torch.where(fa[:, :, None] & fb[:, None, :], X[:, 0], 0.0)
    bot = torch.where(fb[:, :, None] & fa[:, None, :], X[:, 1], 0.0)
    out.copy_(torch.cat([torch.cat([Kp[pa], top], 2),
                         torch.cat([bot, Kp[pb]], 2)], 1))


def _check_entries(be: BlockEntries, n_dest, dev):
    S = be.kind.shape[0]
    for name, t, shape in (("kind", be.kind, (S,)), ("group", be.group, (S,)),
                           ("nq", be.nq, (S,)),
                           ("cps", be.cps, (S, 2, be.cps.shape[2])),
                           ("band_ptr", be.band_ptr,
                            (n_dest * be.n_bands + 1,)),
                           ("band_ent", be.band_ent, None)):
        _cuda.check(t, name, INDEX_DTYPE, shape, dev)


def _jet_args(tables, Hs):
    """(name, tensor, shape) of the jet tables K10 reads: shell, interface
    and pressure groups (None where the model has none)."""
    H_e, H_i, H_p = Hs[:3]
    G, Q, _, L = tables.R_e.shape
    out = [("H_e", H_e, (G, Q, 15, 15)), ("R_e", tables.R_e, (G, Q, 5, L))]
    GI = L2 = 0
    if tables.R_i is not None:
        GI, _, _, L2 = tables.R_i.shape
    out += [("H_i", H_i, (GI, 1, 18, 18)), ("R_i", tables.R_i, (GI, 1, 6, L2)),
            ("H_p", H_p, (G, Q, 9, 9)), ("R_p", tables.R_p, (G, Q, 3, L))]
    return out


def _check_jets(args, kinds, dev):
    need = {"H_e": True, "R_e": True,
            "H_i": bool({SELF_A, SELF_B, CROSS_AB, CROSS_BA} & set(kinds)),
            "H_p": PRESSURE in kinds}
    need.update(R_i=need["H_i"], R_p=need["H_p"])
    for name, t, shape in args:
        if t is None:
            if need[name]:
                raise ValueError(f"{name}: required by the K10 tables")
            continue
        _cuda.check(t, name, DTYPE, shape, dev)


def patch_assemble(out, tables, Hs, bt: BlockTables):
    """K10 stage 1: out (P, 3C, 3C) <- every patch block, masked by `free`
    both sides, with the identity on fixed dofs (every entry written).
    `tables`, `Hs`: `jet_tables`, `jet_hessians`."""
    P, n = bt.free.shape
    dev = bt.free.device
    _cuda.check(out, "out", DTYPE, (P, n, n), dev)
    args = _jet_args(tables, Hs)
    _check_jets(args, bt.patch.kinds, dev)
    _check_entries(bt.patch, P, dev)
    if not _cuda.on_cuda(out):
        _patch_assemble_plain(out, bt, tables, Hs)
        return out
    p = _cuda.ptr
    pt = bt.patch
    _, Q, _, L = tables.R_e.shape
    Li = 0 if tables.R_i is None else tables.R_i.shape[-1] // 2
    d = {name: t for name, t, _ in args}
    _cuda.launch("pair_assemble/patches", "gf_patch_assemble",
                 p(d["H_e"]), p(d["R_e"]), p(d["H_p"]), p(d["R_p"]),
                 p(d["H_i"]), p(d["R_i"]), p(pt.kind), p(pt.group), p(pt.nq),
                 p(pt.cps), p(pt.band_ptr), p(pt.band_ent), p(bt.free),
                 p(out), P, pt.n_bands, pt.band_rows, n, Q, L, Li,
                 pt.cps.shape[2], pt.stage, pt.tsz)
    return out


def pair_assemble(out, Kp, tables, Hs, bt: BlockTables):
    """K10 stage 2: out (B, 6C, 6C) <- pair block k = [[Kp[pa[k]], X],
    [X', Kp[pb[k]]]], X and X' its interface's cross quadrants masked by
    `free` (every entry written). Kp: stage 1's patch blocks."""
    B, n = bt.pa.shape[0], bt.n
    P = bt.free.shape[0]
    dev = bt.free.device
    _cuda.check(out, "out", DTYPE, (B, 2 * n, 2 * n), dev)
    _cuda.check(Kp, "Kp", DTYPE, (P, n, n), dev)
    args = [a for a in _jet_args(tables, Hs) if a[0] in ("H_i", "R_i")]
    _check_jets(args, bt.pair.kinds, dev)
    _check_entries(bt.pair, 2 * B, dev)
    for name, t in (("pa", bt.pa), ("pb", bt.pb)):
        _cuda.check(t, name, INDEX_DTYPE, (B,), dev)
    if not _cuda.on_cuda(out):
        _pair_assemble_plain(out, Kp, bt, tables, Hs)
        return out
    p = _cuda.ptr
    qt = bt.pair
    _cuda.launch("pair_assemble/pairs", "gf_pair_assemble", p(Kp),
                 p(Hs[1]), p(tables.R_i), p(qt.kind), p(qt.group), p(qt.nq),
                 p(qt.cps), p(qt.band_ptr), p(qt.band_ent), p(bt.pa),
                 p(bt.pb), p(bt.free), p(out), B, qt.n_bands, qt.band_rows,
                 n, tables.R_i.shape[-1] // 2, qt.cps.shape[2], qt.stage,
                 qt.tsz)
    return out


def _both_stages(bt: BlockTables, tables, Hs):
    """K10's stages in order: (Kp, Kpair), the (P, 3C, 3C) patch blocks
    and, where `bt` has pair tables, the (B, 6C, 6C) pair blocks built
    from them (else None)."""
    P, n = bt.free.shape
    Kp = patch_assemble(torch.empty(P, n, n, dtype=DTYPE,
                                    device=bt.free.device), tables, Hs, bt)
    if bt.pair is None:
        return Kp, None
    B = bt.pa.shape[0]
    return Kp, pair_assemble(torch.empty(B, 2 * n, 2 * n, dtype=DTYPE,
                                         device=Kp.device), Kp, tables, Hs,
                             bt)


def assemble_blocks(bt: BlockTables, tables, Hs):
    """K10: the (P, 3C, 3C) patch blocks, or where `bt` has pair tables
    the (B, 6C, 6C) pair blocks built from them, masked, with the identity
    on fixed dofs, from jet Hessians `Hs` (`jet_hessians`)."""
    Kp, Kpair = _both_stages(bt, tables, Hs)
    return Kp if Kpair is None else Kpair


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


# ------------------------------------------------------------ preconditioners
def patch_block_precond(data: SystemData, d, cp, h, tables=None, Hs=None,
                        bt=None):
    """Factored per-patch diagonal blocks of K: (lu, piv, dsc) with lu
    (P, 3C, 3C) f64. The same-patch quadrants of the interface penalty
    Hessians are included: they anchor the rigid-body modes of patches
    without Dirichlet BCs. Contact is left out, as in the reference. `bt`:
    the `_block_tables(data)` of earlier calls."""
    tables = jet_tables(data) if tables is None else tables
    Hs = jet_hessians(data, d, cp, h) if Hs is None else Hs
    bt = _block_tables(data) if bt is None else bt
    lu, piv, dsc, _ = _factor(assemble_blocks(bt, tables, Hs))
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
    """Equilibrated f64 LU of the full dense tangent (K3 assembly, with
    contact K12 mode 2). Replaces the reference's f32 variant
    (`full_f32_precond`), whose f32 assembly only saved TPU memory."""
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
        # the reference asserts the same: a model without interfaces (the
        # contact press) has no pairs to sweep
        assert data.ifs is not None and data.ifs.n_interfaces > 0, \
            "PairSchwarz: the model has no interface pairs"
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
        self.tables = jet_tables(data)
        self.blocks = _block_tables(data, order=self.order)
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
        """Factored pair blocks at state d: (lu, piv, dsc, iso, info). K10
        sums the patch blocks once (an isolated patch's block is its own)
        and composes the pair blocks from them."""
        Hs = jet_hessians(data, d, cp, h) if Hs is None else Hs
        Kp, Kpair = _both_stages(self.blocks, self.tables, Hs)
        lu, piv, dsc, info = _factor(Kpair)
        del Kpair
        iso = None
        if len(self.iso):
            lui, pivi, dsi, infi = _factor(Kp[self._iso_idx])
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
    tables = precond[0].tables if isinstance(precond[0], PairSchwarz) \
        else jet_tables(data)
    Hs = jet_hessians(data, d, cp, h)
    op = lambda v: tangent_matvec_from(tables, Hs, v)    # noqa: E731
    return _gmres_ir(op, _mop(precond, op), b, rtol, restart, maxiter, n_ir)


# ------------------------------------------------------------ Newton
class NewtonKrylovFailure(RuntimeError):
    """The Newton-Krylov solve ended without convergence."""


PRECONDS = ("full", "patch", "pair_schwarz")


def _precond_builder(data, precond, tables, schwarz=None):
    """(d, cp, h, Hs) -> the GMRES preconditioner at d, by name: "full"
    the dense LU (`full_precond`), "patch" the patch blocks
    (`patch_block_precond`, K10's tables built here once), "pair_schwarz"
    the factored pair blocks of `schwarz`."""
    if precond == "pair_schwarz":
        return lambda d, cp, h, Hs: (schwarz, schwarz.assemble(
            data, d, cp, h, Hs=Hs))
    if precond == "full":
        return lambda d, cp, h, Hs: full_precond(data, d, cp, h,
                                                 tables=tables, Hs=Hs)
    if precond == "patch":
        bt = _block_tables(data)
        return lambda d, cp, h, Hs: patch_block_precond(
            data, d, cp, h, tables=tables, Hs=Hs, bt=bt)
    raise ValueError(f"precond: {precond!r}, expected one of {PRECONDS}")


def _newton_once(data, cp, h, d0, rtol, cg_rtol, max_newton, max_cg,
                 make_pre, tables, log):
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
        precond = make_pre(d, cp, h, Hs)
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
                        schwarz: PairSchwarz | None = None, log=None,
                        precond="full"):
    """Matrix-free damped Newton-Krylov (large-model forward solve).

    The reference's globalization as a host loop: |r(0)| as the scale, a
    GMRES direction (restart 32, max_cg // 32 + 1 cycles, 3 refinement
    passes) with the preconditioner refreshed every iteration (pair-Schwarz
    when `schwarz` is given, else `precond`: "full", the dense LU, or
    "patch", the patch blocks), the `done` slope test, and
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
    if schwarz is not None:
        tables, precond = schwarz.tables, "pair_schwarz"
    else:
        tables = jet_tables(data)
    make_pre = _precond_builder(data, precond, tables, schwarz)
    args = (rtol, cg_rtol, max_newton, max_cg, make_pre, tables, log)
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
    """State of one solve function: the preconditioner (`precond`, its
    builder `make_pre`, the pair-Schwarz structure or None), the
    tolerances and the last solves' statistics."""

    def __init__(self, data, rtol, cg_rtol, max_newton, max_cg, precond):
        if precond not in PRECONDS:
            raise ValueError(f"precond: {precond!r}, expected one of "
                             f"{PRECONDS}")
        self.data = data
        self.schwarz = PairSchwarz(data) if precond == "pair_schwarz" \
            else None
        self.tables = self.schwarz.tables if self.schwarz is not None \
            else jet_tables(data)
        self.precond = precond
        self.make_pre = _precond_builder(data, precond, self.tables,
                                         self.schwarz)
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
            schwarz=self.schwarz, log=log, precond=self.precond)
        self.last_its, self.last_log = its, log
        return d

    def adjoint(self, d, cp, h, g):
        """(dcp, dh) = -lam^T dR/d(cp, h) with K(d) lam = g by GMRES-IR."""
        data = self.data
        Hs = jet_hessians(data, d, cp, h)
        op = lambda v: tangent_matvec_from(self.tables, Hs, v)  # noqa: E731
        pre = self.make_pre(d, cp, h, Hs)
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
    None)` uses (O(N^2) memory), "patch", the patch blocks of
    `patch_block_precond` (block Jacobi), or "pair_schwarz", the
    reference's coloured multiplicative pair-Schwarz (no dense (N, N)
    matrix anywhere), which converges only on models of a few patches (the
    3-patch plate; on wings and box wings its GMRES stalls and the solve
    raises `NewtonKrylovFailure`) and, as the reference's, refuses a model
    without interfaces. With contact the matvec, the line search, the dense
    preconditioner and the adjoint's VJP carry it; the block
    preconditioners leave it out. The solver state (`schwarz`, `last_its`,
    `last_log`, `adjoint_cycles`) is `solve.solver`."""
    solver = _KrylovSolver(data, rtol, cg_rtol, max_newton, max_cg, precond)

    def solve(cp, h, d0):
        return _KrylovSolve.apply(solver, cp, h, d0)

    solve.solver = solver
    return solve
