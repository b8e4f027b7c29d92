"""K10 pair_assemble: the patch blocks summed once, the pair blocks composed
from them (goldfish_tpu_torch/csrc/pair_assemble.cu,
goldfish_tpu_torch/solver/krylov.py).

Models: the small box wing `boxwing.build(n_sections=2, num_el=2, p=2)` (11
patches, 24 interfaces, C = 20), its JAX dense K compiled once for the
module; the small pressurized tube (`tube.build(num_el=3, p=3, pressure)`,
4 patches) for the follower-pressure entries, held to the port's own dense
K (`system.assemble_K_from`, which tests/test_torch_pressure.py holds to the
JAX package).

- (a) the plain pair and patch blocks against the JAX dense K's principal
  submatrices at the Newton state (1e-12 of max |K|);
- (b) the plain blocks against the parent tree's per-slot scatter, kept
  below as `_parent_blocks` (1e-13 of max |K|);
- (c) every pair block's diagonal quadrants are its patches' blocks, bit
  for bit;
- (d) the tables the kernels rely on: every real element once for its
  patch, every real interface qp once per side and once per direction of
  its interface's cross quadrant, each group's locals on distinct CPs, each
  run's CPs those of every qp in it, and the band lists holding exactly
  the (entry, band) pairs whose row locals meet, at bands small enough to
  split the blocks; a band that cannot fit in shared memory raises;
- (e) the tube's pair and patch blocks (pressure Hessians through the
  element entries) against its dense K (1e-12 of max |K|);
- (f) on the card (`gpu`, skipped here): both kernels against their plain
  versions (1e-13 relative in norm) at the box wing, with bands of 6 rows,
  at a p = 4 plate (3 (l, m) pairs a thread) and at the tube, and bit for
  bit over 5 launches. Run them there with `python -m pytest
  tests/test_torch_k10.py -m gpu --noconftest -q`.
"""

import numpy as np
import pytest
import torch

from _torch_port_common import TUBE_SMALL

BW_SMALL = dict(n_sections=2, num_el=2, p=2)
TOL = 1e-12
PARENT_TOL = 1e-13


def _bands_of(monkeypatch, rows, n):
    """Shrink or widen K10's bands to `rows` rows of an n-dof block."""
    from goldfish_tpu_torch.solver import krylov

    if rows is not None:
        monkeypatch.setattr(krylov, "BAND_BYTES", 8 * n * rows)


@pytest.fixture(scope="module")
def port_bw():
    from goldfish_tpu_torch.models import boxwing

    return boxwing.build(**BW_SMALL, device="cpu")


@pytest.fixture(scope="module")
def newton_state(port_bw):
    """The port's dense-route Newton solution at the start design."""
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.implicit import newton_solve_host

    s = port_bw
    d, _, _ = newton_solve_host(s.data, PersistentDeviceFactor(s.data), s.cp,
                                s.h_init, s.zero_displacement(), rtol=1e-10)
    return d


@pytest.fixture(scope="module")
def bw(port_bw, newton_state):
    """(system, PairSchwarz, Hs, patch blocks, pair blocks) at the Newton
    state, through the plain versions."""
    from goldfish_tpu_torch.solver import krylov, system

    s = port_bw
    ps = krylov.PairSchwarz(s.data)
    Hs = system.jet_hessians(s.data, newton_state, s.cp, s.h_init)
    Kp = krylov.assemble_blocks(krylov._block_tables(s.data), ps.tables, Hs)
    Kpair = krylov.assemble_blocks(ps.blocks, ps.tables, Hs)
    return s, ps, Hs, Kp, Kpair


@pytest.fixture(scope="module")
def jax_K(newton_state):
    import jax.numpy as jnp

    from goldfish_tpu.models import boxwing
    from goldfish_tpu.solver.implicit import _jit_assemble_K

    s = boxwing.build(**BW_SMALL)
    return np.asarray(_jit_assemble_K(s.data, s.cp, s.h_init,
                                      jnp.asarray(newton_state.numpy())))


def _dofs(ps, n):
    return [np.r_[ps.pairA[i] * n + np.arange(n),
                  ps.pairB[i] * n + np.arange(n)] for i in ps.order]


def _held_to(K, Kp, Kpair, ps, n, tol):
    scale = np.abs(K).max()
    for p, blk in enumerate(Kp.numpy()):
        idx = p * n + np.arange(n)
        assert np.abs(blk - K[np.ix_(idx, idx)]).max() <= tol * scale
    for blk, idx in zip(Kpair.numpy(), _dofs(ps, n)):
        assert np.abs(blk - K[np.ix_(idx, idx)]).max() <= tol * scale


# ------------------------------------------------------------ the parent
def _parent_blocks(data, Hs, tables, order=None):
    """The parent tree's K10 formula: every group's B^T H B added, slot by
    slot, to every block that holds its patch (pair block k = interface
    order[k] takes its qps' whole 6L x 6L block, every other block of a
    side that side's quadrant), fixed dofs skipped, then the identity on
    them."""
    stack, ifs = data.stack, data.ifs
    P, E, Q, L = stack.R00.shape
    n = 3 * stack.max_cp
    conn = stack.conn.numpy().astype(np.int64)
    real_e = stack.wq.numpy().sum(-1) > 0
    free = data.free.numpy()
    pa, pb = ifs.pairA.numpy(), ifs.pairB.numpy()
    if order is None:
        of_patch = [[(p, 0)] for p in range(P)]
        nb, B, whole = n, P, None
    else:
        whole = np.empty(len(order), np.int64)
        whole[order] = np.arange(len(order))
        of_patch = [[] for _ in range(P)]
        for i in range(len(order)):
            of_patch[pa[i]].append((int(whole[i]), 0))
            of_patch[pb[i]].append((int(whole[i]), n))
        nb, B = 2 * n, len(order)
    out = torch.zeros(B * nb * nb, dtype=torch.float64)

    def maps(c, p, off):
        dof = c[..., None] * 3 + np.arange(3)
        ok = free[p].reshape(-1)[dof] > 0
        return np.where(ok, dof + off, -1).reshape(c.shape[0], -1)

    def scatter(H, R, g, blk, mp):
        G, nq, nj, nloc = R.shape
        Hr = H[g].reshape(-1, nq, nj, 3, nj, 3)
        tmp = torch.einsum("gqjxky,gqkm->gqjxmy", Hr, R[g])
        Kg = torch.einsum("gqjxmy,gqjl->glxmy", tmp, R[g]).reshape(
            -1, 3 * nloc, 3 * nloc)
        mp = torch.from_numpy(mp)
        ok = (mp[:, :, None] >= 0) & (mp[:, None, :] >= 0)
        idx = (blk * nb + mp[:, :, None]) * nb + mp[:, None, :]
        out.index_put_((idx[ok],), Kg[ok], accumulate=True)

    for p in range(P):
        es = np.nonzero(real_e[p])[0]
        for blk, off in of_patch[p]:
            g = torch.from_numpy(p * E + es)
            scatter(Hs[0], tables.R_e, g, blk, maps(conn[p, es], p, off))
            if Hs[2] is not None:
                scatter(Hs[2], tables.R_p, g, blk, maps(conn[p, es], p, off))
    I_, Nq, _ = ifs.RA00.shape
    ca, cb = ifs.connA.numpy(), ifs.connB.numpy()
    real_q = ifs.w.numpy() > 0
    for i in range(I_):
        qs = np.nonzero(real_q[i])[0]
        g = torch.from_numpy(i * Nq + qs)
        none = np.full((len(qs), 3 * ca.shape[-1]), -1)
        for blk, off in of_patch[pa[i]]:
            mB = none
            if whole is not None and blk == whole[i]:
                mB = maps(cb[i, qs], pb[i], dict(of_patch[pb[i]])[blk])
            scatter(Hs[1], tables.R_i, g, blk,
                    np.concatenate([maps(ca[i, qs], pa[i], off), mB], 1))
        for blk, off in of_patch[pb[i]]:
            if whole is None or blk != whole[i]:
                scatter(Hs[1], tables.R_i, g, blk, np.concatenate(
                    [none, maps(cb[i, qs], pb[i], off)], 1))
    out = out.view(B, nb, nb)
    fb = np.zeros((B, nb))
    for p in range(P):
        for blk, off in of_patch[p]:
            fb[blk, off:off + n] = free[p].reshape(-1)
    out.diagonal(dim1=1, dim2=2).add_(1.0 - torch.from_numpy(fb))
    return out


# ------------------------------------------------------------ (a)-(c)
def test_blocks_are_principal_submatrices_of_the_jax_K(bw, jax_K):
    """(a) Patch block p is K's diagonal block; pair block k is K's
    principal submatrix on its two patches' dofs (one interface links any
    two patches of the box wing)."""
    from goldfish_tpu_torch import _cuda

    s, ps, _, Kp, Kpair = bw
    assert all(v == 0 for v in _cuda.launch_counts.values())
    assert Kp.shape == (s.stack.n_patches, 60, 60)
    assert Kpair.shape == (ps.I, 120, 120)
    _held_to(jax_K, Kp, Kpair, ps, 60, TOL)


@pytest.mark.parametrize("which", ["patches", "pairs"])
def test_blocks_equal_the_parent_formula(bw, which):
    """(b) The redesign computes the parent's function, to rounding."""
    s, ps, Hs, Kp, Kpair = bw
    got = Kp if which == "patches" else Kpair
    ref = _parent_blocks(s.data, Hs, ps.tables,
                         None if which == "patches" else ps.order)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= PARENT_TOL * scale


def test_pair_quadrants_are_the_patch_blocks_bit_for_bit(bw):
    """(c) A pair block's diagonal quadrants are copies of stage 1."""
    _, ps, _, Kp, Kpair = bw
    n = Kp.shape[1]
    for k, i in enumerate(ps.order):
        assert torch.equal(Kpair[k, :n, :n], Kp[ps.pairA[i]])
        assert torch.equal(Kpair[k, n:, n:], Kp[ps.pairB[i]])


# ------------------------------------------------------------ (d)
def _entries(be):
    return (be.kind.numpy(), be.group.numpy(), be.nq.numpy(),
            be.cps.numpy(), be.dest.numpy())


def test_every_group_is_listed_once_with_its_cps(bw):
    """(d) Stage 1 lists every real element once for its patch and every
    real interface qp once per side; stage 2 every real qp once per
    direction of its own block's cross quadrant. A run's CPs are those of
    each of its qps; no group puts two locals on one CP."""
    from goldfish_tpu_torch.solver import krylov as k

    s, ps, _, _, _ = bw
    st, ifs = s.stack, s.data.ifs
    P, E, Q, L = st.R00.shape
    I_, Nq, _ = ifs.RA00.shape
    conn = st.conn.numpy()
    ca, cb = ifs.connA.numpy(), ifs.connB.numpy()
    pa, pb = ifs.pairA.numpy(), ifs.pairB.numpy()
    real_e = np.nonzero(st.wq.numpy().sum(-1).reshape(-1) > 0)[0]
    real_q = np.nonzero(ifs.w.numpy().reshape(-1) > 0)[0]
    slot = np.empty(I_, np.int64)
    slot[ps.order] = np.arange(I_)
    kind, group, nq, cps, dest = _entries(ps.blocks.patch)
    sh = kind == k.SHELL
    assert sorted(group[sh]) == sorted(real_e)
    assert (nq[sh] == Q).all() and (dest[sh] == group[sh] // E).all()
    for e in np.nonzero(sh)[0]:
        c = conn.reshape(P * E, L)[group[e]]
        assert (cps[e, 0, :L] == c).all() and (cps[e, 1, :L] == c).all()
    seen = {}
    for name, be in (("patch", ps.blocks.patch), ("pair", ps.blocks.pair)):
        kind, group, nq, cps, dest = _entries(be)
        for e in np.nonzero(kind >= k.SELF_A)[0]:
            qs = group[e] + np.arange(nq[e])
            i = int(qs[0] // Nq)
            assert (qs // Nq == i).all()
            rows_b = kind[e] in (k.SELF_B, k.CROSS_BA)
            cols_b = kind[e] in (k.SELF_B, k.CROSS_AB)
            cr = (cb if rows_b else ca).reshape(I_ * Nq, -1)[qs]
            cc = (cb if cols_b else ca).reshape(I_ * Nq, -1)[qs]
            assert (cr == cps[e, 0, :cr.shape[1]]).all()
            assert (cc == cps[e, 1, :cc.shape[1]]).all()
            want = {k.SELF_A: pa[i], k.SELF_B: pb[i],
                    k.CROSS_AB: 2 * slot[i], k.CROSS_BA: 2 * slot[i] + 1}
            assert dest[e] == want[kind[e]]
            for q in qs:
                seen[(int(kind[e]), int(q))] = seen.get(
                    (int(kind[e]), int(q)), 0) + 1
        for side in (0, 1):
            srt = np.sort(cps[:, side], axis=1)
            assert not ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).any()
    for kd in (k.SELF_A, k.SELF_B, k.CROSS_AB, k.CROSS_BA):
        assert sorted(q for (kk, q) in seen if kk == kd) == sorted(real_q)
    assert set(seen.values()) == {1}


@pytest.mark.parametrize("band_rows", [6, 15])
def test_band_lists_hold_exactly_the_entries_that_meet_a_band(bw,
                                                              band_rows,
                                                              monkeypatch):
    """(d) At bands of 6 and 15 rows (10 and 4 bands of the 60-row patch
    blocks), band t of destination d lists, in entry order, exactly the
    entries of d with a row local on a CP of rows t R .. t R + R - 1."""
    from goldfish_tpu_torch.solver import krylov

    s, ps, _, _, _ = bw
    _bands_of(monkeypatch, band_rows, 60)
    bt = krylov._block_tables(s.data, order=ps.order)
    for be, n_dest in ((bt.patch, s.stack.n_patches), (bt.pair, 2 * ps.I)):
        assert be.band_rows == band_rows and be.n_bands == -(-60 // band_rows)
        _, _, _, cps, dest = _entries(be)
        ptr, ent = be.band_ptr.numpy(), be.band_ent.numpy()
        assert len(ptr) == n_dest * be.n_bands + 1
        for key in range(n_dest * be.n_bands):
            d, t = divmod(key, be.n_bands)
            rows = 3 * cps[:, 0]
            meet = ((rows >= t * band_rows) & (rows < (t + 1) * band_rows)
                    & (cps[:, 0] >= 0)).any(1) & (dest == d)
            assert ent[ptr[key]:ptr[key + 1]].tolist() == \
                np.nonzero(meet)[0].tolist()


def test_band_size_and_its_limit(monkeypatch):
    """The default bands of the 20-patch wing's 330-row patch blocks fit a
    block's shared memory and hold whole CPs; one band of all 330 rows
    (871 KB) raises."""
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.solver import krylov

    data = wing.build(num_el=6, p=3, device="cpu").data
    bt = krylov._block_tables(data)
    be = bt.patch
    assert bt.n == 330 and be.n_bands * be.band_rows >= 330
    assert be.band_rows % 3 == 0
    smem = be.band_rows * 330 * 8 + (be.stage + be.tsz) * 8 + 97 * 4
    assert smem <= krylov.SMEM_MAX
    _bands_of(monkeypatch, 330, 330)
    with pytest.raises(ValueError):
        krylov._block_tables(data)


def test_shared_memory_layout_matches_the_kernel_source():
    """The wrapper sizes each block's shared memory from the constants
    the kernel carves it with: both must state the same numbers."""
    import os
    import re

    from goldfish_tpu_torch.solver import krylov

    path = os.path.join(os.path.dirname(krylov.__file__), os.pardir, "csrc",
                        "pair_assemble.cu")
    with open(path) as fh:
        src = fh.read()

    def const(name):   # ML is 16
        expr = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);",
                         src).group(1)
        return eval(expr.replace("ML", "16"))

    assert (const("QC"), const("MAX_LOC"), const("NINT"), const("SMEM_MAX"),
            const("RP"), const("TP")) == (krylov.QC, krylov.MAX_LOC,
                                          krylov._NINT, krylov.SMEM_MAX,
                                          krylov._RP, krylov._TP)


# ------------------------------------------------------------ (e)
@pytest.fixture(scope="module")
def tube_blocks():
    from goldfish_tpu_torch.models import tube
    from goldfish_tpu_torch.solver import krylov, system

    s = tube.build(**TUBE_SMALL, pressure=5.0e2, device="cpu")
    rng = np.random.default_rng(3)
    scale = float(torch.linalg.norm(s.cp)) / np.sqrt(s.cp.numel())
    d = torch.from_numpy(1e-3 * scale * rng.normal(
        size=tuple(s.cp.shape))) * s.data.free
    ps = krylov.PairSchwarz(s.data)
    Hs = system.jet_hessians(s.data, d, s.cp, s.h_init)
    return s, ps, Hs


def test_pressure_blocks_are_principal_submatrices(tube_blocks):
    """(e) With a follower pressure the element entries carry H_p too."""
    from goldfish_tpu_torch.solver import krylov, system

    s, ps, Hs = tube_blocks
    assert Hs[2] is not None and krylov.PRESSURE in ps.blocks.patch.kinds
    K = system.assemble_K_from(ps.tables, Hs).numpy()
    Kp = krylov.assemble_blocks(krylov._block_tables(s.data), ps.tables, Hs)
    Kpair = krylov.assemble_blocks(ps.blocks, ps.tables, Hs)
    _held_to(K, Kp, Kpair, ps, Kp.shape[1], TOL)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _system(name, dev):
    from goldfish_tpu_torch.models import boxwing, plate, tube

    if name == "plate-p4":
        return plate.build(num_el=3, p=4, num_patches=3, device=dev)
    if name == "tube":
        return tube.build(**TUBE_SMALL, pressure=5.0e2, device=dev)
    return boxwing.build(**BW_SMALL, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name,band_rows", [("boxwing", None),
                                            ("boxwing", 6),
                                            ("plate-p4", None),
                                            ("tube", None)])
def test_kernels_match_plain_and_are_bitwise_on_the_card(cuda, name,
                                                         band_rows,
                                                         monkeypatch):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver import krylov, system

    s = _system(name, cuda)
    rng = np.random.default_rng(5)
    scale = float(torch.linalg.norm(s.cp)) / np.sqrt(s.cp.numel())
    d = torch.tensor(1e-3 * scale * rng.normal(size=tuple(s.cp.shape)),
                     device=cuda) * s.data.free
    ps = krylov.PairSchwarz(s.data)
    _bands_of(monkeypatch, band_rows, 3 * s.data.stack.max_cp)
    bt = krylov._block_tables(s.data, order=ps.order)
    if band_rows is not None:
        assert bt.patch.band_rows == band_rows
    Hs = system.jet_hessians(s.data, d, s.cp, s.h_init)
    P, n = bt.free.shape
    n0 = dict(_cuda.launch_counts)
    outs = [krylov.assemble_blocks(bt, ps.tables, Hs) for _ in range(5)]
    assert _cuda.launch_counts["pair_assemble/patches"] == \
        n0["pair_assemble/patches"] + 5
    assert _cuda.launch_counts["pair_assemble/pairs"] == \
        n0["pair_assemble/pairs"] + 5
    Kp = krylov.patch_assemble(torch.empty(P, n, n, dtype=torch.float64,
                                           device=cuda), ps.tables, Hs, bt)
    Kq = torch.empty_like(Kp)
    krylov._patch_assemble_plain(Kq, bt, ps.tables, Hs)
    Xq = torch.empty_like(outs[0])
    krylov._pair_assemble_plain(Xq, Kq, bt, ps.tables, Hs)
    for got, ref in ((Kp, Kq), (outs[0], Xq)):
        assert float(torch.linalg.norm(got - ref)
                     / torch.linalg.norm(ref)) <= 1e-13
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
