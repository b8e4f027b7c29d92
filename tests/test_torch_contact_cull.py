"""The premises of K12's cull and K3's runs, on the CPU.

K12 (csrc/contact_pairs.cu) lists the cell pairs that may hold a qp pair
within r_max and works on that list only; `contact.candidate_pairs` is the
list's plain twin. K3 (csrc/jet_assemble.cu) sums each run of consecutive
groups with the same dof map before it adds to K; `system.jet_runs` finds
the same runs.

- At the press at num_el=4 (the JAX package's system, bridged), at two
  contact-active states: every qp pair with w_a w_b != 0 and r < r_max lies
  in a listed element pair; W_c summed over the listed pairs only equals
  the JAX package's contact_energy (1e-13); the list holds less than half
  of all element pairs.
- A seeded adversarial cloud with qp pairs at r_max (1 -+ 1e-9), zero
  weights, a ragged last cell and a self pair: the same, for cells of one
  and of two clusters.
- On the small wing's interface groups, summing each run of identical dof
  maps first and then assembling with K3's plain version gives the
  per-qp K (1e-13); the runs cover every group exactly once.

CPU runs launch no kernel."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import WING_SMALL, press_state, rel, seeded_state, t

RM = 0.1


def _within(contact, x, w):
    """(k, a, b) of every qp pair with w_a w_b != 0 and r < r_max, r as
    K12's pair_pot and the plain versions form it."""
    out = []
    for k, (A, B) in enumerate(zip(contact.pa.tolist(),
                                   contact.pb.tolist())):
        dx = x[A][:, None, :] - x[B][None, :, :]
        d2 = (dx[..., 0] * dx[..., 0] + dx[..., 1] * dx[..., 1]) \
            + dx[..., 2] * dx[..., 2]
        live = (float(contact.r_max[k]) - torch.sqrt(d2 + 1e-30) > 0) \
            & (w[A][:, None] * w[B][None, :] != 0)
        a, b = live.nonzero(as_tuple=True)
        out.append(torch.stack([torch.full_like(a, k), a, b], 1))
    return torch.cat(out)


def _cell_index(pairs, q, ncell):
    k, a, b = pairs.unbind(1)
    return (k * ncell + a // q) * ncell + b // q


def _listed_energy(contact, x, w, idx, q):
    """W_c summed over the qp pairs of the listed cell pairs only."""
    EQ = w.shape[1]
    ncell = -(-EQ // q)
    W = torch.zeros((), dtype=x.dtype)
    for k, (A, B) in enumerate(zip(contact.pa.tolist(),
                                   contact.pb.tolist())):
        mine = idx[idx // (ncell * ncell) == k] % (ncell * ncell)
        cells = torch.zeros(ncell, ncell, dtype=torch.bool)
        cells[mine // ncell, mine % ncell] = True
        cell_of = torch.arange(EQ) // q
        mask = cells[cell_of][:, cell_of]
        dx = x[A][:, None, :] - x[B][None, :, :]
        r = torch.sqrt((dx * dx).sum(-1) + 1e-30)
        gap = torch.clamp(contact.r_max[k] - r, min=0.0)
        phi = contact.k_pen[k] / 6.0 * gap ** 3
        W = W + (phi * w[A][:, None] * w[B][None, :] * mask).sum()
    return W


@pytest.fixture(scope="module")
def press4():
    """(JAX system, port SystemData) of the press at num_el=4."""
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from test_contact import _press_problem

    s = _press_problem(num_el=4)
    return s, from_numpy_tree(s.data, device="cpu")


@pytest.mark.parametrize("drop", [0.03, 0.05])
def test_cull_keeps_every_pair_within_r_max_at_the_press(press4, drop):
    from goldfish_tpu.physics.contact import contact_energy as jax_energy
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import contact

    s, data = press4
    cp, _, d, _, _ = press_state(s, seed=5, drop=drop)
    _, E, Q, _ = data.stack.R00.shape
    c = data.contact
    x, w = contact.contact_qps(data.stack, t(d), t(cp))
    _cuda.reset_launch_counts()
    idx = contact.candidate_pairs(c, x, w, Q)
    cells = contact.contact_cells(c, x, w, Q)
    assert torch.equal(cells.index.long(), idx)
    assert int(cells.count) == idx.numel() and cells.cell == Q
    within = _within(c, x, w)
    assert within.shape[0] > 0
    assert bool(torch.isin(_cell_index(within, Q, E), idx).all())
    assert idx.numel() < 0.5 * E * E
    W_ref = float(jax_energy(s.data.contact, s.stack, jnp.asarray(d),
                             jnp.asarray(cp)))
    W = float(_listed_energy(c, x, w, idx, Q))
    assert W_ref > 0.0 and abs(W - W_ref) <= 1e-13 * W_ref
    assert all(n == 0 for n in _cuda.launch_counts.values())


def _cutoff_cloud(seed, q=6, couples=12):
    """One patch of `couples` cell pairs (a left cell at x <= 0, a right
    cell at x >= r_j, both at y = j, 1.0 apart in y from the next couple),
    whose nearest qp pair is (0, j, 0)-(r_j, j, 0), r_j = r_max (1 -+
    1e-9); a second patch with the same points and other weights (some
    cells and some qps zero); the last cell cut by two qps."""
    rng = np.random.default_rng(seed)
    x = np.zeros((2 * couples, q, 3))
    r = RM * (1.0 + 1e-9 * rng.choice([-1.0, 1.0], size=couples))
    for j in range(couples):
        for side, cell in ((0, x[2 * j]), (1, x[2 * j + 1])):
            cell[:, 0] = rng.uniform(0.0, 0.03, q) * (1 if side else -1)
            cell[:, 1] = j + rng.uniform(-0.02, 0.02, q)
            cell[:, 2] = rng.uniform(-0.02, 0.02, q)
            cell[0] = (0.0, j, 0.0)
            if side:
                cell[:, 0] += r[j]
    x = np.broadcast_to(x.reshape(1, -1, 3), (2, 2 * couples * q, 3))
    w = rng.uniform(0.5, 1.5, size=x.shape[:2])
    w[1, 2 * q:3 * q] = 0.0                        # a cell of zero weights
    w[1, rng.integers(0, w.shape[1], 8)] = 0.0     # zero-weight qps
    w[0, 4 * q] = 0.0                              # an extremal qp
    return t(x[:, :-2]).contiguous(), t(w[:, :-2]).contiguous(), r


@pytest.mark.parametrize("seed,cells", [(11, 1), (12, 2)])
def test_cull_is_exact_at_the_cutoff(seed, cells):
    from goldfish_tpu_torch.physics import contact

    q = 6
    x, w, r = _cutoff_cloud(seed, q)
    c = contact.build_contact([(0, 1), (0, 0)], 1e7, RM, device="cpu")
    nc = cells * q
    EQ = w.shape[1]
    ncell = -(-EQ // nc)
    idx = contact.candidate_pairs(c, x, w, nc)
    within = _within(c, x, w)
    assert bool(torch.isin(_cell_index(within, nc, ncell), idx).all())
    # both sides of the cutoff occur: couples just inside r_max give qp
    # pairs within it, those just outside are dropped (one cluster a cell)
    assert (r < RM).any() and (r > RM).any()
    if cells == 1:
        left = torch.tensor(np.flatnonzero(r > RM) * 2)
        assert not bool(torch.isin(left * ncell + left + 1, idx).any())
        assert bool(torch.isin(ncell * ncell + left * ncell + left + 1,
                               idx).logical_not().all())
    # the self pair lists (e, f) and (f, e)
    self_ = idx[idx >= ncell * ncell] - ncell * ncell
    pairs = set(zip((self_ // ncell).tolist(), (self_ % ncell).tolist()))
    assert all((b, a) in pairs for a, b in pairs)
    W, _, _ = contact._value_grad_plain(c, x, w)
    assert float(W) > 0.0
    assert abs(float(_listed_energy(c, x, w, idx, nc)) - float(W)) \
        <= 1e-13 * float(W)


def test_run_merged_assembly_matches_per_qp_assembly():
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.solver import system

    s = wing.build(**WING_SMALL, device="cpu")
    cp, h, d, _, _ = seeded_state(3, s)
    tab = system.jet_tables(s.data)
    Hs = system.jet_hessians(s.data, t(d), t(cp), t(h))
    H, R, gi, free = Hs.H_i, tab.R_i, tab.gi_i, tab.free
    G, nq, nj, nloc = R.shape
    starts, lengths = system.jet_runs(gi)
    # the runs cover every group once, in order, and are maximal
    assert int(lengths.sum()) == G and int(starts[0]) == 0
    assert torch.equal(starts[1:], starts[:-1] + lengths[:-1])
    for s0, ln in zip(starts.tolist(), lengths.tolist()):
        assert bool((gi[s0:s0 + ln] == gi[s0]).all())
    assert bool((gi[starts[1:]] != gi[starts[:-1]]).any(1).all())
    assert int(lengths.max()) > 1
    N = free.numel()
    K0 = torch.zeros(N, N, dtype=torch.float64)
    system._assemble_plain(K0, H, R, gi, free)
    n = int(lengths.max()) * nq
    Hm = H.new_zeros(starts.numel(), n, 3 * nj, 3 * nj)
    Rm = R.new_zeros(starts.numel(), n, nj, nloc)
    for i, (s0, ln) in enumerate(zip(starts.tolist(), lengths.tolist())):
        Hm[i, :ln * nq] = H[s0:s0 + ln].reshape(ln * nq, 3 * nj, 3 * nj)
        Rm[i, :ln * nq] = R[s0:s0 + ln].reshape(ln * nq, nj, nloc)
    K1 = torch.zeros(N, N, dtype=torch.float64)
    system._assemble_plain(K1, Hm, Rm, gi[starts].contiguous(), free)
    assert float(K0.abs().max()) > 0.0
    assert rel(K1, K0.numpy()) <= 1e-13
