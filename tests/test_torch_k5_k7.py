"""The premises of K7 c2x_res_jac's fused Newton step and adjoint and of K5
traced_rows' closed-form rows, and the VLM lattice's reuse of its rows.

- K7's rows in closed form (csrc/c2x_res_jac.cu: `owner_rows`): a torch
  transcription builds dR/dx from the points' S and dS/dxi with the
  coincidence rows +-e_m, the spacing rows' 2 s0, -2 (s0 + s1), 2 s1 and
  the edge projection's t^ and (c - (c . t^) t^) / |t|; it equals the JAX
  package's `_c2x_jac` (jax.jacfwd of the residual) on the T-beam seam and
  on a seam along an edge of both patches, and the same derivatives pulled
  back to the control points equal the plain version's autograd (1e-12).
- K7's in-block solve (`lu_solve`): a transcription of its elimination
  (pivot the largest |entry| among rows not yet pivoted, ties to the lower
  row, rows never moved, the pivots' reciprocals; the back substitution in
  blocks of 32 unknowns in pivot order) solves J dx = -r and J^T lam = g of
  the JAX package's `_c2x_res_jac` as np.linalg.solve does (1e-12).
- The plain step and adjoint (the kernel's plain versions) against the JAX
  direct composition (`_c2x_res_jac`, solve, `_c2x_res`; and
  `_c2x_adjoint_direct`), 1e-12 and 1e-9; `c2x_newton`'s loop against the
  JAX direct-mode `_c2x_newton` from xi0 and warm after a 1e-3 amplitude
  step: equal iterations, x within 1e-10.
- K5's rows (csrc/bspline_rows.cuh): a transcription of the span by the
  count of span starts <= u and of Piegl & Tiller A2.3's values and first
  derivatives gives conn bit for bit and R0, dR/dxi to 1e-13 against
  jax.jacfwd of `bspline_jax.surface_basis` at random, on-knot, one-ulp
  and end points.
- `vlm.lattice_points` on K5's rows computed once (`vlm.lattice_rows`,
  as the coupled VLM demo does): its points are bit for bit those of fresh
  rows at two values of (cp, d); the fused route's size limit is the
  kernel source's FUSED_N_MAX.

The `gpu`-marked tests hold K7's four modes and K5 against their plain
versions on the card (and dcp bit for bit over 5 launches); they skip
without a card. Run them there with `python -m pytest
tests/test_torch_k5_k7.py -m gpu --noconftest -q`.
"""

import numpy as np
import pytest
import torch

from _torch_port_common import MI_SMALL, port_mi_tbeam, rel

TOL = 1e-12
ROWS_TOL = 1e-13


# ------------------------------------------------------------ K7 premises
def _side_rows(c2x, cp, x):
    """Per side-point (I, N, 2): P (., 3), dP/dxi (., 3, 2) and the plain
    rows (conn, R0) of the port."""
    from goldfish_tpu_torch.ops import bspline_traced as bt

    mi = c2x.mi
    I, N = mi.n_int, mi.n_max
    x4 = x.reshape(I, N, 2, 2)
    P = torch.zeros(I, N, 2, 3, dtype=torch.float64)
    dP = torch.zeros(I, N, 2, 3, 2, dtype=torch.float64)
    rows = []
    for side, pair in ((0, mi.pairA), (1, mi.pairB)):
        ip = pair[:, None].expand(I, N).reshape(-1)
        conn, R = bt._rows_plain(c2x.ss, c2x.p, c2x.q, ip,
                                 x4[:, :, side].reshape(-1, 2))
        c = cp[ip.long()[:, None], conn.long()]
        P[:, :, side] = torch.einsum("ml,mlk->mk", R[0], c).reshape(I, N, 3)
        for a in range(2):
            dP[:, :, side, :, a] = torch.einsum(
                "ml,mlk->mk", R[1 + a], c).reshape(I, N, 3)
        rows.append((ip, conn, R[0]))
    return P, dP, rows


def _owner_rows(mi, i, k, P, x):
    """The rows of owner k as the kernel forms them: a list of (slot,
    value, {(point, side): dRow/dP (3,)}) and of pins (slot, column,
    target)."""
    N = mi.n_max
    n = int(mi.n_pts[i])
    last = n - 1
    x0 = mi.xi0[i].reshape(-1)

    def col(kk, side, c):
        return (kk * 2 + side) * 2 + c

    rows, pins = [], []
    PA, PB = P[i, :, 0], P[i, :, 1]
    if k < n:
        coin = PA[k] - PB[k]
        if float(mi.both_edges[i]) > 0.5:
            e0, e1 = int(mi.epin_dir[i, 0]), int(mi.epin_dir[i, 1])
            pins.append((3 * k, col(k, 0, e0), float(mi.epin_val[i, 0])))
            pins.append((3 * k + 1, col(k, 1, e1), float(mi.epin_val[i, 1])))
            ta, tb = (1, 0) if k == 0 else ((k, k - 1) if k >= last
                                            else (k + 1, k - 1))
            tan = PA[ta] - PA[tb]
            nrm = torch.sqrt((tan * tan).sum()) + 1e-300
            th = tan / nrm
            proj = (coin * th).sum()
            gt = (coin - proj * th) / nrm
            g = {(k, 0): th.clone(), (k, 1): -th}
            g[(ta, 0)] = g.get((ta, 0), 0.0) + gt
            g[(tb, 0)] = g.get((tb, 0), 0.0) - gt
            rows.append((3 * k + 2, proj, g))
        else:
            for m in range(3):
                e = torch.zeros(3, dtype=torch.float64)
                e[m] = 1.0
                rows.append((3 * k + m, coin[m], {(k, 0): e, (k, 1): -e}))
    else:
        for j, (side, c) in enumerate(((0, 0), (0, 1), (1, 0))):
            pins.append((3 * k + j, col(k, side, c),
                         float(x0[col(k, side, c)])))
    if k >= 2:
        slot = 3 * N + k - 2
        if k < n:
            s1, s0 = PA[k] - PA[k - 1], PA[k - 1] - PA[k - 2]
            rows.append((slot, (s1 * s1).sum() - (s0 * s0).sum(),
                         {(k - 2, 0): 2 * s0, (k - 1, 0): -2 * (s1 + s0),
                          (k, 0): 2 * s1}))
        else:
            pins.append((slot, col(k, 1, 1), float(x0[col(k, 1, 1)])))
    if k == 0:
        ed, ev = mi.end_dir[i], mi.end_val[i]
        pins.append((4 * N - 2, col(0, 0, int(ed[0])), float(ev[0])))
        pins.append((4 * N - 1, col(last, 0, int(ed[1])), float(ev[1])))
    return rows, pins


def _closed_form(c2x, cp, x):
    """r (I, 4N), dR/dx (I, 4N, 4N) and dR/dP per row in closed form."""
    mi = c2x.mi
    I, N = mi.n_int, mi.n_max
    P, dP, _ = _side_rows(c2x, cp, x)
    r = torch.zeros(I, 4 * N, dtype=torch.float64)
    J = torch.zeros(I, 4 * N, 4 * N, dtype=torch.float64)
    dRdP = [[] for _ in range(I)]
    for i in range(I):
        for k in range(N):
            rows, pins = _owner_rows(mi, i, k, P, x)
            for slot, col, target in pins:
                r[i, slot] = x[i, col] - target
                J[i, slot, col] = 1.0
            for slot, val, g in rows:
                r[i, slot] = val
                for (j, side), gj in g.items():
                    J[i, slot, (j * 2 + side) * 2:(j * 2 + side) * 2 + 2] = \
                        gj @ dP[i, j, side]
                dRdP[i].append((slot, g))
    return r, J, dRdP


def _closed_form_vjp(c2x, cp, x, lam, dRdP):
    """-lam^T dR/dcp: the points' gradients g_P from the closed-form row
    derivatives dRdP (of `_closed_form`), pulled back through the rows
    R0."""
    mi = c2x.mi
    I, N = mi.n_int, mi.n_max
    gP = torch.zeros(I, N, 2, 3, dtype=torch.float64)
    for i in range(I):
        for slot, g in dRdP[i]:
            for (j, side), gj in g.items():
                gP[i, j, side] += lam[i, slot] * gj
    _, _, rows = _side_rows(c2x, cp, x)
    dcp = torch.zeros_like(cp)
    for side, (ip, conn, R0) in enumerate(rows):
        g = gP[:, :, side].reshape(-1, 3)
        dcp.index_put_((ip.long()[:, None], conn.long()),
                       -R0[..., None] * g[:, None, :], accumulate=True)
    return dcp


@pytest.fixture(scope="module")
def seams():
    """{"tbeam", "edge"}: (JAX CPIGA2Xi, port CPIGA2Xi, cp, x, g) as the
    port's tensors: cp bent (T-beam: amp 0.05; edge: x stretched 2%), x
    the seed moved by 1e-3 (seeded), g standard normal."""
    import test_torch_cpiga2xi as tc
    from _torch_port_common import jax_mi_tbeam, mi_cp

    out = {}
    jx, px = jax_mi_tbeam().c2x, port_mi_tbeam().c2x
    cps = {"tbeam": mi_cp(jax_mi_tbeam(), 0.05)}
    ejx, epx = tc._edge_pair()
    from goldfish_tpu.geometry.patch_stack import (
        build_patch_stack,
        stack_control_points,
    )

    _, metas = build_patch_stack(ejx.surfs)
    ecp = np.array(stack_control_points(metas))
    ecp[..., 0] *= 1.02
    cps["edge"] = ecp
    rng = np.random.default_rng(3)
    for name, (j, p) in (("tbeam", (jx, px)), ("edge", (ejx, epx))):
        x0 = np.asarray(j.xi0_flat)
        x = x0 + 1e-3 * rng.normal(size=x0.shape)
        g = rng.normal(size=x0.shape)
        out[name] = (j, p, torch.tensor(cps[name]), torch.tensor(x),
                     torch.tensor(g))
    return out


@pytest.mark.parametrize("seam", ["tbeam", "edge"])
def test_closed_form_rows_match_jacfwd(seams, seam):
    import jax.numpy as jnp

    from goldfish_tpu.geometry import cpiga2xi as jc

    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    jx, px, cp, x, g = seams[seam]
    r, J, dRdP = _closed_form(px, cp, x)
    r_j, J_j = jc._c2x_res_jac(jx.ss, jx.mi, jnp.asarray(cp.numpy()),
                               jnp.asarray(x.numpy()), p=jx.p, q=jx.q)
    assert rel(r, np.asarray(r_j)) <= TOL
    assert rel(J, np.asarray(J_j)) <= TOL
    # the same row derivatives pulled back to the control points: the
    # plain version's autograd (held to the JAX VJP by
    # test_torch_cpiga2xi)
    dcp = _closed_form_vjp(px, cp, x, g, dRdP)
    assert rel(dcp, pc._res_vjp_plain(px.ss, px.p, px.q, px.mi, cp, x, g)
               .numpy()) <= TOL


def _lu_solve(A, b):
    """K7's in-block solve of A x = b, transcribed: the elimination with
    the pivots' reciprocals, then the back substitution in blocks of 32
    unknowns. Returns (x, pivot rows in order)."""
    n = A.shape[0]
    a = torch.cat([A, b[:, None]], 1).clone()
    done = torch.zeros(n, dtype=torch.bool)
    order = []
    for k in range(n):
        v = torch.where(done, torch.full((n,), -1.0, dtype=a.dtype),
                        a[:, k].abs())
        p = int(torch.nonzero(v == v.max())[0])  # ties to the lower row
        done[p] = True
        order.append(p)
        rp = 1.0 / a[p, k]
        l = torch.where(~done, a[:, k] * rp, torch.zeros(n, dtype=a.dtype))
        a[:, k + 1:] -= l[:, None] * a[p, k + 1:][None, :]
        a[p, k] = rp
    x = torch.zeros(n, dtype=a.dtype)
    for hi in range(n - 1, -1, -32):
        lo = max(hi - 31, 0)
        for k in range(hi, lo - 1, -1):     # the block's triangle
            x[k] = a[order[k], n] * a[order[k], k]
            blk = torch.tensor(order[lo:k], dtype=torch.long)
            a[blk, n] -= a[blk, k] * x[k]
        above = torch.tensor(order[:lo], dtype=torch.long)
        a[above, n] -= a[above, lo:hi + 1] @ x[lo:hi + 1]
    return x, order


@pytest.mark.parametrize("seam", ["tbeam", "edge"])
def test_in_block_solve_matches_numpy(seams, seam):
    import jax.numpy as jnp

    from goldfish_tpu.geometry import cpiga2xi as jc

    jx, _, cp, x, g = seams[seam]
    r, J = jc._c2x_res_jac(jx.ss, jx.mi, jnp.asarray(cp.numpy()),
                           jnp.asarray(x.numpy()), p=jx.p, q=jx.q)
    r, J = np.asarray(r), np.asarray(J)
    for i in range(J.shape[0]):
        for A, b in ((J[i], -r[i]), (J[i].T, g[i].numpy())):
            got, order = _lu_solve(torch.tensor(A), torch.tensor(b))
            assert sorted(order) == list(range(A.shape[0]))
            assert rel(got, np.linalg.solve(A, b)) <= TOL


def test_plain_step_and_adjoint_match_jax(seams):
    import jax.numpy as jnp

    from goldfish_tpu.geometry import cpiga2xi as jc
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    jx, px, cp, x, g = seams["tbeam"]
    jcp, jxx = jnp.asarray(cp.numpy()), jnp.asarray(x.numpy())
    r, J = jc._c2x_res_jac(jx.ss, jx.mi, jcp, jxx, p=jx.p, q=jx.q)
    x_new = np.asarray(jxx) + np.linalg.solve(
        np.asarray(J), -np.asarray(r)[..., None])[..., 0]
    r_new, _ = jc._c2x_res_jac(jx.ss, jx.mi, jcp, jnp.asarray(x_new),
                               p=jx.p, q=jx.q)
    norms = np.stack([np.linalg.norm(np.asarray(r), axis=-1),
                      np.linalg.norm(np.asarray(r_new), axis=-1)], -1)
    got_x, got_n = pc._step_plain(px.ss, px.p, px.q, px.mi, cp, x)
    assert rel(got_x - x, x_new - x.numpy()) <= TOL
    assert rel(got_n[:, 0], norms[:, 0]) <= TOL
    # the trial residual inherits the step's rounding: held at |r(x)|'s
    # scale
    assert np.abs(got_n[:, 1].numpy() - norms[:, 1]).max() \
        <= TOL * norms[:, 0].max()
    dcp = pc._adjoint_plain(px.ss, px.p, px.q, px.mi, cp, x, g)
    ref = jc._c2x_adjoint_direct(jx.ss, jx.mi, jcp, jxx,
                                 jnp.asarray(g.numpy()), p=jx.p, q=jx.q)
    assert rel(dcp, np.asarray(ref)) <= 1e-9


@pytest.mark.parametrize("start", ["xi0", "warm"])
def test_newton_loop_matches_jax_direct(start):
    """The fused-step loop (on the CPU its plain step) against the JAX
    package's direct-mode `_c2x_newton` at cp(0.05): from the seed, and
    from the converged xi of cp(0.05) at cp(0.05 (1 + 1e-3))."""
    import jax.numpy as jnp

    from _torch_port_common import jax_mi_tbeam, mi_cp
    from goldfish_tpu.geometry import cpiga2xi as jc
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    jx, px = jax_mi_tbeam().c2x, port_mi_tbeam().c2x
    x0 = np.asarray(jx.xi0_flat)
    amp = 0.05
    if start == "warm":
        x0, _, _ = jc._c2x_newton(jx.ss, jx.mi,
                                  jnp.asarray(mi_cp(jax_mi_tbeam(), amp)),
                                  jnp.asarray(x0), p=jx.p, q=jx.q)
        x0 = np.asarray(x0)
        amp *= 1.0 + 1e-3
    cp = mi_cp(jax_mi_tbeam(), amp)
    xj, itj, _ = jc._c2x_newton(jx.ss, jx.mi, jnp.asarray(cp),
                                jnp.asarray(x0), p=jx.p, q=jx.q)
    xp, itp, rn = pc.c2x_newton(px.ss, px.p, px.q, px.mi, torch.tensor(cp),
                                torch.tensor(x0))
    assert px.route == "fused"
    assert itp == int(itj) and itp >= 1
    assert rn <= 1e-12
    assert np.abs(xp.numpy() - np.asarray(xj)).max() <= 1e-10


# ------------------------------------------------------------ K5 premises
def _ders1(U, p, span, u):
    """Piegl & Tiller A2.3 with n = 1 as bspline_rows.cuh writes it."""
    left, right = [0.0] * (p + 1), [0.0] * (p + 1)
    ndu = [[0.0] * (p + 1) for _ in range(p + 1)]
    ndu[0][0] = 1.0
    for j in range(1, p + 1):
        left[j] = u - U[span + 1 - j]
        right[j] = U[span + j] - u
        saved = 0.0
        for r in range(j):
            ndu[j][r] = right[r + 1] + left[j - r]
            temp = ndu[r][j - 1] / ndu[j][r]
            ndu[r][j] = saved + right[r + 1] * temp
            saved = left[j - r] * temp
        ndu[j][j] = saved
    N = [ndu[r][p] for r in range(p + 1)]
    dN = []
    for r in range(p + 1):
        d = 0.0
        if r >= 1:
            d += ndu[r - 1][p - 1] / ndu[p][r - 1]
        if r <= p - 1:
            d -= ndu[r][p - 1] / ndu[p][r]
        dN.append(p * d)
    return N, dN


def _lane_rows(ss, p, q, ip, xi):
    """K5's rows, transcribed point by point: conn (M, L) and R (3, M, L)."""
    conn, R = [], []
    for k, (u, v) in zip(ip.tolist(), xi.tolist()):
        spans = []
        for vals, ids, t in ((ss.span_u_vals, ss.span_u_ids, u),
                             (ss.span_v_vals, ss.span_v_ids, v)):
            cnt = int((vals[k] <= t).sum())       # the ballots' count
            spans.append(int(ids[k, min(max(cnt - 1, 0),
                                        vals.shape[1] - 1)]))
        su, sv = spans
        Nu, dNu = _ders1(ss.knots_u[k].tolist(), p, su, u)
        Nv, dNv = _ders1(ss.knots_v[k].tolist(), q, sv, v)
        nv = int(ss.n_v[k])
        c = [(su - p + i) * nv + (sv - q + j) for i in range(p + 1)
             for j in range(q + 1)]
        w = ss.w[k, c].tolist()
        wN0 = [(Nu[i] * Nv[j]) * w[i * (q + 1) + j] for i in range(p + 1)
               for j in range(q + 1)]
        wNu = [(dNu[i] * Nv[j]) * w[i * (q + 1) + j] for i in range(p + 1)
               for j in range(q + 1)]
        wNv = [(Nu[i] * dNv[j]) * w[i * (q + 1) + j] for i in range(p + 1)
               for j in range(q + 1)]
        W0, Wu, Wv = sum(wN0), sum(wNu), sum(wNv)
        R0 = [a / W0 for a in wN0]
        R.append([R0, [(a - r0 * Wu) / W0 for a, r0 in zip(wNu, R0)],
                  [(a - r0 * Wv) / W0 for a, r0 in zip(wNv, R0)]])
        conn.append(c)
    return (torch.tensor(conn, dtype=torch.int32),
            torch.tensor(R, dtype=torch.float64).permute(1, 0, 2))


def _points(kind):
    """(ip, xi) as numpy: 20 points alternating between the T-beam's
    patches, at random, on the seam's knot line 0.5, one ulp either side
    of it, and at the domain's ends (test_torch_bspline_traced's)."""
    rng = np.random.default_rng(5)
    xi = rng.uniform(0.0, 1.0, size=(20, 2))
    if kind == "knot":
        xi[:, 0] = 0.5
    elif kind == "ulp":
        xi[::2, 0] = np.nextafter(0.5, 1.0)
        xi[1::2, 0] = np.nextafter(0.5, 0.0)
    elif kind == "end":
        xi[::3] = 1.0
        xi[1::3, 1] = 0.0
    return np.array([0, 1] * 10, dtype=np.int32), xi


@pytest.mark.parametrize("kind", ["random", "knot", "ulp", "end"])
def test_closed_form_basis_rows_match_jacfwd(kind):
    import jax.numpy as jnp

    from _torch_port_common import jax_mi_tbeam
    from goldfish_tpu.ops import bspline_jax as bj
    from goldfish_tpu_torch.ops import bspline_traced as bt

    surfs = jax_mi_tbeam().surfs
    jss, (p, q) = bj.make_surf_set(surfs)
    pss, _ = bt.make_surf_set(port_mi_tbeam().surfs, device="cpu")
    ip, xi = _points(kind)
    conn, R = _lane_rows(pss, p, q, torch.from_numpy(ip),
                         torch.from_numpy(xi))

    conn_j, R0_j, R1_j = _jax_rows(jss, p, q)(jnp.asarray(ip),
                                            jnp.asarray(xi))
    R1_j = np.asarray(R1_j)
    assert np.array_equal(conn.numpy(), np.asarray(conn_j))
    assert rel(R[0], np.asarray(R0_j)) <= ROWS_TOL
    assert rel(R[1], R1_j[..., 0]) <= ROWS_TOL
    assert rel(R[2], R1_j[..., 1]) <= ROWS_TOL


_JAX_ROWS = {}


def _jax_rows(jss, p, q):
    """jit(vmap) over points of the JAX rows: conn, R0 = wN / sum(wN) of
    `bspline_jax.surface_basis` and jax.jacfwd of R0 in xi."""
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.ops import bspline_jax as bj

    if (p, q) not in _JAX_ROWS:
        def r0(k, t):
            _, wN = bj.surface_basis(jss, p, q, k, t)
            return wN / jnp.sum(wN)

        def one(k, t):
            return (bj.surface_basis(jss, p, q, k, t)[0], r0(k, t),
                    jax.jacfwd(lambda s: r0(k, s))(t))

        _JAX_ROWS[(p, q)] = jax.jit(jax.vmap(one))
    return _JAX_ROWS[(p, q)]


# ------------------------------------------------------------ VLM reuse
def test_lattice_rows_computed_once_and_reused():
    """lattice_points at two (cp, d) on rows computed once: bit for bit
    the points of fresh rows."""
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.ops import bspline_traced as bt
    from goldfish_tpu_torch.physics import vlm

    s = wing.build(n_chord=2, n_span=2, num_el=2, p=2, load_scale=0.0,
                   device="cpu")
    ss, (p, q) = bt.make_surf_set(s.surfs, device="cpu")
    lat = vlm.build_lattice_param(2, 2, 5, 8, device="cpu")
    rows = vlm.lattice_rows(ss, p, q, lat)
    rng = np.random.default_rng(11)
    for _ in range(2):
        cp = s.cp + torch.tensor(1e-2 * rng.normal(size=tuple(s.cp.shape)))
        d = torch.tensor(1e-3 * rng.normal(size=tuple(s.cp.shape)))
        got = vlm.lattice_points(ss, p, q, lat, cp, d, rows)
        assert torch.equal(got, vlm.lattice_points(ss, p, q, lat, cp, d))


def test_fused_route_limit_is_the_kernels():
    """The route's size limit is the one number K7's source states (its
    static_asserts hold it to the block's shared memory)."""
    import re
    from pathlib import Path

    from goldfish_tpu_torch.geometry import cpiga2xi

    src = Path(cpiga2xi.__file__).parents[1] / "csrc" / "c2x_res_jac.cu"
    got = re.search(r"constexpr int FUSED_N_MAX = (\d+);", src.read_text())
    assert int(got.group(1)) == cpiga2xi.FUSED_N_MAX
    assert cpiga2xi.fused_route(cpiga2xi.FUSED_N_MAX)
    assert not cpiga2xi.fused_route(cpiga2xi.FUSED_N_MAX + 1)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _port_seam(name, dev):
    """(CPIGA2Xi, cp, x, g) of a port system on `dev`: the small T-beam
    (one seam of 17 points, bent), a seam along an edge of both patches (7
    points), or the small moving-seam tube (four edge seams); x the seed
    moved by 1e-3, g standard normal (seeded)."""
    rng = np.random.default_rng(5)
    if name == "tbeam":
        from goldfish_tpu_torch.models import tbeam

        s = tbeam.build_mi(**MI_SMALL, device=dev)
        c2x, cp = s.c2x, s.cp.clone()
        m = s.metas[1]
        cp[1, : m.n_cp, 0] += 0.05 * torch.sin(
            torch.arange(m.n_cp, device=dev) / 5.0)
    elif name == "edge":
        from goldfish_tpu_torch.geometry.cpiga2xi import CPIGA2Xi
        from goldfish_tpu_torch.geometry.patch_stack import (
            build_patch_stack,
            stack_control_points,
        )
        from goldfish_tpu_torch.models import tbeam
        from goldfish_tpu_torch.physics.coupling import InterfaceSpec

        L = tbeam.LENGTH
        surfs = [tbeam.create_surf([[-1, 0, 0], [0, 0, 0], [-1, L, 0],
                                    [0, L, 0]], 2, 3, 3),
                 tbeam.create_surf([[0, 0, 0], [1, 0, 0], [0, L, 0],
                                    [1, L, 0]], 2, 4, 3)]
        spec = InterfaceSpec(pair=(0, 1),
                             xi_ends_A=np.array([[1.0, 0.0], [1.0, 1.0]]),
                             xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                             n_mortar_el=6)
        c2x = CPIGA2Xi(surfs, [spec], n_pts_list=[7], device=dev)
        cp = stack_control_points(build_patch_stack(surfs, device=dev)[1],
                                  device=dev)
        cp[..., 0] *= 1.02
    else:
        from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as d

        s = d.build_mi_tube(num_el=3, p=3, pressure=5e2, device=dev)
        c2x, cp = s.c2x, s.cp
    x0 = c2x.xi0_flat
    x = (x0 + torch.tensor(1e-3 * rng.normal(size=tuple(x0.shape)),
                           device=dev)).clamp(0.0, 1.0).contiguous()
    g = torch.tensor(rng.normal(size=tuple(x0.shape)), device=dev)
    return c2x, cp.contiguous(), x, g


@pytest.mark.gpu
@pytest.mark.parametrize("seam", ["tbeam", "edge", "tube"])
def test_cuda_k7_modes_match_plain(cuda, seam):
    """K7's four modes against their plain versions on the same CUDA
    inputs: r, J, the given-lam dcp 1e-12 (the residual 1e-12 in norm);
    the step's dx 1e-10 (the solve, cond 1e3-1e5), |r(x)| 1e-12 and |r(x +
    dx)| at |r(x)|'s scale; the solved adjoint's dcp 1e-12."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    c2x, cp, x, g = _port_seam(seam, cuda)
    ss, p, q, mi = c2x.ss, c2x.p, c2x.q, c2x.mi
    _cuda.reset_launch_counts()
    r, J = pc.c2x_res_jac(ss, p, q, mi, cp, x)
    r_p, J_p = pc._res_jac_plain(ss, p, q, mi, cp, x, True)
    assert rel(r.cpu(), r_p.cpu().numpy()) <= TOL
    assert rel(J.cpu(), J_p.cpu().numpy()) <= TOL
    dcp = pc.c2x_res_vjp(ss, p, q, mi, cp, x, g)
    assert rel(dcp.cpu(), pc._res_vjp_plain(ss, p, q, mi, cp, x, g)
               .cpu().numpy()) <= TOL
    xn, nr = pc.c2x_step(ss, p, q, mi, cp, x)
    xn_p, nr_p = pc._step_plain(ss, p, q, mi, cp, x)
    assert rel((xn - x).cpu(), (xn_p - x).cpu().numpy()) <= 1e-10
    assert rel(nr[:, 0].cpu(), nr_p[:, 0].cpu().numpy()) <= TOL
    assert float((nr[:, 1] - nr_p[:, 1]).abs().max()) \
        <= TOL * float(nr_p[:, 0].max())
    a = pc.c2x_solve_adjoint(ss, p, q, mi, cp, x, g)
    assert rel(a.cpu(), pc._adjoint_plain(ss, p, q, mi, cp, x, g)
               .cpu().numpy()) <= TOL
    for name in ("res_jac", "adjoint", "step", "solve_adjoint"):
        assert _cuda.launch_counts["c2x_res_jac/" + name] == 1, name


@pytest.mark.gpu
def test_cuda_k7_adjoint_is_reproducible(cuda):
    """Mode 3 (and mode 1) sum without atomics: dcp bit for bit over 5
    launches on the tube's four seams."""
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    c2x, cp, x, g = _port_seam("tube", cuda)
    args = (c2x.ss, c2x.p, c2x.q, c2x.mi, cp, x, g)
    for fn in (pc.c2x_solve_adjoint, pc.c2x_res_vjp):
        first = fn(*args)
        for _ in range(4):
            assert torch.equal(fn(*args), first)


@pytest.mark.gpu
def test_cuda_newton_loop_matches_plain(cuda):
    """c2x_newton on the card (the fused step) against the plain loop on
    the CPU from the seed: equal iterations, x within 1e-10."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    c2x, cp, _, _ = _port_seam("tbeam", cuda)
    _cuda.reset_launch_counts()
    x, its, rn = pc.c2x_newton(c2x.ss, c2x.p, c2x.q, c2x.mi, cp,
                               c2x.xi0_flat.clone())
    cpu = port_mi_tbeam().c2x
    x_p, its_p, _ = pc.c2x_newton(cpu.ss, cpu.p, cpu.q, cpu.mi, cp.cpu(),
                                  cpu.xi0_flat.clone())
    assert its == its_p and rn <= 1e-12
    assert float((x.cpu() - x_p).abs().max()) <= 1e-10
    assert _cuda.launch_counts["c2x_res_jac/step"] == its


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "knot", "ulp", "end",
                                  "lattice"])
def test_cuda_k5_matches_plain(cuda, kind):
    """K5 against its plain version on the same CUDA inputs: conn equal,
    R 1e-13; on the T-beam's patches at test_torch_bspline_traced's
    points, and at the full-width 16 x 64 lattice (1105 points)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.ops import bspline_traced as bt

    if kind == "lattice":
        from goldfish_tpu_torch.models import wing
        from goldfish_tpu_torch.physics import vlm

        s = wing.build(n_chord=4, n_span=5, num_el=6, p=3, device=cuda)
        lat = vlm.build_lattice_param(4, 5, 16, 64, device=cuda)
        ip, xi = lat.ip.reshape(-1), lat.xi.reshape(-1, 2)
    else:
        s = port_mi_tbeam()
        ip, xi = (torch.from_numpy(a).to(cuda) for a in _points(kind))
    ss, (p, q) = bt.make_surf_set(s.surfs, device=cuda)
    ip, xi = ip.contiguous(), xi.contiguous()
    _cuda.reset_launch_counts()
    conn, R = bt.traced_rows(ss, p, q, ip, xi)
    conn_p, R_p = bt._rows_plain(ss, p, q, ip, xi)
    assert torch.equal(conn, conn_p)
    assert rel(R.cpu(), R_p.cpu().numpy()) <= ROWS_TOL
    assert _cuda.launch_counts["traced_rows"] == 1
