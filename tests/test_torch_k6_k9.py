"""The premises of K6 mi_penalty_xi's forward-over-reverse sweep and of K9
vm_stress_qp's reverse sweep and fixed-order scatter.

- K6's rows (csrc/bspline_rows.cuh: `lane_row2`): a transcription of
  Piegl & Tiller A2.3 with n = 2 and of the quotient rule's second-order
  terms gives conn bit for bit and R, its first and its second xi
  derivatives to 1e-13 against jax.jacfwd (twice) of the JAX rows
  (`coupling_mi._rational_rows`' R0) at random, on-knot, one-ulp and end
  points.
- K6's sweep (csrc/penalty_sweep.cuh with ALL, csrc/mi_penalty_xi.cu): a
  transcription of the hand-written reverse sweep returns dF/d(z, X, h,
  dxiA, dxiB) as autograd of the plain density does; run forward over
  reverse (torch.func.jvp, z's tangent lambda's jets) and chained to xi
  lane by lane through the second-derivative rows, it equals the plain
  version `_xi_grad_plain` and, through `penalty_xi_vjp`, the xi part of
  the JAX `_jit_res_vjp_mi` on the small MI T-beam (1e-12). A point of
  zero weight gives exact zeros.
- K9's sweep (csrc/vm_stress_qp.cu: `vm_sweep`): a transcription gives
  gbar . dsigma/d(z, X, h) as autograd of `stress_density` at top, mid and
  bottom (1e-12), zeros at a qp with sigma = 0; scattered by the kernel's
  order (B^T summed over an element's qps, then each node's partials over
  `kl_shell.node_incidence`) it equals jax.vjp of the JAX `qp_stress_vm`
  (1e-12); that gather equals index_add (1e-14), and the incidence lists
  are exactly conn's pairs, in ascending order.

The `gpu`-marked tests hold K6 (MI T-beam and tube MI shapes, 1e-11) and
K9 (value 1e-12, VJP 1e-11) against their plain versions on the card, K6's
and K9's VJP outputs bit for bit over 5 launches, and K2's three modes bit
for bit against the outputs the parent tree of the extended sweep gave
(`chip_smoke.k2_bits`, tests/data/torch_port_k2_bits.json); they skip
without a card. Run them there with `python -m pytest
tests/test_torch_k6_k9.py -m gpu --noconftest -q`.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_port_common import (
    MI_SMALL,
    PLATE_SMALL,
    TUBE_SMALL,
    plate_state,
    port_mi_tbeam,
    port_plate,
    rel,
    t,
)

TOL = 1e-12
ROWS_TOL = 1e-13


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _unit_rev(y, n, yb):
    """y = v / |v| backwards: (yb - (yb . y) y) / |v|."""
    return (yb - _dot(yb, y)[..., None] * y) / n[..., None]


# ------------------------------------------------------------ K6 rows
def _ders2(U, p, span, u):
    """Piegl & Tiller A2.3 with n = 2 as bspline_rows.cuh writes it."""
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
    N, dN, d2N = [], [], []
    for r in range(p + 1):
        N.append(ndu[r][p])
        d = 0.0
        if r >= 1:
            d += ndu[r - 1][p - 1] / ndu[p][r - 1]
        if r <= p - 1:
            d -= ndu[r][p - 1] / ndu[p][r]
        dN.append(p * d)
        d2 = 0.0
        if p >= 2:
            a0 = 1.0 / ndu[p][r - 1] if r >= 1 else 0.0
            a1 = -1.0 / ndu[p][r] if r <= p - 1 else 0.0
            if r >= 2:
                d2 += (a0 / ndu[p - 1][r - 2]) * ndu[r - 2][p - 2]
            if 1 <= r <= p - 1:
                d2 += ((a1 - a0) / ndu[p - 1][r - 1]) * ndu[r - 1][p - 2]
            if r <= p - 2:
                d2 += (-a1 / ndu[p - 1][r]) * ndu[r][p - 2]
        d2N.append(p * (p - 1) * d2)
    return N, dN, d2N


def _lane_rows2(ss, p, q, ip, xi):
    """K6's rows, transcribed point by point: conn (M, L) and R (6, M, L)
    = (R, R_u, R_v, R_uu, R_uv, R_vv)."""
    conn, R = [], []
    for k, (u, v) in zip(ip.tolist(), xi.tolist()):
        spans = []
        for vals, ids, x in ((ss.span_u_vals, ss.span_u_ids, u),
                             (ss.span_v_vals, ss.span_v_ids, v)):
            cnt = int((vals[k] <= x).sum())       # the ballots' count
            spans.append(int(ids[k, min(max(cnt - 1, 0),
                                        vals.shape[1] - 1)]))
        su, sv = spans
        Nu = _ders2(ss.knots_u[k].tolist(), p, su, u)
        Nv = _ders2(ss.knots_v[k].tolist(), q, sv, v)
        nv = int(ss.n_v[k])
        ij = [(i, j) for i in range(p + 1) for j in range(q + 1)]
        c = [(su - p + i) * nv + (sv - q + j) for i, j in ij]
        w = ss.w[k, c].tolist()
        # A = w N_u^(a) N_v^(b) for (a, b) = 00, 10, 01, 20, 11, 02
        A = [[(Nu[a][i] * Nv[b][j]) * wl for (i, j), wl in zip(ij, w)]
             for a, b in ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))]
        W0, Wu, Wv, Wuu, Wuv, Wvv = (sum(x) for x in A)
        R0 = [a / W0 for a in A[0]]
        Ru = [(a - r * Wu) / W0 for a, r in zip(A[1], R0)]
        Rv = [(a - r * Wv) / W0 for a, r in zip(A[2], R0)]
        Ruu = [(a - 2.0 * (ru * Wu) - r * Wuu) / W0
               for a, ru, r in zip(A[3], Ru, R0)]
        Ruv = [(a - ru * Wv - rv * Wu - r * Wuv) / W0
               for a, ru, rv, r in zip(A[4], Ru, Rv, R0)]
        Rvv = [(a - 2.0 * (rv * Wv) - r * Wvv) / W0
               for a, rv, r in zip(A[5], Rv, R0)]
        R.append([R0, Ru, Rv, Ruu, Ruv, Rvv])
        conn.append(c)
    return (torch.tensor(conn, dtype=torch.int32),
            torch.tensor(R, dtype=torch.float64).permute(1, 0, 2))


_JAX_ROWS2 = {}


def _jax_rows2(jss, p, q):
    """jit(vmap) over points of the JAX rows: conn, R0 and jax.jacfwd of
    R0 once and twice in xi (coupling_mi._rational_rows' R0)."""
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.ops import bspline_jax as bj

    if (p, q) not in _JAX_ROWS2:
        def r0(k, x):
            _, wN = bj.surface_basis(jss, p, q, k, x)
            return wN / jnp.sum(wN)

        def one(k, x):
            f = lambda s: r0(k, s)  # noqa: E731
            return (bj.surface_basis(jss, p, q, k, x)[0], f(x),
                    jax.jacfwd(f)(x), jax.jacfwd(jax.jacfwd(f))(x))

        _JAX_ROWS2[(p, q)] = jax.jit(jax.vmap(one))
    return _JAX_ROWS2[(p, q)]


@pytest.mark.parametrize("kind", ["random", "knot", "ulp", "end"])
def test_second_derivative_rows_match_jacfwd(kind):
    import jax.numpy as jnp

    import test_torch_k5_k7 as k57
    from _torch_port_common import jax_mi_tbeam
    from goldfish_tpu.ops import bspline_jax as bj
    from goldfish_tpu_torch.ops import bspline_traced as bt

    jss, (p, q) = bj.make_surf_set(jax_mi_tbeam().surfs)
    pss, _ = bt.make_surf_set(port_mi_tbeam().surfs, device="cpu")
    ip, xi = k57._points(kind)
    conn, R = _lane_rows2(pss, p, q, torch.from_numpy(ip),
                          torch.from_numpy(xi))
    conn_j, R0_j, R1_j, R2_j = (np.asarray(a) for a in _jax_rows2(
        jss, p, q)(jnp.asarray(ip), jnp.asarray(xi)))
    assert np.array_equal(conn.numpy(), conn_j)
    for k, ref in enumerate((R0_j, R1_j[..., 0], R1_j[..., 1],
                             R2_j[..., 0, 0], R2_j[..., 0, 1],
                             R2_j[..., 1, 1])):
        assert rel(R[k], ref) <= ROWS_TOL, k


# ------------------------------------------------------------ K6 sweep
def _sweep_all(X, z, hA, hB, dxA, dxB, E, ad, ar, w):
    """penalty_sweep.cuh with ALL, transcribed (batched over points):
    dF/dz (18), dF/dX (12), dF/dhA, dF/d(dxA, dxB) (4)."""
    XAu, XAv, XBu, XBv = (X[..., 3 * k:3 * k + 3] for k in range(4))
    h = 0.5 * (hA + hB)
    ald = ad * E * h
    alr = ar * E * (h * h * h) / 12.0
    dX = XAu * dxA[..., :1] + XAv * dxA[..., 1:]
    dl = torch.sqrt(_dot(dX, dX))
    A3A = _cross(XAu, XAv)
    lNA = torch.sqrt(_dot(A3A, A3A))
    A3A = A3A / lNA[..., None]
    A3B = _cross(XBu, XBv)
    lNB = torch.sqrt(_dot(A3B, A3B))
    A3B = A3B / lNB[..., None]
    TB = XBu * dxB[..., :1] + XBv * dxB[..., 1:]
    lTB = torch.sqrt(_dot(TB, TB))
    TB = TB / lTB[..., None]
    AnB = _cross(A3B, TB)
    xAu, xAv = z[..., 3:6] + XAu, z[..., 6:9] + XAv
    xBu, xBv = z[..., 12:15] + XBu, z[..., 15:18] + XBv
    a3A = _cross(xAu, xAv)
    lA = torch.sqrt(_dot(a3A, a3A))
    a3A = a3A / lA[..., None]
    a3B = _cross(xBu, xBv)
    lB = torch.sqrt(_dot(a3B, a3B))
    a3B = a3B / lB[..., None]
    tB = xBu * dxB[..., :1] + xBv * dxB[..., 1:]
    lT = torch.sqrt(_dot(tB, tB))
    tB = tB / lT[..., None]
    anB = _cross(a3B, tB)
    dphi = _dot(a3A, a3B) - _dot(A3A, A3B)
    dbeta = _dot(a3A, anB) - _dot(A3A, AnB)
    du = z[..., 0:3] - z[..., 9:12]
    du2 = _dot(du, du)
    rot = dphi * dphi + dbeta * dbeta
    dens = 0.5 * (ald * du2) + 0.5 * (alr * rot)
    gh = 0.5 * ((w * dl) * (0.5 * (ad * E * du2)
                            + (ar * E * (h * h) / 8.0) * rot))
    K = w * dl
    pb, bb = (K * alr * dphi)[..., None], (K * alr * dbeta)[..., None]
    guA = (K * ald)[..., None] * du
    a3Ab = pb * a3B + bb * anB
    a3Bb = pb * a3A + _cross(tB, bb * a3A)
    tBb = _cross(bb * a3A, a3B)
    vb = _unit_rev(tB, lT, tBb)
    gBu, gBv = dxB[..., :1] * vb, dxB[..., 1:] * vb
    gdx2, gdx3 = _dot(xBu, vb), _dot(xBv, vb)
    vb = _unit_rev(a3B, lB, a3Bb)
    gBu, gBv = gBu + _cross(xBv, vb), gBv + _cross(vb, xBu)
    vb = _unit_rev(a3A, lA, a3Ab)
    gAu, gAv = _cross(xAv, vb), _cross(vb, xAu)
    gz = torch.cat([guA, gAu, gAv, -guA, gBu, gBv], -1)
    # the geometry
    A3Ab = -(pb * A3B + bb * AnB)
    AnBb = -(bb * A3A)
    A3Bb = -(pb * A3A) + _cross(TB, AnBb)
    vb = _unit_rev(TB, lTB, _cross(AnBb, A3B))
    hBu, hBv = gBu + dxB[..., :1] * vb, gBv + dxB[..., 1:] * vb
    gdx2, gdx3 = gdx2 + _dot(vb, XBu), gdx3 + _dot(vb, XBv)
    vb = _unit_rev(A3B, lNB, A3Bb)
    hBu, hBv = hBu + _cross(XBv, vb), hBv - _cross(XBu, vb)
    vb = _unit_rev(A3A, lNA, A3Ab)
    hAu, hAv = gAu + _cross(XAv, vb), gAv - _cross(XAu, vb)
    dXb = (w * dens / dl)[..., None] * dX
    hAu, hAv = hAu + dxA[..., :1] * dXb, hAv + dxA[..., 1:] * dXb
    gX = torch.cat([hAu, hAv, hBu, hBv], -1)
    gdx = torch.stack([_dot(dXb, XAu), _dot(dXb, XAv), gdx2, gdx3], -1)
    return gz, gX, gh, gdx


def _k6_inputs(s, xi4, dA, dB, d, cp, h, lam):
    """Rows (6, 2, I, N, L), node values (2, I, N, L, 10) = (cp, d, lam,
    h) and the density's jets and scalars at every point of the port's MI
    system s, as K6 forms them."""
    mi, co, ss = s.mi, s.co, s.ss
    I, N = mi.n_int, mi.n_max
    ip = torch.cat([mi.pairA[:, None].expand(I, N).reshape(-1),
                    mi.pairB[:, None].expand(I, N).reshape(-1)])
    conn, R = _lane_rows2(ss, s.pdeg, s.qdeg, ip,
                          xi4.permute(2, 0, 1, 3).reshape(-1, 2))
    L = conn.shape[-1]
    R = R.reshape(6, 2, I, N, L)
    ipl = ip.long()[:, None]
    vals = torch.cat([f[ipl, conn.long()] for f in (cp, d, lam)]
                     + [h[ipl, conn.long()][..., None]], -1)
    vals = vals.reshape(2, I, N, L, 10)
    jet = lambda k, c: torch.einsum("sinl,sinlc->insc", R[k], vals[..., c])
    Xj = torch.cat([jet(1, slice(0, 3)), jet(2, slice(0, 3))], -1)
    zj = torch.cat([jet(0, slice(3, 6)), jet(1, slice(3, 6)),
                    jet(2, slice(3, 6))], -1)
    lj = torch.cat([jet(0, slice(6, 9)), jet(1, slice(6, 9)),
                    jet(2, slice(6, 9))], -1)
    hj = jet(0, slice(9, 10))[..., 0]
    E = torch.maximum(s.E[mi.pairA.long()], s.E[mi.pairB.long()])
    scal = (hj[..., 0], hj[..., 1], dA, dB, E[:, None].expand(I, N),
            co.ad_scale[:, None].expand(I, N),
            co.ar_scale[:, None].expand(I, N), co.w_s)
    return (R, vals, Xj.reshape(I, N, 12), zj.reshape(I, N, 18),
            lj.reshape(I, N, 18), scal)


def _k6_transcribed(s, xi4, dA, dB, d, cp, h, lam):
    """K6 transcribed: the sweep forward over reverse, then the chain rule
    lane by lane through the second-derivative rows: (I, N, 8)."""
    R, vals, X, z, lz, (hA, hB, *rest) = _k6_inputs(s, xi4, dA, dB, d, cp,
                                                    h, lam)
    (gz, gX, gh, gdx), (Tz, TX, Th, Tdx) = torch.func.jvp(
        lambda zz: _sweep_all(X, zz, hA, hB, *rest), (z,), (lz,))
    out = []
    for side in range(2):
        v = vals[side]
        cpv, dv, lv, hv = v[..., 0:3], v[..., 3:6], v[..., 6:9], v[..., 9]
        Tzs, gzs = Tz[..., 9 * side:9 * side + 9], gz[..., 9 * side:9 * side + 9]
        TXs = TX[..., 6 * side:6 * side + 6]

        def con(a, b):      # (I, N, 3) . (I, N, L, 3) -> (I, N, L)
            return torch.einsum("inc,inlc->inl", a, b)

        c0 = con(Tzs[..., 0:3], dv) + con(gzs[..., 0:3], lv) \
            + Th[..., None] * hv
        c1 = con(Tzs[..., 3:6], dv) + con(TXs[..., 0:3], cpv) \
            + con(gzs[..., 3:6], lv)
        c2 = con(Tzs[..., 6:9], dv) + con(TXs[..., 3:6], cpv) \
            + con(gzs[..., 6:9], lv)
        Ru, Rv, Ruu, Ruv, Rvv = (R[k, side] for k in range(1, 6))
        out += [(Ru * c0 + Ruu * c1 + Ruv * c2).sum(-1),
                (Rv * c0 + Ruv * c1 + Rvv * c2).sum(-1)]
    return torch.cat([torch.stack(out, -1), Tdx], -1)


@pytest.fixture(scope="module")
def mi_small():
    """The port's small MI T-beam and, as tensors, the seeded state of
    `_torch_port_common.mi_state(2)`: (s, xi4, dA, dB, d, cp, h, lam)."""
    from _torch_port_common import mi_state
    from goldfish_tpu_torch.physics import coupling_mi

    s = port_mi_tbeam()
    cp, h, xi, d, lam = (torch.from_numpy(a) for a in mi_state(2))
    mi = s.mi
    xi4 = xi.reshape(mi.n_int, mi.n_max, 2, 2).contiguous()
    dA = coupling_mi._curve_tangents(xi4[:, :, 0], mi.n_pts)
    dB = coupling_mi._curve_tangents(xi4[:, :, 1], mi.n_pts)
    return s, xi4, dA, dB, d, cp, h, lam


def test_penalty_sweep_all_cotangents_match_autograd(mi_small):
    from goldfish_tpu_torch.physics import coupling

    s, xi4, dA, dB, d, cp, h, lam = mi_small
    _, _, X, z, _, (hA, hB, tA, tB, E, ad, ar, w) = _k6_inputs(*mi_small)
    got = _sweep_all(X, z, hA, hB, tA, tB, E, ad, ar, w)
    args = [a.clone().requires_grad_(True) for a in (z, X, hA, tA, tB)]
    f = coupling.penalty_density(args[1], args[0], args[2], hB, args[3],
                                 args[4], E, ad, ar, w)
    gz, gX, ghA, gA, gB = torch.autograd.grad(f.sum(), args)
    assert rel(got[0], gz) <= TOL
    assert rel(got[1], gX) <= TOL
    assert rel(got[2], ghA) <= TOL
    assert rel(got[3], torch.cat([gA, gB], -1)) <= TOL


def test_k6_transcription_matches_plain_and_jax(mi_small, monkeypatch):
    import jax.numpy as jnp

    from _torch_port_common import jax_mi_tbeam, mi_state
    from goldfish_tpu.solver.system_mi import _jit_res_vjp_mi
    from goldfish_tpu_torch.physics import coupling_mi

    s, xi4, dA, dB, d, cp, h, lam = mi_small
    got = _k6_transcribed(*mi_small)
    plain = coupling_mi._xi_grad_plain(s.ss, s.pdeg, s.qdeg, s.mi, s.co,
                                       xi4, dA, dB, d, cp, h, s.E, lam)
    assert rel(got, plain) <= TOL
    # through the tangents' chain, against the xi part of the JAX vjp
    monkeypatch.setattr(
        coupling_mi, "mi_penalty_xi",
        lambda ss, p, q, mi, co, x4, a, b, *rest: _k6_transcribed(
            s, x4, a, b, *rest[:3], rest[4]))
    # the residual is masked by the free dofs (system_mi._res_vjp_mi)
    dxi = coupling_mi.penalty_xi_vjp(s.ss, s.pdeg, s.qdeg, s.mi, s.co,
                                     xi4.reshape(s.mi.n_int, -1), d, cp, h,
                                     s.E, lam * s.data.free)
    js = jax_mi_tbeam()
    J = jnp.asarray
    cp_, h_, xi_, d_, lam_ = mi_state(2)
    ref = _jit_res_vjp_mi(js.data, js.mi, js.co, js.ss, js.pdeg, js.qdeg,
                          J(d_), J(cp_), J(h_), J(xi_), J(lam_))[2]
    assert rel(dxi, np.asarray(ref)) <= TOL


def test_k6_padded_points_give_exact_zeros(mi_small):
    s, *rest = mi_small
    w = s.co.w_s.clone()
    w[0, 3] = 0.0
    w[0, -1] = 0.0
    s0 = type("S", (), dict(mi=s.mi, co=s.co._replace(w_s=w), ss=s.ss,
                            pdeg=s.pdeg, qdeg=s.qdeg, E=s.E))
    got = _k6_transcribed(s0, *rest)
    assert bool(torch.isfinite(got).all())
    assert bool((got[w == 0] == 0).all())
    assert bool((got[w != 0] != 0).any(-1).all())


# ------------------------------------------------------------ K9 sweep
def _vm_sweep(X, z, h, E, nu, zeta, gb):
    """vm_stress_qp.cu's vm_sweep, transcribed (batched over qps):
    gb . dsigma/d(z (15), X (15), h), zeros where sigma = 0."""
    A1, A2 = X[..., 0:3], X[..., 3:6]
    Xs = [X[..., 6 + 3 * i:9 + 3 * i] for i in range(3)]
    A3 = _cross(A1, A2)
    lA3 = torch.sqrt(_dot(A3, A3))
    A3 = A3 / lA3[..., None]
    a = (_dot(A1, A1), _dot(A1, A2), _dot(A2, A2))
    b = [_dot(Xi, A3) for Xi in Xs]
    x = X + z
    x0, x1 = x[..., 0:3], x[..., 3:6]
    xs = [x[..., 6 + 3 * i:9 + 3 * i] for i in range(3)]
    a3 = _cross(x0, x1)
    la3 = torch.sqrt(_dot(a3, a3))
    a3 = a3 / la3[..., None]
    bc = [_dot(xi, a3) for xi in xs]
    zh = zeta * h
    ac = (_dot(x0, x0), _dot(x0, x1), _dot(x1, x1))
    s = [0.5 * (ac[i] - a[i]) + zh * (b[i] - bc[i]) for i in range(3)]
    det = a[0] * a[2] - a[1] * a[1]
    Au = (a[2] / det, -a[1] / det, a[0] / det)
    c = E / (1.0 - nu * nu)
    tr = Au[0] * s[0] + Au[1] * s[1] + Au[1] * s[1] + Au[2] * s[2]
    m11 = Au[0] * s[0] + Au[1] * s[1]
    m12 = Au[0] * s[1] + Au[1] * s[2]
    m21 = Au[1] * s[0] + Au[2] * s[1]
    m22 = Au[1] * s[1] + Au[2] * s[2]
    S11 = c * (nu * tr * Au[0] + (1.0 - nu) * (m11 * Au[0] + m12 * Au[1]))
    S12 = c * (nu * tr * Au[1] + (1.0 - nu) * (m11 * Au[1] + m12 * Au[2]))
    S21 = c * (nu * tr * Au[1] + (1.0 - nu) * (m21 * Au[0] + m22 * Au[1]))
    S22 = c * (nu * tr * Au[2] + (1.0 - nu) * (m21 * Au[1] + m22 * Au[2]))
    le1 = torch.sqrt(_dot(A1, A1))
    e1 = A1 / le1[..., None]
    p = _dot(A2, e1)
    e2 = A2 - p[..., None] * e1
    le2 = torch.sqrt(_dot(e2, e2))
    e2 = e2 / le2[..., None]
    T11, T12, T21, T22 = _dot(A1, e1), _dot(A1, e2), _dot(A2, e1), \
        _dot(A2, e2)
    u1, u2 = S11 * T11 + S21 * T21, S12 * T11 + S22 * T21
    w1, w2 = S11 * T12 + S21 * T22, S12 * T12 + S22 * T22
    s11, s22, s12 = u1 * T11 + u2 * T21, w1 * T12 + w2 * T22, \
        u1 * T12 + u2 * T22
    v = s11 * s11 + s22 * s22 - s11 * s22 + 3.0 * (s12 * s12)
    pos = v > 0.0
    vb = gb / (2.0 * torch.sqrt(torch.where(pos, v, 1.0)))
    s11b, s22b, s12b = vb * (2.0 * s11 - s22), vb * (2.0 * s22 - s11), \
        vb * (6.0 * s12)
    u1b, u2b = s11b * T11 + s12b * T12, s11b * T21 + s12b * T22
    w1b, w2b = s22b * T12, s22b * T22
    T11b = s11b * u1 + u1b * S11 + u2b * S12
    T21b = s11b * u2 + u1b * S21 + u2b * S22
    T12b = s12b * u1 + s22b * w1 + w1b * S11 + w2b * S12
    T22b = s12b * u2 + s22b * w2 + w1b * S21 + w2b * S22
    S11b, S21b = u1b * T11 + w1b * T12, u1b * T21 + w1b * T22
    S12b, S22b = u2b * T11 + w2b * T12, u2b * T21 + w2b * T22
    k1, k2 = c * nu, c * (1.0 - nu)
    trb = k1 * (S11b * Au[0] + (S12b + S21b) * Au[1] + S22b * Au[2])
    m11b = k2 * (S11b * Au[0] + S12b * Au[1])
    m12b = k2 * (S11b * Au[1] + S12b * Au[2])
    m21b = k2 * (S21b * Au[0] + S22b * Au[1])
    m22b = k2 * (S21b * Au[1] + S22b * Au[2])
    Aub = (k1 * (S11b * tr) + k2 * (S11b * m11 + S21b * m21)
           + (m11b * s[0] + m12b * s[1] + trb * s[0]),
           k1 * ((S12b + S21b) * tr)
           + k2 * (S11b * m12 + S12b * m11 + S21b * m22 + S22b * m21)
           + (m11b * s[1] + m12b * s[2] + m21b * s[0] + m22b * s[1]
              + 2.0 * (trb * s[1])),
           k1 * (S22b * tr) + k2 * (S12b * m12 + S22b * m22)
           + (m21b * s[1] + m22b * s[2] + trb * s[2]))
    sb = (m11b * Au[0] + m21b * Au[1] + trb * Au[0],
          m11b * Au[1] + m12b * Au[0] + m21b * Au[2] + m22b * Au[1]
          + 2.0 * (trb * Au[1]),
          m12b * Au[1] + m22b * Au[2] + trb * Au[2])
    detb = -(Aub[0] * Au[0] + Aub[1] * Au[1] + Aub[2] * Au[2]) / det
    ab = [Aub[2] / det + detb * a[2], -Aub[1] / det - 2.0 * (detb * a[1]),
          Aub[0] / det + detb * a[0]]
    ab = [ab[i] - 0.5 * sb[i] for i in range(3)]
    gh = zeta * sum(sb[i] * (b[i] - bc[i]) for i in range(3))
    col = lambda y: y[..., None]  # noqa: E731
    x0b = 2.0 * col(0.5 * sb[0]) * x0 + col(0.5 * sb[1]) * x1
    x1b = col(0.5 * sb[1]) * x0 + 2.0 * col(0.5 * sb[2]) * x1
    xsb = [col(-zh * sb[i]) * a3 for i in range(3)]
    a3b = sum(col(-zh * sb[i]) * xs[i] for i in range(3))
    nb = _unit_rev(a3, la3, a3b)
    x0b, x1b = x0b + _cross(x1, nb), x1b + _cross(nb, x0)
    A1b = x0b + 2.0 * col(ab[0]) * A1 + col(ab[1]) * A2
    A2b = x1b + col(ab[1]) * A1 + 2.0 * col(ab[2]) * A2
    Xsb = [xsb[i] + col(zh * sb[i]) * A3 for i in range(3)]
    A3b = sum(col(zh * sb[i]) * Xs[i] for i in range(3))
    nb = _unit_rev(A3, lA3, A3b)
    A1b, A2b = A1b + _cross(A2, nb), A2b + _cross(nb, A1)
    A1b = A1b + col(T11b) * e1 + col(T12b) * e2
    A2b = A2b + col(T21b) * e1 + col(T22b) * e2
    e1b = col(T11b) * A1 + col(T21b) * A2
    e2rb = _unit_rev(e2, le2, col(T12b) * A1 + col(T22b) * A2)
    pb = -_dot(e2rb, e1)
    A2b = A2b + e2rb + col(pb) * e1
    e1b = e1b - col(p) * e2rb + col(pb) * A2
    A1b = A1b + _unit_rev(e1, le1, e1b)
    g = torch.cat([x0b, x1b, *xsb, A1b, A2b, *Xsb, gh[..., None]], -1)
    return torch.where(pos[..., None], g, 0.0)


def _plate_jets(s, d, cp, h):
    from goldfish_tpu_torch.physics import kl_shell

    Eq, nuq, _ = kl_shell._qp_params(s.stack, s.E, s.nu)
    return (kl_shell.jets(s.stack, cp), kl_shell.jets(s.stack, d),
            kl_shell.h_at_qps(s.stack, h), Eq, nuq)


def _scatter(stack, g, C):
    """K9's scatter, transcribed: B^T of each element's cotangents summed
    over its qps in order, then each node's partials over its incidence
    list in order: (dd, dcp, dh)."""
    from goldfish_tpu_torch.physics import kl_shell

    P, Ne, Q, L = stack.R00.shape
    R = torch.stack([stack.R10, stack.R01, stack.R20, stack.R11, stack.R02],
                    -2)                                    # (P, E, Q, 5, L)
    gz = g[..., 0:15].reshape(P, Ne, Q, 5, 3)
    gX = g[..., 15:30].reshape(P, Ne, Q, 5, 3)
    part = torch.cat([torch.einsum("peqjl,peqjc->pelc", R, gz),
                      torch.einsum("peqjl,peqjc->pelc", R, gX),
                      torch.einsum("peql,peq->pel", stack.R00,
                                   g[..., 30])[..., None]], -1)
    part = part.reshape(P * Ne * L, 7)
    ptr, idx = kl_shell.node_incidence(stack.conn, C)
    out = torch.zeros(P * C, 7, dtype=g.dtype)
    for n in range(P * C):
        acc = torch.zeros(7, dtype=g.dtype)
        for k in idx[ptr[n]:ptr[n + 1]].tolist():
            acc = acc + part[k]
        out[n] = acc
    out = out.reshape(P, C, 7)
    return out[..., 0:3], out[..., 3:6], out[..., 6], part


@pytest.mark.parametrize("through", ["top", "mid", "bottom"])
def test_vm_sweep_matches_autograd_and_zero_at_rest(through):
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, _, dn, gbar = plate_state()
    s = port_plate()
    zeta = kl_shell.ZETA[through]
    X, z, hq, Eq, nuq = _plate_jets(s, t(dn), t(cp), t(h))
    z = z.clone()
    z[0, 0, :4] = 0.0            # four strain-free qps: sigma = 0
    gb = t(gbar)
    got = _vm_sweep(X, z, hq, Eq, nuq, zeta, gb)
    args = [a.clone().requires_grad_(True) for a in (z, X, hq)]
    sig = kl_shell.stress_density(args[1], args[0], args[2], Eq, nuq, zeta)
    assert bool((sig.detach()[0, 0, :4] == 0).all())
    ref = torch.autograd.grad(sig, args, gb)
    assert rel(got, torch.cat([ref[0], ref[1], ref[2][..., None]], -1)) \
        <= TOL
    assert bool((got[0, 0, :4] == 0).all())


@pytest.mark.parametrize("through", ["top", "bottom"])
def test_vm_sweep_scattered_matches_jax_vjp(through):
    import jax
    import jax.numpy as jnp

    from _torch_port_common import jax_plate
    from goldfish_tpu.physics import kl_shell as jk
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, _, dn, gbar = plate_state()
    s = port_plate()
    X, z, hq, Eq, nuq = _plate_jets(s, t(dn), t(cp), t(h))
    g = _vm_sweep(X, z, hq, Eq, nuq, kl_shell.ZETA[through], t(gbar))
    dd, dcp, dh, _ = _scatter(s.stack, g, cp.shape[1])
    js = jax_plate()
    _, f = jax.vjp(lambda a, b, c: jk.qp_stress_vm(
        js.stack, a, b, c, js.E, js.nu, through=through),
        jnp.asarray(dn), jnp.asarray(cp), jnp.asarray(h))
    for got, ref in zip((dd, dcp, dh), f(jnp.asarray(gbar))):
        assert rel(got, np.asarray(ref)) <= TOL


def test_fixed_order_gather_matches_index_add_and_conn():
    from goldfish_tpu_torch.physics import kl_shell

    s = port_plate()
    st = s.stack
    P, Ne, Q, L = st.R00.shape
    C = s.cp.shape[1]
    g = torch.tensor(np.random.default_rng(3).normal(size=(P, Ne, Q, 31)))
    dd, dcp, dh, part = _scatter(st, g, C)
    node = (st.conn.long() + C * torch.arange(P)[:, None, None]).reshape(-1)
    ref = torch.zeros(P * C, 7, dtype=g.dtype).index_add_(0, node, part)
    got = torch.cat([dd, dcp, dh[..., None]], -1).reshape(P * C, 7)
    assert rel(got, ref) <= 1e-14
    ptr, idx = kl_shell.node_incidence(st.conn, C)
    assert ptr.dtype == idx.dtype == torch.int32
    assert int(ptr[-1]) == P * Ne * L == idx.numel()
    for n in range(P * C):
        pairs = idx[ptr[n]:ptr[n + 1]].long()
        assert torch.equal(pairs, torch.nonzero(node == n)[:, 0])
    # built once per conn tensor
    assert kl_shell.node_incidence(st.conn, C)[1] is idx


def test_chip_scripts_import_nothing_of_jax():
    """chip_smoke.py and the A/B script (which run where JAX is absent)
    name neither jax nor the JAX package in any import statement."""
    import ast

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for rel_path in ("chip_smoke.py", "scripts/torch_port_kernel_ab.py"):
        with open(os.path.join(root, rel_path)) as fh:
            tree = ast.parse(fh.read())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.module]
        bad = [m for m in names if m.split(".")[0] in ("jax",
                                                       "goldfish_tpu")]
        assert not bad, (rel_path, bad)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _mi_system(name, dev):
    if name == "tbeam":
        from goldfish_tpu_torch.models import tbeam

        return tbeam.build_mi(**MI_SMALL, device=dev)
    from goldfish_tpu_torch.demos import draft_tube_shopt_mi_wffd as md

    return md.build_mi_tube(**TUBE_SMALL, pressure=5e2, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["tbeam", "tube"])
@pytest.mark.parametrize("seam", ["moved", "on-knot"])
def test_mi_penalty_xi_matches_plain_on_the_card(cuda, name, seam):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import coupling_mi

    s = _mi_system(name, cuda)
    cp, h, xi, d, lam = _smoke().mi_state(s)
    if seam == "on-knot":
        xi = s.c2x.xi0_flat
    mi = s.mi
    x4 = xi.reshape(mi.n_int, mi.n_max, 2, 2).contiguous()
    tA = coupling_mi._curve_tangents(x4[:, :, 0], mi.n_pts).contiguous()
    tB = coupling_mi._curve_tangents(x4[:, :, 1], mi.n_pts).contiguous()
    args = (s.ss, s.pdeg, s.qdeg, mi, s.co, x4, tA, tB, d, cp, h, s.data.E,
            lam)
    n0 = _cuda.launch_counts["mi_penalty_xi"]
    outs = [coupling_mi.mi_penalty_xi(*args) for _ in range(5)]
    assert _cuda.launch_counts["mi_penalty_xi"] == n0 + 5
    plain = coupling_mi._xi_grad_plain(*args)
    assert rel(outs[0].cpu(), plain.cpu().numpy()) <= 1e-11
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.gpu
@pytest.mark.parametrize("through", ["top", "bottom"])
def test_vm_stress_matches_plain_and_is_bitwise_on_the_card(cuda, through):
    from goldfish_tpu_torch.models import plate
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, _, dn, gbar = (t(a).to(cuda) for a in plate_state())
    s = plate.build(**PLATE_SMALL, device=cuda)
    st, E, nu = s.stack, s.E, s.nu
    z = kl_shell.ZETA[through]
    got = kl_shell.vm_stress_value(st, dn, cp, h, E, nu, z)
    ref = kl_shell._stress_plain(st, dn, cp, h, E, nu, z)
    assert rel(got.cpu(), ref.cpu().numpy()) <= 1e-12
    outs = [kl_shell.vm_stress_vjp(st, dn, cp, h, E, nu, z, gbar)
            for _ in range(5)]
    ref = kl_shell._stress_vjp_plain(st, dn, cp, h, E, nu, z, gbar)
    for a, b in zip(outs[0], ref):
        assert rel(a.cpu(), b.cpu().numpy()) <= 1e-11
    assert all(torch.equal(a, b) for o in outs[1:]
               for a, b in zip(o, outs[0]))


@pytest.mark.gpu
def test_penalty_qp_bits_as_the_parent_tree_gave(cuda):
    sm = _smoke()
    with open(sm.K2_BITS) as fh:
        want = json.load(fh)["sha256"]
    got = {k: sm.sha256(v) for k, v in sm.k2_bits(cuda).items()}
    assert got == want
