"""Traced NURBS rows of the port (ops/bspline_traced, plain version of K5)
against goldfish_tpu/ops/bspline_jax + jax.jacfwd: the SurfSet tables, the
span rule at ties (a point exactly on the knot 0.5, one ulp either side,
the domain's end 1.0), the rational rows, their first xi-derivatives and
(by autograd through the rows, as the plain versions of K6 and K7 take
them) their second xi-derivatives (relative error in norm 1e-13), and the
point evaluators."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import jax_mi_tbeam, port_mi_tbeam, rel

TOL = 1e-13


@pytest.fixture(scope="module")
def sets():
    from goldfish_tpu.ops import bspline_jax as bj
    from goldfish_tpu_torch.ops import bspline_traced as bt

    surfs = jax_mi_tbeam().surfs
    jss, (p, q) = bj.make_surf_set(surfs)
    pss, pq = bt.make_surf_set(port_mi_tbeam().surfs, device="cpu")
    assert pq == (p, q)
    return jss, pss, p, q


def _points(kind):
    """(ip, xi) as numpy: 20 points alternating between the patches."""
    rng = np.random.default_rng(5)
    xi = rng.uniform(0.0, 1.0, size=(20, 2))
    if kind == "knot":
        xi[:, 0] = 0.5                      # the seam's knot line
    elif kind == "ulp":
        xi[::2, 0] = np.nextafter(0.5, 1.0)
        xi[1::2, 0] = np.nextafter(0.5, 0.0)
    elif kind == "end":
        xi[::3] = 1.0
        xi[1::3, 1] = 0.0
    return np.array([0, 1] * 10, dtype=np.int32), xi


def test_surf_set_bit_identical(sets):
    jss, pss, _, _ = sets
    for f in jss._fields:
        a, b = np.asarray(getattr(jss, f)), getattr(pss, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("kind", ["random", "knot", "ulp", "end"])
def test_rows_and_derivatives_match_jacfwd(sets, kind):
    from goldfish_tpu.ops import bspline_jax as bj
    from goldfish_tpu_torch.ops import bspline_traced as bt

    jss, pss, p, q = sets
    ip, xi = _points(kind)
    xv = torch.from_numpy(xi).requires_grad_(True)
    conn, R = bt.traced_rows(pss, p, q, torch.from_numpy(ip), xv)
    # d(R_u, R_v)/d(xi_u, xi_v) row by row (each row depends on its point)
    L = R.shape[-1]
    R2 = torch.stack([torch.autograd.grad(R[a, :, l].sum(), xv,
                                          retain_graph=True)[0][:, b]
                      for a, b in ((1, 0), (1, 1), (2, 1))
                      for l in range(L)]).reshape(3, L, -1).transpose(1, 2)
    R = R.detach()

    def r0(k, t):
        _, wN = bj.surface_basis(jss, p, q, k, t)
        return wN / jnp.sum(wN)

    ref = {n: [] for n in ("conn", "R0", "R1", "R2")}
    for m in range(len(ip)):
        t = jnp.asarray(xi[m])
        k = int(ip[m])
        ref["conn"].append(np.asarray(bj.surface_basis(jss, p, q, k, t)[0]))
        ref["R0"].append(np.asarray(r0(k, t)))
        ref["R1"].append(np.asarray(jax.jacfwd(lambda s: r0(k, s))(t)))
        ref["R2"].append(np.asarray(
            jax.jacfwd(jax.jacfwd(lambda s: r0(k, s)))(t)))
    R1 = np.stack(ref["R1"])
    H = np.stack(ref["R2"])
    assert np.array_equal(conn.numpy(), np.stack(ref["conn"]))
    assert rel(R[0], np.stack(ref["R0"])) <= TOL
    assert rel(R[1], R1[..., 0]) <= TOL
    assert rel(R[2], R1[..., 1]) <= TOL
    assert rel(R2[0], H[..., 0, 0]) <= TOL
    assert rel(R2[1], H[..., 0, 1]) <= TOL
    assert rel(R2[2], H[..., 1, 1]) <= TOL


def test_surface_point_and_field_match(sets):
    from goldfish_tpu.ops import bspline_jax as bj
    from goldfish_tpu_torch.ops import bspline_traced as bt

    jss, pss, p, q = sets
    s = jax_mi_tbeam()
    cp = np.array(s.cp)
    coef = np.random.default_rng(6).normal(size=cp.shape[:2] + (2,))
    ip, xi = _points("random")
    pts = bt.surface_point(pss, p, q, torch.from_numpy(ip),
                           torch.from_numpy(cp), torch.from_numpy(xi))
    fld = bt.field_at(pss, p, q, torch.from_numpy(ip),
                      torch.from_numpy(coef), torch.from_numpy(xi))
    ref_p = np.stack([np.asarray(bj.surface_point(
        jss, p, q, int(k), jnp.asarray(cp), jnp.asarray(x)))
        for k, x in zip(ip, xi)])
    ref_f = np.stack([np.asarray(bj.field_at(
        jss, p, q, int(k), jnp.asarray(coef), jnp.asarray(x)))
        for k, x in zip(ip, xi)])
    assert rel(pts, ref_p) <= TOL
    assert rel(fld, ref_f) <= TOL
    conn, R0 = bt.surface_basis(pss, p, q, torch.from_numpy(ip),
                                torch.from_numpy(xi))
    for m, (k, x) in enumerate(zip(ip, xi)):
        c, wN = bj.surface_basis(jss, p, q, int(k), jnp.asarray(x))
        assert np.array_equal(conn[m].numpy(), np.asarray(c))
        assert rel(R0[m], np.asarray(wN) / float(np.sum(wN))) <= TOL
