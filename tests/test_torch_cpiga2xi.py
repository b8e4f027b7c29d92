"""The port's CP -> xi map (geometry/cpiga2xi, plain version of K7) against
goldfish_tpu/geometry/cpiga2xi on the small MI T-beam: the padded
intersection tables are equal, the residual and its Jacobian agree at a
bent design and a moved xi (1e-12; also for an edge-to-edge seam, whose
coincidence rows take the edge variant), the solved xi agrees to 1e-10
absolute, and the adjoint dcp of `_c2x_adjoint_direct` to 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_common import jax_mi_tbeam, mi_cp, port_mi_tbeam, rel


def _edge_pair():
    """Two flat patches side by side whose seam runs along an edge of
    each (A's u = 1, B's u = 0): both_edges = 1. Returns the JAX and the
    port CPIGA2Xi."""
    from goldfish_tpu.geometry.cpiga2xi import CPIGA2Xi as JX
    from goldfish_tpu.models import tbeam as jt
    from goldfish_tpu.physics.coupling import InterfaceSpec as JS
    from goldfish_tpu_torch.geometry.cpiga2xi import CPIGA2Xi as PX
    from goldfish_tpu_torch.models import tbeam as pt
    from goldfish_tpu_torch.physics.coupling import InterfaceSpec as PS

    L = jt.LENGTH
    ptsA = [[-1, 0, 0], [0, 0, 0], [-1, L, 0], [0, L, 0]]
    ptsB = [[0, 0, 0], [1, 0, 0], [0, L, 0], [1, L, 0]]
    kw = dict(pair=(0, 1), xi_ends_A=np.array([[1.0, 0.0], [1.0, 1.0]]),
              xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]), n_mortar_el=6)
    jx = JX([jt.create_surf(ptsA, 2, 3, 3), jt.create_surf(ptsB, 2, 4, 3)],
            [JS(**kw)], n_pts_list=[7])
    px = PX([pt.create_surf(ptsA, 2, 3, 3), pt.create_surf(ptsB, 2, 4, 3)],
            [PS(**kw)], n_pts_list=[7], device="cpu")
    return jx, px


@pytest.fixture(scope="module")
def c2x():
    return jax_mi_tbeam().c2x, port_mi_tbeam().c2x


def test_moving_intersections_equal(c2x):
    jx, px = c2x
    for f in jx.mi._fields:
        a, b = np.asarray(getattr(jx.mi, f)), getattr(px.mi, f).numpy()
        assert a.shape == b.shape and np.array_equal(a, b), f


@pytest.mark.parametrize("seam", ["tbeam", "edge"])
def test_residual_and_jacobian_match(c2x, seam):
    from goldfish_tpu.geometry import cpiga2xi as jc
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    if seam == "tbeam":
        jx, px = c2x
        cp = mi_cp(jax_mi_tbeam(), 0.05)
    else:
        jx, px = _edge_pair()
        from goldfish_tpu.geometry.patch_stack import stack_control_points
        from goldfish_tpu.geometry.patch_stack import build_patch_stack
        _, metas = build_patch_stack(jx.surfs)
        cp = np.array(stack_control_points(metas))
        cp[..., 0] *= 1.02
        assert float(px.mi.both_edges[0]) == 1.0
    rng = np.random.default_rng(3)
    x = np.asarray(jx.xi0_flat) + 1e-3 * rng.normal(size=jx.xi0_flat.shape)
    r_j = jc._c2x_res(jx.ss, jx.mi, jnp.asarray(cp), jnp.asarray(x),
                      p=jx.p, q=jx.q)
    J_j = jc._c2x_jac(jx.ss, jx.mi, jnp.asarray(cp), jnp.asarray(x),
                      p=jx.p, q=jx.q)
    r_p, J_p = pc.c2x_res_jac(px.ss, px.p, px.q, px.mi, torch.tensor(cp),
                              torch.tensor(x))
    assert rel(r_p, r_j) <= 1e-12
    assert rel(J_p, J_j) <= 1e-12


def test_solve_and_adjoint_match(c2x):
    from goldfish_tpu.geometry import cpiga2xi as jc
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    jx, px = c2x
    cp = mi_cp(jax_mi_tbeam(), 0.05)
    x_j = np.asarray(jx.solve(jnp.asarray(cp)))
    x_p = px.solve(torch.tensor(cp))
    assert np.abs(x_p.numpy() - x_j).max() <= 1e-10
    assert px.residual_norm(torch.tensor(cp), x_p) <= 1e-12
    g = np.random.default_rng(4).normal(size=x_j.shape)
    dcp_j = jc._c2x_adjoint_direct(jx.ss, jx.mi, jnp.asarray(cp),
                                   jnp.asarray(x_j), jnp.asarray(g),
                                   p=jx.p, q=jx.q)
    dcp_p = pc.c2x_adjoint(px.ss, px.p, px.q, px.mi, torch.tensor(cp), x_p,
                           torch.tensor(g))
    assert rel(dcp_p, dcp_j) <= 1e-9


def test_solve_is_differentiable(c2x):
    """xi(cp) as a torch.autograd.Function: the backward of sum(g * xi)
    is the implicit-function adjoint."""
    from goldfish_tpu_torch.geometry import cpiga2xi as pc

    _, px = c2x
    cp = torch.tensor(mi_cp(jax_mi_tbeam(), 0.05), requires_grad=True)
    g = torch.tensor(np.random.default_rng(4).normal(
        size=tuple(px.xi0_flat.shape)))
    x = px.solve(cp)
    (x * g).sum().backward()
    ref = pc.c2x_adjoint(px.ss, px.p, px.q, px.mi, cp.detach(), x.detach(),
                         g)
    assert rel(cp.grad, ref.numpy()) <= 1e-14
