"""The premises of K11 vlm_aic's reverse sweep and K8 pressure_qp's
element-summed kernels, and the design tangent of `DispImOperation` with
contact and a follower pressure (ROADMAP C7).

- K11's VJP sweeps each segment of a horseshoe back on its own: the
  cotangent of every segment's velocity is the same gbar_ij n_i. A plain
  PyTorch transcription of that segment-local sweep (csrc/vlm_aic.cu:
  `horseshoe_rev`, the six pullbacks summed, plus dn = gbar v) equals
  `vlm.aic_vjp_plain` and the JAX VJP through goldfish_tpu/physics/vlm.py's
  horseshoe on seeded 5 x 8 lattices, symmetric and not (1e-12).
- K8's jet Hessian -d2w/dz2 is made of c [y]x blocks with zero diagonal
  blocks (the closed form of csrc/pressure_qp.cu's mode 1) and equals
  `loads._pressure_hessians_plain` (1e-14); B^T g summed over each
  element's qps first (modes 0 and 2) equals the per-qp scatter on the
  num_el=3 tube (1e-14).
- `apply_linear_fwd(d_cp=, d_h=)` on the num_el=3 contact press and on the
  small pressurized tube equals the JAX package's `DispImOperation` (its jvp
  through the whole residual), 1e-12.

The `gpu`-marked tests hold both kernels against their plain versions on
the card: K8 at L = 12, 9 and 16 (the tube, plate and wing; padded qps, wq
= 0, give exact zeros), K11 at N = 60, 100 (not a multiple of 32) and 1024.
They skip without a card; run them there with `python -m pytest
tests/test_torch_k8_k11.py -m gpu --noconftest -q`.
"""

import math

import numpy as np
import pytest
import torch

from _torch_port_common import (
    PLATE_SMALL,
    PRESSURE,
    TUBE_SMALL,
    WING_SMALL,
    port_press,
    press_state,
    rel,
    t,
)

TOL = 1e-12
KERNEL_TOL = 1e-11
MIRROR = torch.tensor([1.0, -1.0, 1.0], dtype=torch.float64)


# ------------------------------------------------------------ K11 premise
def _lattice(mc=5, ns=8, seed=0):
    """(colloc, nhat, A, B, wake) of a seeded bent half-wing lattice (numpy
    corners, the root on the symmetry plane), each a CPU tensor."""
    from goldfish_tpu_torch.physics import vlm

    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.linspace(0.0, 1.0, mc + 1),
                       np.linspace(0.0, 4.0, ns + 1), indexing="ij")
    c = np.stack([X + 0.1 * Y, Y, 0.05 * np.sin(np.pi * X)
                  + 0.02 * (Y / 4.0) ** 2], -1)
    c += 1e-3 * rng.normal(size=c.shape)
    c[:, 0, 1] = 0.0
    A, B, colloc, nhat, _ = vlm.panel_geometry(t(c))
    return [u.contiguous() for u in (colloc, nhat, A, B)] + \
        [vlm.wake_direction("cpu")]


def _dot(a, b):
    return (a * b).sum(-1, keepdim=True)


def _leg_sweep(r, il, w, vb, s):
    """One semi-infinite leg at r = P - E, il = 1 / (|r| + 1e-300),
    cotangent s vb: (s v_leg, the pullback in r, the pullback in |r|), as
    csrc/vlm_aic.cu's `leg_rev`."""
    cr = torch.cross(w.expand_as(r), r, dim=-1)
    cosv = _dot(w, r) * il
    iden = 1.0 / ((_dot(cr, cr) + 1e-8) * (4.0 * math.pi))
    k = (cosv + 1.0) * iden
    cb = s * _dot(vb, cr) * iden
    crb = s * vb * k - 2.0 * (cb * k) * (4.0 * math.pi) * cr
    ab = cb * il
    return s * cr * k, ab * w + torch.cross(crb, w.expand_as(crb), dim=-1), \
        -ab * cosv


def _horseshoe_sweep(P, A, B, w, vb):
    """The unit horseshoe A -> B at P swept back segment by segment: (v,
    Pb, Ab, Bb) for the cotangent vb of v, as `horseshoe_rev`."""
    r1, r2, r0 = P - A, P - B, B - A
    il1 = 1.0 / (torch.sqrt(_dot(r1, r1)) + 1e-300)
    il2 = 1.0 / (torch.sqrt(_dot(r2, r2)) + 1e-300)
    # the bound segment
    cr = torch.cross(r1, r2, dim=-1)
    t1, t2 = _dot(r0, r1) * il1, _dot(r0, r2) * il2
    iden = 1.0 / ((_dot(cr, cr) + 1e-8) * (4.0 * math.pi))
    k = (t1 - t2) * iden
    nb = _dot(vb, cr) * iden
    crb = vb * k - 2.0 * (nb * k) * (4.0 * math.pi) * cr
    a1b, a2b = nb * il1, -nb * il2
    r1b = a1b * r0 + torch.cross(r2, crb, dim=-1)
    r2b = a2b * r0 + torch.cross(crb, r1, dim=-1)
    r0b = a1b * r1 + a2b * r2
    l1b, l2b = -a1b * t1, -a2b * t2
    # the legs B -> infinity (+) and infinity -> A (-)
    vB, rb, lb = _leg_sweep(r2, il2, w, vb, 1.0)
    r2b, l2b = r2b + rb, l2b + lb
    vA, rb, lb = _leg_sweep(r1, il1, w, vb, -1.0)
    r1b, l1b = r1b + rb, l1b + lb
    g1 = r1b + l1b * il1 * r1
    g2 = r2b + l2b * il2 * r2
    return cr * k + vB + vA, g1 + g2, -(g1 + r0b), r0b - g2


def segment_sweep_vjp(colloc, nhat, A, B, wake, gbar, symmetric=True):
    """K11 mode 1 by the segment-local sweep in plain torch: (dc, dn, dA,
    dB)."""
    P, Ap, Bp = colloc[:, None, :], A[None, :, :], B[None, :, :]
    vb = gbar[..., None] * nhat[:, None, :]
    v, Pb, Ab, Bb = _horseshoe_sweep(P, Ap, Bp, wake, vb)
    if symmetric:
        vm, Pm, Bmb, Amb = _horseshoe_sweep(P, Bp * MIRROR, Ap * MIRROR,
                                            wake, vb)
        v, Pb = v + vm, Pb + Pm
        Ab, Bb = Ab + MIRROR * Amb, Bb + MIRROR * Bmb
    dn = (gbar[..., None] * v).sum(1)
    return Pb.sum(1), dn, Ab.sum(0), Bb.sum(0)


def _jax_aic_vjp(colloc, nhat, A, B, wake, gbar, symmetric):
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.physics.vlm import _horseshoe_induced

    w = jnp.asarray(wake.numpy())
    mir = jnp.array([1.0, -1.0, 1.0])

    def aic(c, n, a, b):
        vind = _horseshoe_induced(c, a, b, w)
        if symmetric:
            vind = vind + _horseshoe_induced(c, b * mir, a * mir, w)
        return jnp.sum(vind * n[:, None, :], -1)

    _, vjp = jax.vjp(aic, *(jnp.asarray(u.numpy())
                            for u in (colloc, nhat, A, B)))
    return vjp(jnp.asarray(gbar.numpy()))


@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_segment_sweep_equals_aic_vjp(seed, symmetric):
    from goldfish_tpu_torch.physics import vlm

    io = _lattice(seed=seed)
    N = io[0].shape[0]
    gbar = t(np.random.default_rng(10 + seed).normal(size=(N, N)))
    got = segment_sweep_vjp(*io, gbar, symmetric)
    plain = vlm.aic_vjp_plain(*io, gbar, symmetric)
    ref = _jax_aic_vjp(*io, gbar, symmetric)
    for name, a, b, c in zip(("dc", "dn", "dA", "dB"), got, plain, ref):
        assert rel(a, b.detach().numpy()) <= TOL, name
        assert rel(a, np.asarray(c)) <= TOL, name


# ------------------------------------------------------------ K8 premises
@pytest.fixture(scope="module")
def tube3():
    """The num_el=3 pressurized tube (the port's, on the CPU) at a seeded
    state: (stack, d, cp, pressure, lam)."""
    from goldfish_tpu_torch.models import tube

    s = tube.build(**TUBE_SMALL, pressure=PRESSURE, device="cpu")
    rng = np.random.default_rng(3)
    d = t(1e-2 * rng.normal(size=tuple(s.cp.shape))) * s.data.free
    lam = t(rng.normal(size=tuple(s.cp.shape)))
    return s.stack, d, s.cp, s.data.pressure, lam


def _cross_blocks(x, c):
    """-d2w/dz2 (..., 9, 9) from the current jets x (..., 9) = (a, b, e)
    and c = p wq / 3: zero diagonal blocks; block (r, s) = +c [y]x in the
    cyclic order (a, b), (b, e), (e, a), -c [y]x in the other, y the third
    jet; [y]x t = y x t."""
    def skew(y):
        z = torch.zeros_like(y[..., 0])
        return torch.stack([torch.stack([z, -y[..., 2], y[..., 1]], -1),
                            torch.stack([y[..., 2], z, -y[..., 0]], -1),
                            torch.stack([-y[..., 1], y[..., 0], z], -1)], -2)

    H = torch.zeros(x.shape[:-1] + (9, 9), dtype=x.dtype)
    for r in range(3):
        for s in range(3):
            if r == s:
                continue
            y = x[..., 3 * (3 - r - s):3 * (3 - r - s) + 3]
            sign = 1.0 if s == (r + 1) % 3 else -1.0
            H[..., 3 * r:3 * r + 3, 3 * s:3 * s + 3] = \
                sign * c[..., None, None] * skew(y)
    return H


def test_pressure_hessian_is_cross_product_blocks(tube3):
    from goldfish_tpu_torch.physics import loads

    st, d, cp, pr, _ = tube3
    x = loads.pressure_jets(st, cp) + loads.pressure_jets(st, d)
    c = pr[:, None, None] / 3.0 * st.wq
    H = loads._pressure_hessians_plain(st, d, cp, pr)
    got = _cross_blocks(x, c)
    assert rel(got, H.numpy()) <= 1e-14
    for r in range(3):
        assert bool((H[..., 3 * r:3 * r + 3, 3 * r:3 * r + 3] == 0).all())


def _scatter(stack, gz, C, element_first):
    """B^T g of per-qp jet cotangents gz (P, E, Q, 9): per (qp, local node)
    as the per-qp scatter, or with each element's qps summed first."""
    from goldfish_tpu_torch.physics import loads
    from goldfish_tpu_torch.physics.kl_shell import _index_add_nodes

    R = loads._pressure_tables(stack)
    contrib = sum(R[j][..., None] * gz[..., None, 3 * j:3 * j + 3]
                  for j in range(3))                      # (P, E, Q, L, 3)
    if element_first:
        return _index_add_nodes(stack.conn, contrib.sum(2), gz.shape[0], C)
    P, E, Q, L, _ = contrib.shape
    conn = stack.conn[:, :, None, :].expand(P, E, Q, L)
    return _index_add_nodes(conn.reshape(P, E * Q, L),
                            contrib.reshape(P, E * Q, L, 3), P, C)


def test_element_summed_scatter_equals_per_qp_scatter(tube3):
    from goldfish_tpu_torch.physics import loads

    st, d, cp, pr, lam = tube3
    X, z = loads.pressure_jets(st, cp), loads.pressure_jets(st, d)
    prq = loads._pr_qp(st, pr)
    _, vjp = torch.func.vjp(
        lambda zz: loads.pressure_density(X, zz, prq, st.wq), z)
    (gz,) = vjp(torch.ones_like(st.wq))
    # mode 2's g: (d2w/dz2) lambda_z = -H lambda_z
    H = loads._pressure_hessians_plain(st, d, cp, pr)
    gl = -(H @ loads.pressure_jets(st, lam)[..., None])[..., 0]
    C = cp.shape[1]
    for g, ref in ((gz, loads._pressure_value_grad_plain(st, d, cp, pr)[1]),
                   (gl, loads._pressure_adjoint_plain(st, d, cp, pr, lam))):
        per_qp = _scatter(st, g, C, element_first=False)
        elem = _scatter(st, g, C, element_first=True)
        assert rel(elem, per_qp.numpy()) <= 1e-14
        assert rel(elem, ref.numpy()) <= 1e-14


# ------------------------------------------------------------ C7
def _flat(layout, x, k=3):
    x = np.asarray(x)
    return np.asarray(layout.to_flat(x if k == 3 else x[..., None])).ravel()


def _press():
    from test_contact import _press_problem

    ps = port_press(num_el=3)
    cp, h, d, _, _ = press_state(ps, seed=0, drop=0.03)
    return _press_problem(num_el=3), ps, (cp, h, d)


def _tube():
    from _torch_port_common import jax_tube, seeded_state
    from goldfish_tpu_torch.models import tube

    js = jax_tube()
    cp, h, d, _, _ = seeded_state(0, js)
    return js, tube.build(**TUBE_SMALL, pressure=PRESSURE, device="cpu"), \
        (cp, h, d)


@pytest.mark.parametrize("build", [_press, _tube], ids=["press", "tube"])
def test_design_tangent_with_contact_and_pressure_matches_jax(build):
    from goldfish_tpu.operations import DispImOperation as JaxDisp
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.operations import DispImOperation

    js, ps, (cp, h, d) = build()
    assert (ps.data.contact is not None) or (ps.data.pressure is not None)
    jop, pop = JaxDisp(js), DispImOperation(ps)
    lay = jop.layout
    for op in (jop, pop):
        op.linearize(_flat(lay, cp), _flat(lay, h, 1), _flat(lay, d))
    rng = np.random.default_rng(3)
    t_cp = 1e-3 * rng.normal(size=_flat(lay, cp).size)
    t_h = 1e-3 * rng.normal(size=_flat(lay, h, 1).size)
    _cuda.reset_launch_counts()
    for kw in (dict(d_cp=t_cp), dict(d_h=t_h), dict(d_cp=t_cp, d_h=t_h)):
        assert rel(pop.apply_linear_fwd(**kw), jop.apply_linear_fwd(**kw)) \
            <= TOL, sorted(kw)
    assert all(n == 0 for n in _cuda.launch_counts.values())


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _small(name):
    """A port system of each element shape K8 meets: the tube (degree (3,
    2): Q = L = 12), the plate (p = 2: Q = L = 9), the wing (p = 3: Q = L =
    16); the tube and the wing pad their stacks with wq = 0 qps."""
    if name == "tube":
        from goldfish_tpu_torch.models import tube

        return tube.build(**TUBE_SMALL, pressure=PRESSURE, device="cpu")
    if name == "plate":
        from goldfish_tpu_torch.models import plate

        return plate.build(**PLATE_SMALL, device="cpu")
    from goldfish_tpu_torch.models import wing

    return wing.build(**WING_SMALL, device="cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["value_grad", "hess", "adjoint"])
@pytest.mark.parametrize("name", ["tube", "plate", "wing"])
def test_pressure_kernel_matches_plain(cuda, name, mode):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.physics import loads

    s = _small(name)
    st = s.stack
    P = s.cp.shape[0]
    rng = np.random.default_rng(9)
    cp = s.cp
    d = t(1e-2 * rng.normal(size=tuple(cp.shape))) * s.data.free
    lam = t(rng.normal(size=tuple(cp.shape)))
    pr = t(np.linspace(3e2, 7e2, P))
    g = from_numpy_tree(st, cuda)
    dc, cc, pc, lc = (u.to(cuda) for u in (d, cp, pr, lam))
    kern = {"value_grad": lambda: loads.pressure_value_grad(g, dc, cc, pc),
            "hess": lambda: loads.pressure_hessians(g, dc, cc, pc),
            "adjoint": lambda: loads.pressure_adjoint(g, dc, cc, pc, lc)}
    plain = {"value_grad": lambda: loads._pressure_value_grad_plain(
        st, d, cp, pr),
        "hess": lambda: loads._pressure_hessians_plain(st, d, cp, pr),
        "adjoint": lambda: loads._pressure_adjoint_plain(st, d, cp, pr, lam)}
    n0 = _cuda.launch_counts[f"pressure_qp/{mode}"]
    got = kern[mode]()
    assert _cuda.launch_counts[f"pressure_qp/{mode}"] == n0 + 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain[mode]()
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert rel(a.cpu(), b.numpy()) <= KERNEL_TOL
    if mode == "hess":
        pad = (st.wq == 0).to(cuda)
        assert bool(pad.any()) == (name != "plate")
        assert bool((got[0][pad] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("symmetric", [True, False])
@pytest.mark.parametrize("shape", [(6, 10), (5, 20), (16, 64)],
                         ids=["N60", "N100", "N1024"])
def test_aic_kernel_matches_plain(cuda, shape, symmetric):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import vlm

    io = _lattice(*shape, seed=4)
    N = io[0].shape[0]
    gbar = t(np.random.default_rng(5).normal(size=(N, N)))
    dev = [u.to(cuda) for u in io]
    n0 = dict(_cuda.launch_counts)
    a = vlm.aic_value(*dev, symmetric)
    g = vlm.aic_vjp(*dev, gbar.to(cuda), symmetric)
    assert _cuda.launch_counts["vlm_aic/value"] == n0["vlm_aic/value"] + 1
    assert _cuda.launch_counts["vlm_aic/vjp"] == n0["vlm_aic/vjp"] + 1
    assert rel(a.cpu(), vlm.aic_plain(*io, symmetric).numpy()) <= 1e-12
    for x, y in zip(g, vlm.aic_vjp_plain(*io, gbar, symmetric)):
        assert bool(torch.isfinite(x).all())
        assert rel(x.cpu(), y.detach().numpy()) <= KERNEL_TOL
