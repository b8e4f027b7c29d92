"""The hand-written reverse sweeps of K1 shell_qp (modes 0, 2, 3) and K2
penalty_qp (modes 0, 1, 2), and the cancellation-free shell density.

K2's sweep (csrc/penalty_sweep.cuh) rests on the structure of the penalty
density F = w dl [1/2 alpha_d |uA - uB|^2 + 1/2 alpha_r (dphi^2 +
dbeta^2)]: dl, A3A, A3B, TB and AnB come from the geometry jets alone, and
the rotation jumps from the first jets alone, so the u-u block of the jet
Hessian is closed form and u against the first jets is exactly zero. K1's
sweep takes dpsi/dh in closed form. The CPU tests pin these premises on the
port's plain versions, which the parity tests hold to the JAX package: at
seeded states, 1e-12 relative. They also hold
`kl_shell.shell_density_increments` (the cancellation-free strains that
trace ROADMAP C6) to the plain density far from the linear regime.

The `gpu`-marked tests hold K1's three gradient modes and K2's three modes
against their plain versions at every element and interface shape the
paths pass (1e-11 relative in norm: f64 atomics sum in a run-dependent
order), padded interface qps to exact zeros, and K6 (which runs K2's sweep
forward over reverse, tests/test_torch_k6_k9.py) to its plain version.
They skip without a card; run them there with `python -m pytest
tests/test_torch_reverse_sweeps.py -m gpu --noconftest -q`.
"""

import numpy as np
import pytest
import torch

from _torch_port_common import (
    MI_SMALL,
    PLATE_SMALL,
    TUBE_SMALL,
    WING_SMALL,
    port_press,
    rel,
    t,
)

TOL = 1e-12
KERNEL_TOL = 1e-11
SLICE_PRESSURE = 5.0e2
U = [0, 1, 2, 9, 10, 11]                       # uA, uB in the 18-jet
M = [3, 4, 5, 6, 7, 8, 12, 13, 14, 15, 16, 17]  # their first jets


def _system(name, device="cpu"):
    """A small port system of each element / interface shape the paths
    pass: the wing (p = 3: 16 qps, L = 16), the plate (p = 2: 9 qps, L =
    9), the press (p = 2, no interface), the tube (degree (3, 2): 12 qps,
    L = 12) and the moving-intersection T-beam (p = 3)."""
    if name == "wing":
        from goldfish_tpu_torch.models import wing

        return wing.build(**WING_SMALL, device=device)
    if name == "plate":
        from goldfish_tpu_torch.models import plate

        return plate.build(**PLATE_SMALL, device=device)
    if name == "press":
        return port_press(num_el=3, device=device)
    if name == "mi":
        from goldfish_tpu_torch.models import tbeam

        return tbeam.build_mi(**MI_SMALL, device=device)
    from goldfish_tpu_torch.models import tube

    return tube.build(**TUBE_SMALL, pressure=SLICE_PRESSURE, device=device)


def _state(s, seed, amp=1e-2):
    """(cp, h, d, lam) on the CPU: d at `amp` of the CP scale on free
    dofs, lam standard normal."""
    cp, h = s.cp.cpu(), s.h_init.cpu()
    rng = np.random.default_rng(seed)
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    d = t(amp * scale * rng.normal(size=tuple(cp.shape))) \
        * s.data.free.cpu()
    return cp, h, d, t(rng.normal(size=tuple(cp.shape)))


# ------------------------------------------------------------ K2's premises
def _unit(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def _geometry(X, dxA, dxB):
    """dl, A3A, A3B, AnB from the geometry jets alone (penalty_sweep.cuh's
    forward geometry part)."""
    from goldfish_tpu_torch.physics.kl_shell import _cross, _dot

    XAu, XAv, XBu, XBv = (X[..., 3 * k:3 * k + 3] for k in range(4))
    dX = XAu * dxA[..., 0:1] + XAv * dxA[..., 1:2]
    A3B = _unit(_cross(XBu, XBv))
    TB = _unit(XBu * dxB[..., 0:1] + XBv * dxB[..., 1:2])
    return (torch.sqrt(_dot(dX, dX)), _unit(_cross(XAu, XAv)), A3B,
            _cross(A3B, TB))


@pytest.mark.parametrize("name", ["wing", "tube"])
@pytest.mark.parametrize("seed", [0, 1])
def test_penalty_hessian_u_blocks_are_closed_form(name, seed):
    """H_uu = w dl alpha_d [[I, -I], [-I, I]] and H_um = 0 exactly in the
    plain (reverse over reverse) jet Hessian."""
    from goldfish_tpu_torch.physics import coupling as tc

    s = _system(name)
    cp, h, d, _ = _state(s, seed)
    ifs, E = s.data.ifs, s.data.E
    H = tc._hessians_plain(ifs, d, cp, h, E)
    X, _, hA, hB, Ei, ad, _ = tc._qp_inputs(ifs, d, cp, h, E)
    dl = _geometry(X, ifs.dxiA, ifs.dxiB)[0]
    kd = ifs.w * dl * (ad * Ei) * (0.5 * (hA + hB))
    blk = torch.tensor([[1.0, -1.0], [-1.0, 1.0]], dtype=torch.float64)
    Huu = torch.einsum("in,ab,xy->inaxby", kd, blk,
                       torch.eye(3, dtype=torch.float64)).reshape(
        kd.shape + (6, 6))
    assert float(torch.linalg.norm(H[..., M, :][..., :, M])) > 0.0
    assert rel(H[..., U, :][..., :, U], Huu.numpy()) <= TOL
    assert bool((H[..., U, :][..., :, M] == 0).all())
    assert bool((H[..., M, :][..., :, U] == 0).all())


@pytest.mark.parametrize("name", ["wing", "tube"])
def test_penalty_geometry_terms_do_not_depend_on_z(name):
    """The plain density equals the sweep's split: dl, A3A, A3B, AnB from
    X alone, and the rotation jumps from X + z's first jets alone, at a
    state far from the reference (d at 5e-2 of the CP scale)."""
    from goldfish_tpu_torch.physics import coupling as tc
    from goldfish_tpu_torch.physics.kl_shell import _cross, _dot

    s = _system(name)
    cp, h, d, _ = _state(s, 2, amp=5e-2)
    ifs, E = s.data.ifs, s.data.E
    X, z, hA, hB, Ei, ad, ar = tc._qp_inputs(ifs, d, cp, h, E)
    F = tc.penalty_density(X, z, hA, hB, ifs.dxiA, ifs.dxiB, Ei, ad, ar,
                           ifs.w)
    dl, A3A, A3B, AnB = _geometry(X, ifs.dxiA, ifs.dxiB)
    x = X + z[..., M]
    xBu, xBv = x[..., 6:9], x[..., 9:12]
    dxB = ifs.dxiB
    a3A = _unit(_cross(x[..., 0:3], x[..., 3:6]))
    a3B = _unit(_cross(xBu, xBv))
    anB = _cross(a3B, _unit(xBu * dxB[..., 0:1] + xBv * dxB[..., 1:2]))
    dphi = _dot(a3A, a3B) - _dot(A3A, A3B)
    dbeta = _dot(a3A, anB) - _dot(A3A, AnB)
    du = z[..., 0:3] - z[..., 9:12]
    h_ = 0.5 * (hA + hB)
    split = ifs.w * dl * (0.5 * (ad * Ei * h_) * _dot(du, du)
                          + 0.5 * (ar * Ei * h_ ** 3 / 12.0)
                          * (dphi ** 2 + dbeta ** 2))
    assert float(torch.linalg.norm(dphi)) > 0.0
    assert rel(split, F.numpy()) <= TOL


# ------------------------------------------------------------ K1's premise
@pytest.mark.parametrize("name", ["wing", "plate", "press"])
def test_shell_dpsi_dh_is_closed_form(name):
    """d(psi J w)/dh = J w (1/2 Q(Aup, eps) + h^2/8 Q(Aup, kap)), the
    closed form of K1's sweep, against autograd of the plain density."""
    from goldfish_tpu_torch.physics import kl_shell as tk

    s = _system(name)
    cp, h, d, _ = _state(s, 3)
    st, E, nu = s.stack, s.data.E, s.data.nu
    X, z, hq = tk.jets(st, cp), tk.jets(st, d), tk.h_at_qps(st, h)
    Eq, nuq, wq = tk._qp_params(st, E, nu)
    gh = torch.func.grad(lambda hh: tk.shell_density(
        X, z, hh, Eq, nuq, wq).sum())(hq)
    A1, A2 = X[..., 0:3], X[..., 3:6]
    A3 = tk._cross(A1, A2)
    J = torch.sqrt(tk._dot(A3, A3))
    A3 = A3 / J[..., None]
    a = (tk._dot(A1, A1), tk._dot(A1, A2), tk._dot(A2, A2))
    x = X + z
    a3 = _unit(tk._cross(x[..., 0:3], x[..., 3:6]))
    ac = (tk._dot(x[..., 0:3], x[..., 0:3]), tk._dot(x[..., 0:3], x[..., 3:6]),
          tk._dot(x[..., 3:6], x[..., 3:6]))
    eps = tuple(0.5 * (ac[i] - a[i]) for i in range(3))
    kap = tuple(tk._dot(X[..., 6 + 3 * i:9 + 3 * i], A3)
                - tk._dot(x[..., 6 + 3 * i:9 + 3 * i], a3) for i in range(3))
    det = a[0] * a[2] - a[1] * a[1]
    Aup = (a[2] / det, -a[1] / det, a[0] / det)
    c = Eq / (1.0 - nuq * nuq)
    closed = J * wq * (0.5 * tk._quad_form(Aup, eps, c, nuq)
                       + hq * hq / 8.0 * tk._quad_form(Aup, kap, c, nuq))
    assert float(torch.linalg.norm(gh)) > 0.0
    assert rel(closed, gh.numpy()) <= TOL


# ------------------------------------------------------------ C6's yardstick
@pytest.mark.parametrize("name", ["wing", "press", "tube"])
def test_cancellation_free_density_matches_plain(name):
    """The increment form of the strains (`shell_density_increments`)
    gives the plain value, r and dW/dh at a state far from the linear
    regime (d at 5e-2 of the CP scale), where the plain form loses
    nothing to cancellation."""
    from goldfish_tpu_torch.physics import kl_shell as tk

    s = _system(name)
    cp, h, d, _ = _state(s, 4, amp=5e-2)
    st, E, nu = s.stack, s.data.E, s.data.nu
    plain = tk._value_grad_plain(st, d, cp, h, E, nu)
    inc = tk._value_grad_plain(st, d, cp, h, E, nu,
                               density=tk.shell_density_increments)
    for a, b in zip(inc, plain):
        assert rel(a, b.numpy()) <= TOL


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(data, dev):
    from goldfish_tpu_torch.bridge import from_numpy_tree

    return from_numpy_tree(data, dev)


def _cpu(ifs):
    return type(ifs)(*(u.cpu() for u in ifs))


def _check(counter, kernel, plain):
    from goldfish_tpu_torch import _cuda

    n0 = _cuda.launch_counts[counter]
    got = kernel()
    assert _cuda.launch_counts[counter] == n0 + 1
    got = got if isinstance(got, tuple) else (got,)
    want = plain()
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        assert rel(a.cpu(), b.cpu().numpy()) <= KERNEL_TOL


K1_MODES = ("value_grad", "adjoint", "geom_grad")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", K1_MODES)
@pytest.mark.parametrize("name", ["wing", "plate", "press", "tube", "mi"])
def test_shell_sweep_modes_match_plain(cuda, name, mode):
    from goldfish_tpu_torch.physics import kl_shell as tk

    s = _system(name)
    cp, h, d, lam = _state(s, 5)
    st, E, nu = s.stack, s.data.E, s.data.nu
    g = _on(s.data, cuda)
    gs, gE, gnu = g.stack, g.E, g.nu
    dc, cc, hc, lc = (u.to(cuda) for u in (d, cp, h, lam))
    kern = {"value_grad": lambda: tk.shell_value_grad(gs, dc, cc, hc, gE,
                                                      gnu),
            "adjoint": lambda: tk.shell_adjoint(gs, dc, cc, hc, gE, gnu, lc),
            "geom_grad": lambda: tk.shell_geom_grad(gs, dc, cc, hc, gE,
                                                    gnu)}[mode]
    plain = {"value_grad": lambda: tk._value_grad_plain(st, d, cp, h, E, nu),
             "adjoint": lambda: tk._adjoint_plain(st, d, cp, h, E, nu, lam),
             "geom_grad": lambda: tk._geom_grad_plain(st, d, cp, h, E,
                                                      nu)}[mode]
    _check(f"shell_qp/{mode}", kern, plain)


def _interfaces(name, cuda):
    """(system, interface stack on the card, the same on the CPU): the
    system's own, or for "mi" the stack of K5's rows at a seam moved off
    its solution."""
    s = _system(name, cuda if name == "mi" else "cpu")
    if name != "mi":
        return s, _on(s.data, cuda).ifs, s.data.ifs
    from goldfish_tpu_torch.physics import coupling_mi

    xi0 = s.c2x.xi0_flat
    xi = (xi0 + 1e-3 * torch.cos(torch.arange(
        xi0.numel(), device=cuda, dtype=xi0.dtype)).reshape(
        xi0.shape)).clamp(0.0, 1.0).contiguous()
    ifs = coupling_mi.interface_stack_mi(s.ss, s.pdeg, s.qdeg, s.mi, s.co,
                                         xi)
    return s, ifs, _cpu(ifs)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["value_grad", "hess", "adjoint"])
@pytest.mark.parametrize("name", ["wing", "plate", "tube", "mi"])
def test_penalty_sweep_modes_match_plain(cuda, name, mode):
    from goldfish_tpu_torch.physics import coupling as tc

    s, gi, ci = _interfaces(name, cuda)
    cp, h, d, lam = _state(s, 6)
    E = s.data.E.cpu()
    dc, cc, hc, lc, Ec = (u.to(cuda) for u in (d, cp, h, lam, E))
    kern = {"value_grad": lambda: tc.penalty_value_grad(gi, dc, cc, hc, Ec),
            "hess": lambda: tc.penalty_hessians(gi, dc, cc, hc, Ec),
            "adjoint": lambda: tc.penalty_adjoint(gi, dc, cc, hc, Ec, lc)}
    plain = {"value_grad": lambda: tc._value_grad_plain(ci, d, cp, h, E),
             "hess": lambda: tc._hessians_plain(ci, d, cp, h, E),
             "adjoint": lambda: tc._adjoint_plain(ci, d, cp, h, E, lam)}
    _check(f"penalty_qp/{mode}", kern[mode], plain[mode])


@pytest.mark.gpu
def test_padded_interface_qps_are_exact_zeros_on_the_card(cuda):
    """The small wing's interfaces are padded to a common qp count (the
    other small systems have one length of interface each)."""
    from goldfish_tpu_torch.physics import coupling as tc

    s, gi, ci = _interfaces("wing", cuda)
    cp, h, d, _ = _state(s, 7)
    pad = (ci.w == 0).to(cuda)
    assert bool(pad.any())
    H = tc.penalty_hessians(gi, d.to(cuda), cp.to(cuda), h.to(cuda),
                            s.data.E.to(cuda))
    assert bool(torch.isfinite(H).all())
    assert bool((H[pad] == 0).all())


@pytest.mark.gpu
def test_mi_penalty_xi_still_matches_plain(cuda):
    """K6 on the small T-beam's seam on its knot (the sweep of
    penalty_sweep.cuh run forward over reverse)."""
    from goldfish_tpu_torch.physics import coupling_mi

    s = _system("mi", cuda)
    cp, h, d, lam = (u.to(cuda) for u in _state(s, 8))
    mi, co, ss, p, q = s.mi, s.co, s.ss, s.pdeg, s.qdeg
    I, N = mi.n_int, mi.n_max
    xi4 = s.c2x.xi0_flat.reshape(I, N, 2, 2)
    dA = coupling_mi._curve_tangents(xi4[:, :, 0], mi.n_pts).contiguous()
    dB = coupling_mi._curve_tangents(xi4[:, :, 1], mi.n_pts).contiguous()
    args = (ss, p, q, mi, co, xi4.contiguous(), dA, dB, d, cp, h, s.E, lam)
    _check("mi_penalty_xi", lambda: coupling_mi.mi_penalty_xi(*args),
           lambda: coupling_mi._xi_grad_plain(*args))
