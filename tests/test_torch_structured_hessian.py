"""The structured jet Hessian of K1's Hessian mode, and the redesigned K4.

K1 mode b computes H_q (15 x 15) from 6 AD columns and a closed form: the
second-jet block is H_ss = Hc (x) a3 a3^T, Hc the 3 x 3 Hessian of the
bending energy (h^3/24) Q(Aup, kap) J w in c, kap = b - (bc + c), and
H_sm = H_ms^T. The CPU tests pin that premise on the port's own density:
the plain version (`kl_shell._hessians_plain`, reverse over reverse,
independent of the structured formula) against Hc and a3 computed here
from the port's jets, at 1e-12 relative.

The `gpu`-marked tests hold K1's Hessian mode and K4 against their plain
versions at every group shape the paths pass (1e-11 relative in norm: f64
atomics sum in a run-dependent order), and check that a group shape
without a compile-time instantiation still launches the kernel. They skip
without a card; run them there with
`python -m pytest tests/test_torch_structured_hessian.py -m gpu
--noconftest -q`.
"""

import numpy as np
import pytest
import torch

from _torch_port_common import (
    PLATE_SMALL,
    TUBE_SMALL,
    WING_SMALL,
    port_press,
    rel,
    seeded_state,
    t,
)

TOL = 1e-12
KERNEL_TOL = 1e-11
SLICE_PRESSURE = 5.0e2


def _system(name, device="cpu"):
    """A small port system of each element / interface shape the paths
    pass: the wing (p = 3: 16 qps, L = 16; interfaces over 2L = 32), the
    plate (p = 2: 9 qps, L = 9; 2L = 18), the press (p = 2, two plates, no
    interface) and the tube (degree (3, 2): 12 qps, L = 12; 2L = 24)."""
    if name == "wing":
        from goldfish_tpu_torch.models import wing

        return wing.build(**WING_SMALL, device=device)
    if name == "plate":
        from goldfish_tpu_torch.models import plate

        return plate.build(**PLATE_SMALL, device=device)
    if name == "press":
        return port_press(num_el=3, device=device)
    from goldfish_tpu_torch.models import tube

    return tube.build(**TUBE_SMALL, pressure=SLICE_PRESSURE, device=device)


def _state(s, seed):
    """(cp, h, d, v) on the CPU: d at 1e-3 of the CP scale on free dofs."""
    cp, h = s.cp.cpu(), s.h_init.cpu()
    rng = np.random.default_rng(seed)
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    d = t(1e-3 * scale * rng.normal(size=tuple(cp.shape))) * s.data.free.cpu()
    return cp, h, d, t(rng.normal(size=tuple(cp.shape)))


def _hc_a3(stack, d, cp, h, E, nu):
    """Hc (..., 3, 3) and the current unit normal a3 (..., 3) at every qp,
    from the port's jets and its SVK quadratic form."""
    from goldfish_tpu_torch.physics import kl_shell as tk

    X, z, hq = tk.jets(stack, cp), tk.jets(stack, d), tk.h_at_qps(stack, h)
    A1, A2 = X[..., 0:3], X[..., 3:6]
    A3 = tk._cross(A1, A2)
    J = torch.sqrt(tk._dot(A3, A3))
    A3 = A3 / J[..., None]
    a = (tk._dot(A1, A1), tk._dot(A1, A2), tk._dot(A2, A2))
    det = a[0] * a[2] - a[1] * a[1]
    Aup = torch.stack((a[2] / det, -a[1] / det, a[0] / det), -1)
    b = torch.stack([tk._dot(X[..., 6 + 3 * i:9 + 3 * i], A3)
                     for i in range(3)], -1)
    x = X + z
    a3 = tk._cross(x[..., 0:3], x[..., 3:6])
    a3 = a3 / torch.sqrt(tk._dot(a3, a3))[..., None]
    bc = torch.stack([tk._dot(x[..., 6 + 3 * i:9 + 3 * i], a3)
                      for i in range(3)], -1)
    Eq, nuq, wq = tk._qp_params(stack, E, nu)

    def bending(c, A, kb, hh, Jw, EE, nn):
        return (hh ** 3 / 24.0) * tk._quad_form(
            A, kb - c, EE / (1.0 - nn * nn), nn) * Jw

    shp = hq.shape
    args = (torch.zeros(shp + (3,), dtype=torch.float64), Aup, b - bc, hq,
            J * wq, Eq, nuq)
    Hc = torch.func.vmap(torch.func.hessian(bending))(
        *(u.reshape((-1,) + u.shape[len(shp):]) for u in args))
    return Hc.reshape(shp + (3, 3)), a3


@pytest.mark.parametrize("name", ["wing", "press"])
@pytest.mark.parametrize("seed", [0, 1])
def test_second_jet_block_is_closed_form(name, seed):
    """H_ss = Hc (x) a3 a3^T and H_sm = H_ms^T in the plain Hessian, at a
    seeded state with d != 0 (p = 3 wing and p = 2 press)."""
    from goldfish_tpu_torch.physics import kl_shell as tk

    s = _system(name)
    cp, h, d, _ = _state(s, seed)
    st, E, nu = s.stack, s.data.E, s.data.nu
    H = tk._hessians_plain(st, d, cp, h, E, nu)
    Hc, a3 = _hc_a3(st, d, cp, h, E, nu)
    Hss = torch.einsum("...ij,...x,...y->...ixjy", Hc, a3, a3).reshape(
        Hc.shape[:-2] + (9, 9))
    assert float(torch.linalg.norm(H[..., :6, :6])) > 0.0
    assert rel(H[..., 6:, 6:], Hss.numpy()) <= TOL
    assert rel(H[..., 6:, :6], H[..., :6, 6:].transpose(-1, -2).numpy()) \
        <= TOL


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(data, dev, pressure):
    from goldfish_tpu_torch.bridge import from_numpy_tree

    if pressure:
        data = data._replace(pressure=torch.full(
            (data.E.shape[0],), SLICE_PRESSURE, dtype=torch.float64))
    return data if dev == "cpu" else from_numpy_tree(data, dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["wing", "plate", "press", "tube"])
def test_shell_hess_kernel_matches_plain(cuda, name):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import kl_shell as tk

    s = _system(name, "cpu")
    cp, h, d, _ = _state(s, 2)
    gd = _on(s.data, cuda, False)
    n0 = _cuda.launch_counts["shell_qp/hess"]
    Hk = tk.shell_hessians(gd.stack, d.to(cuda), cp.to(cuda), h.to(cuda),
                           gd.E, gd.nu)
    Hp = tk._hessians_plain(s.stack, d, cp, h, s.data.E, s.data.nu)
    assert _cuda.launch_counts["shell_qp/hess"] == n0 + 1
    assert rel(Hk.cpu(), Hp.numpy()) <= KERNEL_TOL


# every group shape (nq, nj, nloc) of the small systems: the system that
# passes it, with a follower pressure or not, its group, and whether K4
# compiles it (the pressure groups of p = 3 and p = 2 elements run on no
# path and take the runtime-shape instantiation)
SHAPES = {(16, 5, 16): ("wing", False, 0, True),
          (1, 6, 32): ("wing", False, 1, True),
          (16, 3, 16): ("wing", True, 2, False),
          (9, 5, 9): ("plate", False, 0, True),
          (1, 6, 18): ("plate", False, 1, True),
          (9, 3, 9): ("plate", True, 2, False),
          (12, 5, 12): ("tube", False, 0, True),
          (1, 6, 24): ("tube", False, 1, True),
          (12, 3, 12): ("tube", True, 2, True)}


def _groups(data, d, cp, h):
    from goldfish_tpu_torch.solver import system

    tab = system.jet_tables(data)
    Hs = system.jet_hessians(data, d, cp, h)
    return tab, [(Hs[0], tab.R_e, tab.gi_e), (Hs[1], tab.R_i, tab.gi_i),
                 (Hs[2], tab.R_p, tab.gi_e)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", list(SHAPES), ids=str)
def test_jet_matvec_kernel_matches_plain(cuda, shape):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver import system

    name, pressure, k, compiled = SHAPES[shape]
    s = _system(name, "cpu")
    cp, h, d, v = _state(s, 3)
    dc = _on(s.data, "cpu", pressure)
    tab, groups = _groups(dc, d, cp, h)
    H, R, gi = groups[k]
    assert tuple(R.shape[1:]) == shape
    assert (_cuda.library().gf_jet_matvec_variant(*shape) >= 0) == compiled
    y = torch.zeros(v.numel(), dtype=torch.float64)
    system._matvec_plain(y, H, R, gi, tab.free, v.reshape(-1))
    g = [u.to(cuda) for u in (H, R, gi, tab.free, v.reshape(-1))]
    yk = torch.zeros_like(g[-1])
    n0 = _cuda.launch_counts["jet_matvec"]
    system.jet_matvec(yk, *g)
    assert _cuda.launch_counts["jet_matvec"] == n0 + 1
    assert rel(yk.cpu(), y.numpy()) <= KERNEL_TOL


@pytest.mark.gpu
def test_jet_matvec_unlisted_shape_launches_the_kernel(cuda, monkeypatch):
    """(7, 5, 16) and (1, 6, 20) have no compile-time instantiation: the
    runtime-shape kernel serves them, nothing goes to the plain version."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver import system

    s = _system("wing", "cpu")
    cp, h, d, v = _state(s, 4)
    tab, groups = _groups(s.data, d, cp, h)
    cases = [(groups[0][0][:, :7], groups[0][1][:, :7], groups[0][2]),
             (groups[1][0], groups[1][1][..., :20], groups[1][2][:, :60])]
    for H, R, gi in cases:
        H, R, gi = H.contiguous(), R.contiguous(), gi.contiguous()
        assert _cuda.library().gf_jet_matvec_variant(*R.shape[1:]) == -1
        y = torch.zeros(v.numel(), dtype=torch.float64)
        system._matvec_plain(y, H, R, gi, tab.free, v.reshape(-1))
        g = [u.to(cuda) for u in (H, R, gi, tab.free, v.reshape(-1))]
        yk = torch.zeros_like(g[-1])
        n0 = _cuda.launch_counts["jet_matvec"]
        with monkeypatch.context() as m:
            m.setattr(system, "_matvec_plain", _no_plain)
            system.jet_matvec(yk, *g)
        assert _cuda.launch_counts["jet_matvec"] == n0 + 1
        assert rel(yk.cpu(), y.numpy()) <= KERNEL_TOL


def _no_plain(*args):
    raise AssertionError("a CUDA tensor went to the plain version")
