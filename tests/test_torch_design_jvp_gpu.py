"""The forward design tangents on the card: K1 mode 4 (`shell_design_jvp`),
K2 mode 3 (`penalty_design_jvp`, on fixed interfaces and on K5's rows at a
moved seam), K6 mode 1 (`penalty_xi_jvp`), K7 mode 4 (`c2x_res_jvp`) and
the follower pressure's route through K8 mode c (`pressure_design_jvp`),
each against its plain version on the same CUDA tensors (relative error in
norm <= 1e-11: f64 atomics sum in a run-dependent order), and the
displacement operation with contact: a cp tangent (K12 mode 3,
`contact_pairs/design_fwd`) and an h tangent agree with the CPU's.

Needs no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_design_jvp_gpu.py -m gpu --noconftest -q

On the CPU every test skips (CUDA kernels have no CPU mode)."""

import numpy as np
import pytest
import torch

TOL = 1e-11


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _normal(rng, like, scale=1.0):
    return torch.tensor(scale * rng.normal(size=tuple(like.shape)),
                        dtype=torch.float64, device=like.device)


def _tangents(s, seed):
    """d at 1e-3 of the CP scale on free dofs, (tcp, th) standard normal."""
    rng = np.random.default_rng(seed)
    cp = s.cp
    scale = float(torch.linalg.norm(cp)) / np.sqrt(cp.numel())
    d = _normal(rng, cp, 1e-3 * scale) * s.data.free
    return d, _normal(rng, cp), _normal(rng, s.h_init)


@pytest.mark.gpu
def test_k1_k2_design_modes_match_plain(cuda):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.physics import coupling, kl_shell

    s = wing.build(n_chord=2, n_span=2, num_el=3, p=3, device=cuda)
    data, cp, h = s.data, s.cp, s.h_init
    d, tcp, th = _tangents(s, 0)
    _cuda.reset_launch_counts()
    got = kl_shell.shell_design_jvp(data.stack, d, cp, h, data.E, data.nu,
                                    tcp, th)
    want = kl_shell._design_jvp_plain(data.stack, d, cp, h, data.E,
                                      data.nu, tcp, th)
    assert _rel(got, want) <= TOL
    got = coupling.penalty_design_jvp(data.ifs, d, cp, h, data.E, tcp, th)
    want = coupling._design_jvp_plain(data.ifs, d, cp, h, data.E, tcp, th)
    assert _rel(got, want) <= TOL
    for name in ("shell_qp/design_fwd", "penalty_qp/design_fwd"):
        assert _cuda.launch_counts[name] == 1, name


@pytest.mark.gpu
def test_pressure_route_matches_plain_jvp(cuda):
    from goldfish_tpu_torch.models import tube
    from goldfish_tpu_torch.physics import loads

    s = tube.build(num_el=3, p=3, pressure=5e2, device=cuda)
    d, tcp, _ = _tangents(s, 1)
    st, pr = s.data.stack, s.data.pressure
    got = loads.pressure_design_jvp(st, d, s.cp, pr, tcp)
    want = loads._pressure_design_jvp_plain(st, d, s.cp, pr, tcp)
    assert _rel(got, want) <= TOL


@pytest.mark.gpu
def test_mi_design_modes_match_plain(cuda):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.geometry import cpiga2xi
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.physics import coupling, coupling_mi
    from goldfish_tpu_torch.solver.system_mi import data_at

    s = tbeam.build_mi(num_el=4, p=3, n_pts=17, device=cuda)
    data, mi, co, ss, p, q = s.mi_args
    d, tcp, th = _tangents(s, 2)
    rng = np.random.default_rng(3)
    x0 = s.c2x.xi0_flat
    xi = (x0 + _normal(rng, x0, 1e-3)).clamp(0.0, 1.0).contiguous()
    txi = _normal(rng, x0)
    _cuda.reset_launch_counts()
    ifs = data_at(data, mi, co, ss, p, q, xi).ifs
    got = coupling.penalty_design_jvp(ifs, d, s.cp, s.h_init, data.E, tcp,
                                      th)
    want = coupling._design_jvp_plain(ifs, d, s.cp, s.h_init, data.E, tcp,
                                      th)
    assert _rel(got, want) <= TOL
    got = coupling_mi.penalty_xi_jvp(ss, p, q, mi, co, xi, d, s.cp,
                                     s.h_init, data.E, txi)
    I, N = mi.n_int, mi.n_max
    xi4, t4 = xi.reshape(I, N, 2, 2), txi.reshape(I, N, 2, 2)
    tang = coupling_mi._curve_tangents
    want = coupling_mi._xi_fwd_plain(
        ss, p, q, mi, co, xi4, tang(xi4[:, :, 0], mi.n_pts),
        tang(xi4[:, :, 1], mi.n_pts), d, s.cp, s.h_init, data.E, t4,
        tang(t4[:, :, 0], mi.n_pts), tang(t4[:, :, 1], mi.n_pts))
    assert _rel(got, want) <= TOL
    got = cpiga2xi.c2x_res_jvp(ss, p, q, mi, s.cp, xi, tcp)
    want = cpiga2xi._res_jvp_plain(ss, p, q, mi, s.cp, xi, tcp)
    assert _rel(got, want) <= TOL
    for name in ("penalty_qp/design_fwd", "mi_penalty_xi/xi_fwd",
                 "c2x_res_jac/cp_fwd"):
        assert _cuda.launch_counts[name] == 1, name


def _press(num_el, device):
    """tests/test_contact.py's two-plate press at num_el."""
    from goldfish_tpu_torch.geometry.cadkit import bilinear
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    def plate_at(z):
        srf = bilinear([0, 0, z], [1, 0, z], [0, 1, z], [1, 1, z])
        srf = srf.elevate(0, 1).elevate(1, 1)
        nk = np.linspace(0, 1, num_el + 1)[1:-1]
        return srf.refine(0, nk).refine(1, nk)

    s = NonMatchingSystem([plate_at(0.12), plate_at(0.0)], E=1e7, nu=0.3,
                          h_th=0.01, device=device)
    for side in (0, 1):
        s.add_side_bc(0, direction=1, side=side, n_layers=2)
        s.add_side_bc(1, direction=1, side=side, n_layers=2)
    s.set_dead_load([[0, 0, -120.0], [0, 0, 0]])
    s.set_contact([(0, 1)], k_pen=1e7, r_max=0.1)
    return s


@pytest.mark.gpu
def test_disp_operation_with_contact_raises_for_a_cp_tangent(cuda):
    """(The name is kept from when a cp tangent raised here.) With contact,
    the cp-tangent product on the card (K12 mode 3, launched once) and the
    h-tangent product agree with the CPU's (1e-10)."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.operations import DispImOperation

    ops = []
    rng = np.random.default_rng(4)
    for dev in ("cpu", cuda):
        s = _press(4, dev)
        op = DispImOperation(s)
        lay = op.layout
        cp = lay.to_flat(s.cp).reshape(-1).cpu().numpy()
        h = lay.to_flat(s.h_init).reshape(-1).cpu().numpy()
        if dev == "cpu":
            # the upper plate moved into contact range, both plates strained
            # by seeded noise (a rigid motion leaves dR/dh zero)
            d = 1e-3 * rng.normal(size=cp.size)
            d[2:cp.size // 2:3] -= 0.03
        op.linearize(cp, h, d)
        ops.append(op)
    t_h = rng.normal(size=ops[0].h_size)
    assert _rel(ops[1].apply_linear_fwd(d_h=t_h),
                ops[0].apply_linear_fwd(d_h=t_h)) <= 1e-10
    t_cp = rng.normal(size=ops[0].vec_size)
    _cuda.reset_launch_counts()
    got = ops[1].apply_linear_fwd(d_cp=t_cp)
    assert _cuda.launch_counts["contact_pairs/design_fwd"] == 1
    assert _rel(got, ops[0].apply_linear_fwd(d_cp=t_cp)) <= 1e-10
