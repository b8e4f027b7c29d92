"""Kernel dispatch rules of the port: a CPU tensor takes the plain PyTorch
version (no kernel launch counted); wrong dtype or shape raises on every
path; a CUDA tensor launches the kernel (checked only where a GPU is).
Entry points run on the current CUDA device unless the caller names one,
and raise without CUDA."""

import numpy as np
import pytest
import torch

from _torch_port_common import (
    MI_SMALL,
    WING_SMALL,
    port_data,
    port_press,
    press_state,
    rel,
    seeded_state,
    t,
)


def _mi_calls(s, d, cp, h, lam):
    """The moving-intersection kernels' wrappers on system s (K1's
    geometry gradient, K5-K7, K6's and K7's forward modes)."""
    from goldfish_tpu_torch.geometry import cpiga2xi
    from goldfish_tpu_torch.ops import bspline_traced
    from goldfish_tpu_torch.physics import coupling_mi, kl_shell

    mi, co, ss, p, q = s.mi, s.co, s.ss, s.pdeg, s.qdeg
    I, N = mi.n_int, mi.n_max
    # the seam moved off its solution, so that the CP->xi residual is not
    # at roundoff level
    xi0 = s.c2x.xi0_flat
    xi = (xi0 + 1e-3 * torch.cos(torch.arange(xi0.numel(), device=xi0.device,
                                              dtype=xi0.dtype)).reshape(
        xi0.shape)).clamp(0.0, 1.0).contiguous()
    xi4 = xi.reshape(I, N, 2, 2)
    ip = mi.pairA.repeat(N).contiguous()
    pts = xi4[:, :, 0].reshape(-1, 2).contiguous()
    dA = coupling_mi._curve_tangents(xi4[:, :, 0], mi.n_pts).contiguous()
    dB = coupling_mi._curve_tangents(xi4[:, :, 1], mi.n_pts).contiguous()
    g = torch.ones_like(xi)
    t4 = torch.cos(2.0 * torch.arange(xi4.numel(), device=xi.device,
                                      dtype=xi.dtype)).reshape(xi4.shape)
    tA = coupling_mi._curve_tangents(t4[:, :, 0], mi.n_pts).contiguous()
    tB = coupling_mi._curve_tangents(t4[:, :, 1], mi.n_pts).contiguous()
    return {
        "shell_qp/geom_grad": lambda: kl_shell.shell_geom_grad(
            s.stack, d, cp, h, s.E, s.nu),
        "traced_rows": lambda: bspline_traced.traced_rows(ss, p, q, ip, pts),
        "mi_penalty_xi": lambda: coupling_mi.mi_penalty_xi(
            ss, p, q, mi, co, xi4, dA, dB, d, cp, h, s.E, lam),
        "c2x_res_jac/res_jac": lambda: cpiga2xi.c2x_res_jac(
            ss, p, q, mi, cp, xi),
        "c2x_res_jac/adjoint": lambda: cpiga2xi.c2x_res_vjp(
            ss, p, q, mi, cp, xi, g),
        "c2x_res_jac/step": lambda: cpiga2xi.c2x_step(ss, p, q, mi, cp, xi),
        "c2x_res_jac/solve_adjoint": lambda: cpiga2xi.c2x_solve_adjoint(
            ss, p, q, mi, cp, xi, g),
        "mi_penalty_xi/xi_fwd": lambda: coupling_mi.mi_penalty_xi_fwd(
            ss, p, q, mi, co, xi4, dA, dB, d, cp, h, s.E, t4, tA, tB),
        "c2x_res_jac/cp_fwd": lambda: cpiga2xi.c2x_res_jvp(
            ss, p, q, mi, cp, xi, lam),
    }


def _mi_inputs(s, to):
    rng = np.random.default_rng(4)
    cp = s.cp.cpu().numpy()
    d = 1e-3 * rng.normal(size=cp.shape) * s.data.free.cpu().numpy()
    lam = rng.normal(size=cp.shape)
    return to(d), to(cp), to(s.h_init.cpu().numpy()), to(lam)


def _pressure(st, d):
    return torch.full((st.R00.shape[0],), 2.0e4, dtype=d.dtype,
                      device=d.device)


def _k10(data, d, cp, h, which):
    """K10 into the pair blocks or the patch blocks of `data` at d."""
    from goldfish_tpu_torch.solver import krylov, system

    ps = krylov.PairSchwarz(data)
    bt = ps.blocks if which == "pairs" else krylov._block_tables(data)
    return krylov.assemble_blocks(bt, ps.tables,
                                  system.jet_hessians(data, d, cp, h))


def _vlm_inputs(to):
    """K11's inputs on a seeded, cambered 4 x 6 lattice: (colloc, nhat, A,
    B, wake, gbar)."""
    from goldfish_tpu_torch.physics import vlm

    rng = np.random.default_rng(6)
    X, Y = np.meshgrid(np.linspace(0, 1, 5), np.linspace(0, 2, 7),
                       indexing="ij")
    Z = 0.05 * np.sin(np.pi * X) + 1e-3 * rng.normal(size=X.shape)
    A, B, colloc, nhat, _ = vlm.panel_geometry(to(np.stack([X, Y, Z], -1)))
    gbar = to(rng.normal(size=(24, 24)))
    return (colloc.contiguous(), nhat.contiguous(), A.contiguous(),
            B.contiguous(), vlm.wake_direction(gbar.device), gbar)


def _vlm_calls(colloc, nhat, A, B, wake, gbar):
    from goldfish_tpu_torch.physics import vlm

    return {
        "vlm_aic/value": lambda: vlm.aic_value(colloc, nhat, A, B, wake),
        "vlm_aic/vjp": lambda: vlm.aic_vjp(colloc, nhat, A, B, wake, gbar),
    }


def _contact_calls(device):
    """K12's cull (its sorted list of element pairs) and four modes on the
    small press (num_el=3) at a contact-active seeded state."""
    from goldfish_tpu_torch.physics import contact
    from goldfish_tpu_torch.solver import system

    s = port_press(num_el=3, device=device)
    cp, _, d, _, v = press_state(s, seed=7)

    def to(a):
        return t(a).to(device)

    c = s.data.contact
    x, w = (a.contiguous() for a in contact.contact_qps(s.stack, to(d),
                                                        to(cp)))
    vq = contact.qp_field(s.stack, to(v)).contiguous()
    dw = contact.qp_weights_jvp(s.stack, to(cp), to(v)).contiguous()
    tabs = system.jet_tables(s.data)

    def hess():
        N = tabs.free.numel()
        K = torch.zeros(N, N, dtype=torch.float64, device=device)
        return (contact.contact_hess(K, c, x, w, tabs.R_c, tabs.gi_e,
                                     tabs.free), K)

    def cull():
        cells = contact.contact_cells(c, x, w, tabs.R_c.shape[1])
        return torch.sort(cells.index[:int(cells.count)].long()).values

    return {
        "contact_pairs/cull": cull,
        "contact_pairs/value_grad": lambda: contact.contact_value_grad(c, x,
                                                                       w),
        "contact_pairs/hvp": lambda: contact.contact_hvp(c, x, w, vq),
        "contact_pairs/hess": hess,
        "contact_pairs/design_fwd": lambda: contact.contact_force_jvp(
            c, x, w, vq, dw),
    }


def _calls(data, d, cp, h, lam, v):
    from goldfish_tpu_torch.physics import coupling, kl_shell, loads
    from goldfish_tpu_torch.solver import system

    st, ifs = data.stack, data.ifs
    pr = _pressure(st, d)
    return {
        "shell_qp/value_grad": lambda: kl_shell.shell_value_grad(
            st, d, cp, h, data.E, data.nu),
        "shell_qp/hess": lambda: kl_shell.shell_hessians(
            st, d, cp, h, data.E, data.nu),
        "shell_qp/adjoint": lambda: kl_shell.shell_adjoint(
            st, d, cp, h, data.E, data.nu, lam),
        "shell_qp/design_fwd": lambda: kl_shell.shell_design_jvp(
            st, d, cp, h, data.E, data.nu, v, lam[..., 0].contiguous()),
        "penalty_qp/value_grad": lambda: coupling.penalty_value_grad(
            ifs, d, cp, h, data.E),
        "penalty_qp/hess": lambda: coupling.penalty_hessians(
            ifs, d, cp, h, data.E),
        "penalty_qp/adjoint": lambda: coupling.penalty_adjoint(
            ifs, d, cp, h, data.E, lam),
        "penalty_qp/design_fwd": lambda: coupling.penalty_design_jvp(
            ifs, d, cp, h, data.E, v, lam[..., 0].contiguous()),
        "jet_assemble": lambda: system.assemble_K(data, d, cp, h),
        "jet_matvec": lambda: system.tangent_matvec(data, d, cp, h, v),
        "pressure_qp/value_grad": lambda: loads.pressure_value_grad(
            st, d, cp, pr),
        "pressure_qp/hess": lambda: loads.pressure_hessians(st, d, cp, pr),
        "pressure_qp/adjoint": lambda: loads.pressure_adjoint(
            st, d, cp, pr, lam),
        "vm_stress_qp/value": lambda: kl_shell.vm_stress_value(
            st, d, cp, h, data.E, data.nu, 0.5),
        "vm_stress_qp/vjp": lambda: kl_shell.vm_stress_vjp(
            st, d, cp, h, data.E, data.nu, -0.5, st.wq * 1e-3),
        "vm_stress_qp/rows": lambda: kl_shell.vm_stress_rows(
            st, d, cp, h, data.E, data.nu, 0.5),
        "pair_assemble/pairs": lambda: _k10(data, d, cp, h, "pairs"),
        "pair_assemble/patches": lambda: _k10(data, d, cp, h, "patches"),
    }


def _chol_calls(data, d, cp, h):
    """K14's wrapper (the factor of the equilibrated wing's K at d, on a
    copy: the kernel factors in place) and K13's (one column, two columns,
    the diagonal blocks' inverses) on that factor."""
    from goldfish_tpu_torch.solver import cholesky, system

    K = system.assemble_K(data, d, cp, h)
    dsc = torch.rsqrt(K.diagonal().abs())
    K_eq = dsc[:, None] * K * dsc[None, :]
    L = torch.linalg.cholesky_ex(K_eq)[0]
    b = d.reshape(-1, 1)
    return {
        "chol_factor": lambda: cholesky.chol_factor(K_eq.clone()),
        "chol_subst/vec": lambda: cholesky.chol_solve(L, dsc, b),
        "chol_subst/multi": lambda: cholesky.chol_solve(
            L, dsc, torch.cat([b, 2.0 * b], 1)),
        "chol_subst/diag_inv": lambda: cholesky.diag_inverses(L),
    }


def test_cpu_tensors_take_the_plain_path():
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import tbeam

    cp, h, d, lam, v = seeded_state(4)
    _cuda.reset_launch_counts()
    calls = _calls(port_data(), t(d), t(cp), t(h), t(lam), t(v))
    s = tbeam.build_mi(**MI_SMALL, device="cpu")
    calls.update(_mi_calls(s, *_mi_inputs(s, t)))
    calls.update(_vlm_calls(*_vlm_inputs(t)))
    calls.update(_contact_calls("cpu"))
    calls.update(_chol_calls(port_data(), t(d), t(cp), t(h)))
    assert set(calls) == set(_cuda.COUNTERS)
    for fn in calls.values():
        fn()
    assert all(n == 0 for n in _cuda.launch_counts.values())
    assert _cuda._lib is None  # nothing was built or loaded


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrong_inputs_raise(bad):
    from goldfish_tpu_torch.physics import coupling, kl_shell, loads
    from goldfish_tpu_torch.solver import system

    cp, h, d, lam, v = seeded_state(4)
    data = port_data()
    if bad == "dtype":
        dd, err = t(d).float(), TypeError
    else:
        dd, err = t(d)[:, :-1], ValueError
    with pytest.raises(err):
        kl_shell.shell_value_grad(data.stack, dd, t(cp), t(h), data.E,
                                  data.nu)
    with pytest.raises(err):
        coupling.penalty_hessians(data.ifs, dd, t(cp), t(h), data.E)
    with pytest.raises(err):
        loads.pressure_hessians(data.stack, dd, t(cp),
                                _pressure(data.stack, t(d)))
    tables = system.jet_tables(data)
    Hs = system.jet_hessians(data, t(d), t(cp), t(h))
    N = tables.free.numel()
    K = torch.zeros(N, N, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        system.jet_assemble(K if bad == "shape" else K.float(), Hs[0],
                            tables.R_e if bad == "dtype" else tables.R_e[1:],
                            tables.gi_e, tables.free)
    y = torch.zeros(N, dtype=torch.float64)
    with pytest.raises(err):
        system.jet_matvec(y, Hs[0], tables.R_e, tables.gi_e, tables.free,
                          dd.reshape(-1))
    from goldfish_tpu_torch.solver import krylov

    bt = krylov.PairSchwarz(data).blocks
    out = torch.zeros(bt.pa.shape[0], 2 * bt.n, 2 * bt.n, dtype=torch.float64)
    Kp = torch.zeros(bt.free.shape[0], bt.n, bt.n, dtype=torch.float64)
    bad_tables = tables._replace(R_i=tables.R_i[1:])
    with pytest.raises((TypeError, ValueError)):
        krylov.pair_assemble(out.float() if bad == "dtype" else out, Kp,
                             tables if bad == "dtype" else bad_tables, Hs,
                             bt)
    from goldfish_tpu_torch.physics import vlm

    colloc, nhat, A, B, wake, gbar = _vlm_inputs(t)
    with pytest.raises(err):
        vlm.aic_value(colloc.float() if bad == "dtype" else colloc[:-1],
                      nhat, A, B, wake)
    with pytest.raises(err):
        vlm.aic_vjp(colloc, nhat, A, B, wake,
                    gbar.float() if bad == "dtype" else gbar[:, :-1])
    from goldfish_tpu_torch.physics import contact

    s = port_press(num_el=3)
    cp_p, _, d_p, _, _ = press_state(s)
    x, w = contact.contact_qps(s.stack, t(d_p), t(cp_p))
    with pytest.raises(err):
        contact.contact_hvp(s.data.contact, x, w,
                            x.float() if bad == "dtype" else x[:, :-1])


def test_entry_points_default_to_cuda_or_raise(monkeypatch):
    """device=None means the current CUDA device; without CUDA every entry
    point raises and names device="cpu" (no silent CPU fallback)."""
    from goldfish_tpu_torch import config
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.demos import vlm_aeroelastic_wing
    from goldfish_tpu_torch.models import (
        boxwing,
        plate,
        slr,
        tbeam,
        tube,
        wing,
    )
    from goldfish_tpu_torch.opt.problem import OptProblem
    from goldfish_tpu_torch.physics import vlm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.as_device(None)
    assert config.as_device("cpu") == torch.device("cpu")
    for build in (lambda: wing.build(**WING_SMALL),
                  lambda: tbeam.build_mi(**MI_SMALL),
                  lambda: tube.build(num_el=2, pressure=1.0),
                  lambda: plate.build(num_el=2, p=2, num_patches=2),
                  lambda: boxwing.build(n_sections=2, num_el=2, p=2),
                  lambda: OptProblem(),
                  lambda: from_numpy_tree(port_data()),
                  lambda: slr.build(num_el=4),
                  lambda: vlm.build_lattice_param(2, 3, 5, 8),
                  lambda: vlm_aeroelastic_wing.build_coupled(num_el=2, p=2),
                  lambda: vlm_aeroelastic_wing.main(num_el=2, p=2)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Each kernel on CUDA tensors against its plain version on the CPU
    (relative error in norm <= 1e-11: f64 atomics sum in a run-dependent
    order). Needs no JAX, so it also runs where only the port is
    installed (with --noconftest)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.models import tbeam, wing

    s = wing.build(**WING_SMALL, device="cpu")
    cp, h, d, lam, v = seeded_state(4, s)
    dev = torch.device("cuda")
    cpu = s.data
    gpu = from_numpy_tree(cpu, dev)

    def g(a):
        return t(a).to(dev)

    _cuda.reset_launch_counts()
    calls = _calls(gpu, g(d), g(cp), g(h), g(lam), g(v))
    ref = _calls(cpu, t(d), t(cp), t(h), t(lam), t(v))
    s_gpu = tbeam.build_mi(**MI_SMALL, device=dev)
    s_cpu = tbeam.build_mi(**MI_SMALL, device="cpu")
    calls.update(_mi_calls(s_gpu, *_mi_inputs(s_cpu, g)))
    ref.update(_mi_calls(s_cpu, *_mi_inputs(s_cpu, t)))
    calls.update(_vlm_calls(*_vlm_inputs(g)))
    ref.update(_vlm_calls(*_vlm_inputs(t)))
    calls.update(_contact_calls(dev))
    ref.update(_contact_calls("cpu"))
    for name, fn in calls.items():
        a, b = fn(), ref[name]()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            if x is not None:
                assert rel(x.cpu(), y.numpy()) <= 1e-11, name
        assert _cuda.launch_counts[name] >= 1, name


@pytest.mark.gpu
def test_cuda_cull_list_and_run_merged_assembly():
    """K12's cull lists exactly the cell pairs of its plain twin
    `candidate_pairs` on the press at num_el=3 (element cells and the
    default 16-qp cells) and at num_el=8 (where neighbouring elements are
    listed too); K3 on the small wing's interface table, whose groups form
    runs of up to four, matches its plain version (1e-11)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.physics import contact
    from goldfish_tpu_torch.solver import system

    dev = torch.device("cuda")
    _cuda.reset_launch_counts()
    for num_el, drop in ((3, 0.03), (8, 0.05)):
        s = port_press(num_el=num_el, device=dev)
        cp, _, d, _, _ = press_state(s, seed=7, drop=drop)
        x, w = (a.contiguous() for a in contact.contact_qps(
            s.stack, t(d).to(dev), t(cp).to(dev)))
        Q = s.stack.R00.shape[2]
        c = s.data.contact
        cc = contact.ContactPairs(*(a.cpu() for a in c))
        xc, wc = x.cpu(), w.cpu()
        v = torch.randn(x.shape, dtype=torch.float64,
                        generator=torch.Generator().manual_seed(num_el))
        ref_vg = contact._value_grad_plain(cc, xc, wc)
        ref_hvp = contact._hvp_plain(cc, xc, wc, v)
        for q in (Q, None):
            cells = contact.contact_cells(c, x, w, q)
            got = torch.sort(cells.index[:int(cells.count)].long()).values
            ref = contact.candidate_pairs(cc, xc, wc, q)
            assert int(cells.count) == ref.numel() > 0, (num_el, q)
            assert torch.equal(got.cpu(), ref), (num_el, q)
            # the modes on lists longer than one cell's pairs (ncell != q)
            for a, b in zip(contact.contact_value_grad(c, x, w, q=q),
                            ref_vg):
                assert rel(a.cpu(), b.numpy()) <= 1e-11, (num_el, q)
            for a, b in zip(contact.contact_hvp(c, x, w, v.to(dev),
                                                cells=cells), ref_hvp):
                assert rel(a.cpu(), b.numpy()) <= 1e-11, (num_el, q)
    assert _cuda.launch_counts["contact_pairs/cull"] == 8

    s = wing.build(**WING_SMALL, device="cpu")
    cp, h, d, _, _ = seeded_state(4, s)
    tab = system.jet_tables(s.data)
    Hs = system.jet_hessians(s.data, t(d), t(cp), t(h))
    args = (Hs.H_i, tab.R_i, tab.gi_i, tab.free)
    assert int(system.jet_runs(tab.gi_i)[1].max()) > 1
    N = tab.free.numel()
    K0 = torch.zeros(N, N, dtype=torch.float64)
    system._assemble_plain(K0, *args)
    K = torch.zeros(N, N, dtype=torch.float64, device=dev)
    system.jet_assemble(K, *(a.to(dev) for a in args))
    assert rel(K.cpu(), K0.numpy()) <= 1e-11
    assert _cuda.launch_counts["jet_assemble"] == 1
