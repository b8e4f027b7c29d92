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
    rel,
    seeded_state,
    t,
)


def _mi_calls(s, d, cp, h, lam):
    """The moving-intersection kernels' wrappers on system s (K1's
    geometry gradient, K5-K7)."""
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
        "penalty_qp/value_grad": lambda: coupling.penalty_value_grad(
            ifs, d, cp, h, data.E),
        "penalty_qp/hess": lambda: coupling.penalty_hessians(
            ifs, d, cp, h, data.E),
        "penalty_qp/adjoint": lambda: coupling.penalty_adjoint(
            ifs, d, cp, h, data.E, lam),
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
    }


def test_cpu_tensors_take_the_plain_path():
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.models import tbeam

    cp, h, d, lam, v = seeded_state(4)
    _cuda.reset_launch_counts()
    calls = _calls(port_data(), t(d), t(cp), t(h), t(lam), t(v))
    s = tbeam.build_mi(**MI_SMALL, device="cpu")
    calls.update(_mi_calls(s, *_mi_inputs(s, t)))
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


def test_entry_points_default_to_cuda_or_raise(monkeypatch):
    """device=None means the current CUDA device; without CUDA every entry
    point raises and names device="cpu" (no silent CPU fallback)."""
    from goldfish_tpu_torch import config
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.models import plate, tbeam, tube, wing
    from goldfish_tpu_torch.opt.problem import OptProblem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        config.as_device(None)
    assert config.as_device("cpu") == torch.device("cpu")
    for build in (lambda: wing.build(**WING_SMALL),
                  lambda: tbeam.build_mi(**MI_SMALL),
                  lambda: tube.build(num_el=2, pressure=1.0),
                  lambda: plate.build(num_el=2, p=2, num_patches=2),
                  lambda: OptProblem(),
                  lambda: from_numpy_tree(port_data())):
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
    for name, fn in calls.items():
        a, b = fn(), ref[name]()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            if x is not None:
                assert rel(x.cpu(), y.numpy()) <= 1e-11, name
        assert _cuda.launch_counts[name] >= 1, name
