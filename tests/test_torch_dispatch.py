"""Kernel dispatch rules of the port: a CPU tensor takes the plain PyTorch
version (no kernel launch counted); wrong dtype or shape raises on every
path; a CUDA tensor launches the kernel (checked only where a GPU is)."""

import pytest
import torch

from _torch_port_common import WING_SMALL, port_data, rel, seeded_state, t


def _calls(data, d, cp, h, lam, v):
    from goldfish_tpu_torch.physics import coupling, kl_shell
    from goldfish_tpu_torch.solver import system

    st, ifs = data.stack, data.ifs
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
    }


def test_cpu_tensors_take_the_plain_path():
    from goldfish_tpu_torch import _cuda

    cp, h, d, lam, v = seeded_state(4)
    _cuda.reset_launch_counts()
    calls = _calls(port_data(), t(d), t(cp), t(h), t(lam), t(v))
    assert set(calls) == set(_cuda.COUNTERS)
    for fn in calls.values():
        fn()
    assert all(n == 0 for n in _cuda.launch_counts.values())
    assert _cuda._lib is None  # nothing was built or loaded


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrong_inputs_raise(bad):
    from goldfish_tpu_torch.physics import coupling, kl_shell
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
    from goldfish_tpu_torch.models import wing

    s = wing.build(**WING_SMALL)
    cp, h, d, lam, v = seeded_state(4, s)
    dev = torch.device("cuda")
    cpu = s.data
    gpu = from_numpy_tree(cpu, dev)

    def g(a):
        return t(a).to(dev)

    _cuda.reset_launch_counts()
    calls = _calls(gpu, g(d), g(cp), g(h), g(lam), g(v))
    ref = _calls(cpu, t(d), t(cp), t(h), t(lam), t(v))
    for name, fn in calls.items():
        a, b = fn(), ref[name]()
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            assert rel(x.cpu(), y.numpy()) <= 1e-11, name
        assert _cuda.launch_counts[name] >= 1, name
