"""The moving-intersection operations of the OpenMDAO graph on the card:
on CUDA tensors every protocol method runs on the kernels and agrees with
the same operation on CPU tensors (its plain versions), the design tangents
applied forward included: dR/dcp of the CP -> xi operation (K7 mode 4) and
dR/d(cp, h, xi) of the displacement one (K1 mode 4 and K2 mode 3 on K5's
rows, K6 mode 1), each to 1e-10, with every new mode launched.

Needs no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_om_mi_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

SMALL = dict(num_el=3, p=2, n_pts=7)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _pair(device):
    """The CP -> xi and displacement operations on the small T-beam,
    linearized at their own solution of a bent web."""
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.operations import (
        CPIGA2XiImOperation,
        DispMintImOperation,
    )

    s = tbeam.build_mi(**SMALL, device=device)
    xop, dop = CPIGA2XiImOperation(s), DispMintImOperation(s, rtol=1e-11)
    cp = s.cp.clone()
    m = s.metas[1]
    v = torch.linspace(0.0, 1.0, m.n_cp, dtype=cp.dtype, device=cp.device)
    cp[1, : m.n_cp, 0] += 0.05 * torch.sin(np.pi * v)
    cp_f = xop.layout.to_flat(cp).reshape(-1).cpu().numpy()
    h_f = xop.layout.to_flat(s.h_init).reshape(-1).cpu().numpy()
    xi = xop.solve_nonlinear(cp_f)
    xop.linearize(cp_f, xi)
    d = dop.solve_nonlinear(cp_f, h_f, xi)
    dop.linearize(cp_f, h_f, xi, d)
    return xop, dop, xi, d


@pytest.mark.gpu
def test_cuda_mi_operations_match_cpu_and_raise_without_a_forward_mode():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from goldfish_tpu_torch import _cuda

    cpu = _pair("cpu")
    _cuda.reset_launch_counts()
    gpu = _pair(torch.device("cuda"))
    xop, dop, xi, d = gpu
    assert _rel(xi, cpu[2]) <= 1e-12 and _rel(d, cpu[3]) <= 1e-8
    rng = np.random.default_rng(0)
    t_xi, r_xi = rng.normal(size=xi.size), rng.normal(size=xi.size)
    t_d, r_d = rng.normal(size=d.size), rng.normal(size=d.size)
    t_h = rng.normal(size=d.size // 3)
    for got, want in ((xop.apply_linear_fwd(d_xi=t_xi),
                       cpu[0].apply_linear_fwd(d_xi=t_xi)),
                      (dop.apply_linear_fwd(d_d=t_d),
                       cpu[1].apply_linear_fwd(d_d=t_d)),
                      (xop.solve_linear_rev(r_xi),
                       cpu[0].solve_linear_rev(r_xi))):
        assert _rel(got, want) <= 1e-10
    for got, want in zip(xop.apply_linear_rev(r_xi) + dop.apply_linear_rev(r_d),
                         cpu[0].apply_linear_rev(r_xi)
                         + cpu[1].apply_linear_rev(r_d)):
        assert _rel(got, want) <= 1e-10
    assert _rel(dop.solve_linear_rev(r_d), cpu[1].solve_linear_rev(r_d)) \
        <= 1e-8
    t_cp = rng.normal(size=d.size)
    assert _rel(xop.apply_linear_fwd(d_cp=t_cp, d_xi=t_xi),
                cpu[0].apply_linear_fwd(d_cp=t_cp, d_xi=t_xi)) <= 1e-10
    for kw in (dict(d_cp=t_cp), dict(d_h=t_h), dict(d_xi=t_xi),
               dict(d_cp=t_cp, d_h=t_h, d_xi=t_xi, d_d=t_d)):
        assert _rel(dop.apply_linear_fwd(**kw),
                    cpu[1].apply_linear_fwd(**kw)) <= 1e-10, sorted(kw)
    for name in ("c2x_res_jac/res_jac", "c2x_res_jac/adjoint",
                 "c2x_res_jac/step", "jet_matvec", "mi_penalty_xi",
                 "shell_qp/adjoint", "penalty_qp/adjoint", "traced_rows",
                 "shell_qp/design_fwd", "penalty_qp/design_fwd",
                 "mi_penalty_xi/xi_fwd", "c2x_res_jac/cp_fwd"):
        assert _cuda.launch_counts[name] >= 1, name
