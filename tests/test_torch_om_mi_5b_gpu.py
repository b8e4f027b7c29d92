"""The eVTOL moving-seam graph, the multi-block FFD map and the
regularized objective on the card: on CUDA tensors the eVTOL demo's graph
(num_el=3, p=2, h_th=0.02) runs on the kernels and its w_int, xi and totals
agree with the same graph on CPU tensors (the plain versions), and
`MultiShapeFFD` and `IntEnergyReguExOperation` (W_int through K1) agree
with their CPU values.

Needs no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_om_mi_5b_gpu.py -m gpu --noconftest -q
"""

import numpy as np
import pytest
import torch

W = "int_energy_comp.w_int"
X = "inputs_comp.spar_rib_design"
XI = "cpiga2xi_comp.int_para_coords"


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / np.linalg.norm(np.asarray(b)))


def _evtol(device):
    from goldfish_tpu_torch.demos.evtol_wing_shopt_mi import build_problem

    prob, _ = build_problem(num_el=3, p=2, maxiter=2, h_th=0.02,
                            device=device)
    prob.run_model()
    tot = prob.compute_totals([W], [X])[(W, X)].ravel()
    return float(prob[W][0]), np.asarray(prob[XI]).ravel(), tot


@pytest.mark.gpu
def test_cuda_evtol_graph_ffd_and_regu_match_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.design.pipeline import MultiShapeFFD
    from goldfish_tpu_torch.models import plate, tbeam
    from goldfish_tpu_torch.operations import IntEnergyReguExOperation

    cpu = _evtol("cpu")
    _cuda.reset_launch_counts()
    gpu = _evtol(torch.device("cuda"))
    assert abs(gpu[0] - cpu[0]) <= 1e-10 * abs(cpu[0])
    assert np.linalg.norm(gpu[1] - cpu[1]) <= 1e-12
    assert _rel(gpu[2], cpu[2]) <= 1e-8
    for name in ("c2x_res_jac/res_jac", "c2x_res_jac/adjoint",
                 "c2x_res_jac/step", "jet_matvec", "mi_penalty_xi",
                 "shell_qp/adjoint", "penalty_qp/adjoint", "traced_rows"):
        assert _cuda.launch_counts[name] >= 1, name

    groups = [dict(patches=[0, 1], num_els=(2, 1, 1), p=(2, 1, 1)),
              dict(patches=[2, 3], num_els=(2, 1, 1), p=(2, 1, 1))]
    out = []
    for dev in ("cpu", torch.device("cuda")):
        s = plate.build(num_el=3, p=2, num_patches=4, device=dev)
        sh = MultiShapeFFD(s, groups, opt_fields=(0, 2))
        x = torch.tensor(sh.init_p_ffd() + 0.01 * np.random.default_rng(
            0).normal(size=sh.n_design), device=s.cp.device)
        out.append(sh(x).cpu().numpy())
    assert np.abs(out[0] - out[1]).max() <= 1e-14

    vals = []
    for dev in ("cpu", torch.device("cuda")):
        s = tbeam.build(num_el=3, p=2, device=dev)
        op = IntEnergyReguExOperation(s, regu_para=1e3)
        cp = op.layout.to_flat(s.cp).cpu().numpy().copy()
        cp[:, 2] += 1e-3 * np.sin(np.linspace(0, 9, cp.shape[0]))
        h = op.layout.to_flat(s.h_init).reshape(-1).cpu().numpy()
        d = 1e-4 * np.cos(np.linspace(0, 5, cp.size)) \
            * op.layout.to_flat(s.data.free).reshape(-1).cpu().numpy()
        vals.append((op.compute(cp.ravel(), h, d),
                     op.gradients(cp.ravel(), h, d)))
    assert abs(vals[1][0] - vals[0][0]) <= 1e-11 * abs(vals[0][0])
    for g, c in zip(vals[1][1], vals[0][1]):
        assert _rel(g, c) <= 1e-10
