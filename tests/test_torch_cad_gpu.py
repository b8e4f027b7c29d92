"""K9's rows mode, the stress field's operation and the trimmed plate's
kernels on the card:

- K9 mode 2 (`vm_stress_rows`) at the small plate (num_el=3, p=2, the
  Newton solution plus seeded noise) against its plain version (1e-12),
  the same bits over 5 launches, and summed against a seeded cotangent
  equal to mode 1's VJP (1e-13 of the summands' magnitude);
- `VMStressExOperation` on CUDA tensors against the same on CPU tensors
  at one state: the field and the dense Jacobians 1e-12, the VJP 1e-11;
- at the hole demo's trimmed plate (num_el=4: runs of 16 sub-cells on one
  dof map) K3 and K4 against their plain versions (1e-11) and K9 modes 0
  (1e-12) and 2 (1e-11: in tension the membrane strain x . x - X . X
  cancels, and the plain rows move by ~2e-12 when cp moves by one ulp;
  ROADMAP C14).

Needs no JAX, so it runs where only the port is installed:

    python -m pytest tests/test_torch_cad_gpu.py -m gpu --noconftest -q

On the CPU every test skips (CUDA kernels have no CPU mode)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _plate_state(device, seed=0):
    from goldfish_tpu_torch.models import plate

    s = plate.build(num_el=3, p=2, num_patches=2, device=device)
    d = s.solve_nonlinear(rtol=1e-12)
    rng = np.random.default_rng(seed)
    noise = torch.tensor(1e-3 * float(d.abs().max())
                         * rng.normal(size=tuple(d.shape)), device=device)
    gbar = torch.tensor(rng.normal(size=tuple(s.stack.wq.shape)),
                        device=device)
    return s, d + noise * s.data.free, gbar


@pytest.mark.gpu
@pytest.mark.parametrize("zeta", [0.5, -0.5])
def test_vm_rows_on_the_card(cuda, zeta):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.physics import kl_shell

    s, d, gbar = _plate_state(cuda)
    args = (s.stack, d, s.cp, s.h_init, s.E, s.nu, zeta)
    n0 = _cuda.launch_counts["vm_stress_qp/rows"]
    outs = [kl_shell.vm_stress_rows(*args) for _ in range(5)]
    assert _cuda.launch_counts["vm_stress_qp/rows"] == n0 + 5
    assert _rel(outs[0], kl_shell._stress_rows_plain(*args)) <= 1e-12
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    P, C = s.cp.shape[:2]
    tot = kl_shell._index_add_nodes(
        s.stack.conn, torch.einsum("peqlc,peq->pelc", outs[0], gbar), P, C)
    mag = kl_shell._index_add_nodes(
        s.stack.conn, torch.einsum("peqlc,peq->pelc", outs[0].abs(),
                                   gbar.abs()), P, C)
    vjp = kl_shell.vm_stress_vjp(*args, gbar)
    for sl, v in zip((slice(0, 3), slice(3, 6), 6), vjp):
        err = torch.linalg.norm(tot[..., sl] - v) / torch.linalg.norm(
            mag[..., sl])
        assert float(err) <= 1e-13


@pytest.mark.gpu
def test_vmstress_op_on_the_card(cuda):
    from goldfish_tpu_torch.operations.exops import VMStressExOperation

    got = []
    _, d_card, _ = _plate_state(cuda)
    for dev in (cuda, "cpu"):
        s, _, _ = _plate_state(dev)
        d = d_card.to(dev)
        op = VMStressExOperation(s)
        lay = op.layout
        flat = (lay.to_flat(s.cp).reshape(-1).cpu().numpy(),
                lay.to_flat(s.h_init).cpu().numpy(),
                lay.to_flat(d).reshape(-1).cpu().numpy())
        ct = np.random.default_rng(4).normal(size=op.out_size)
        got.append((op.compute(*flat), op.jacobians(*flat),
                    op.vjp(*flat, ct)))
    (s_g, J_g, v_g), (s_c, J_c, v_c) = got
    assert _rel(s_g, s_c) <= 1e-12
    assert all(_rel(a, b) <= 1e-12 for a, b in zip(J_g, J_c))
    assert all(_rel(a, b) <= 1e-11 for a, b in zip(v_g, v_c))


@pytest.mark.gpu
def test_trimmed_plate_kernels_on_the_card(cuda):
    from goldfish_tpu_torch.demos.plate_hole_thickness_opt import (
        build_system,
    )
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver import system

    s, _ = build_system(num_el=4, device=cuda)
    rng = np.random.default_rng(3)
    d = torch.tensor(1e-4 * rng.normal(size=tuple(s.cp.shape)),
                     device=cuda) * s.data.free
    v = torch.tensor(rng.normal(size=tuple(s.cp.shape)), device=cuda)
    tables = system.jet_tables(s.data)
    Hs = system.jet_hessians(s.data, d, s.cp, s.h_init)
    starts, lengths = system.jet_runs(tables.gi_e)
    assert int(lengths.max()) == 16   # 4 x 4 sub-cells on one dof map
    N = tables.free.shape[0]
    K, Kp = (torch.zeros(N, N, dtype=torch.float64, device=cuda)
             for _ in range(2))
    system.jet_assemble(K, Hs[0], tables.R_e, tables.gi_e, tables.free)
    system._assemble_plain(Kp, Hs[0], tables.R_e, tables.gi_e, tables.free)
    assert _rel(K, Kp) <= 1e-11
    y, yp = (torch.zeros(N, dtype=torch.float64, device=cuda)
             for _ in range(2))
    system.jet_matvec(y, Hs[0], tables.R_e, tables.gi_e, tables.free,
                      v.reshape(-1))
    system._matvec_plain(yp, Hs[0], tables.R_e, tables.gi_e, tables.free,
                         v.reshape(-1))
    assert _rel(y, yp) <= 1e-11
    args = (s.stack, d, s.cp, s.h_init, s.E, s.nu, 0.5)
    assert _rel(kl_shell.vm_stress_value(*args),
                kl_shell._stress_plain(*args)) <= 1e-12
    assert _rel(kl_shell.vm_stress_rows(*args),
                kl_shell._stress_rows_plain(*args)) <= 1e-11
