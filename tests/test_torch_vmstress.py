"""The von Mises stress FIELD operation and component of the port against
the JAX package on the small plate (PLATE_SMALL, the solved state plus
seeded noise):

- `VMStressExOperation.compute` (K9 mode 0's plain version at the qps of
  positive weight, in the reference's order) to 1e-12, `jacobians` (the
  dense dS/d(cp, h, d) from mode 2's plain rows, scattered into the flat
  real-dof columns) to 1e-10 against `jax.jacrev`, and `vjp` (mode 1's
  plain version) to 1e-12, all relative in norm;
- mode 2's plain rows, summed against a seeded cotangent over the qps and
  scattered through conn, equal mode 1's plain VJP to 1e-13;
- `VMStressComp` in an OM graph: the field and `check_partials(step=1e-9)`
  under the bar of tests/test_om_adapters.py::test_vmstress_comp (rel <
  5e-4);
- on a void qp (weight 0) the operation drops the row, as the reference.

CPU runs launch no kernel."""

import numpy as np
import pytest
import torch

from _torch_port_common import jax_plate, plate_state, port_plate, rel, t


@pytest.fixture(scope="module")
def ops():
    from goldfish_tpu.operations.exops import VMStressExOperation as JOp

    from goldfish_tpu_torch.operations.exops import VMStressExOperation

    cp, h, _, dn, _ = plate_state()
    port = VMStressExOperation(port_plate())
    lay = port.layout
    flat = (lay.to_flat(t(cp)).reshape(-1).numpy(),
            lay.to_flat(t(h)).numpy(),
            lay.to_flat(t(dn)).reshape(-1).numpy())
    return port, JOp(jax_plate()), flat


def test_vmstress_op_matches_jax(ops):
    from goldfish_tpu_torch import _cuda

    port, jop, (cpf, hf, df) = ops
    _cuda.reset_launch_counts()
    s = port.compute(cpf, hf, df)
    assert port.out_size == jop.out_size == s.size
    assert rel(s, jop.compute(cpf, hf, df)) <= 1e-12
    for a, b in zip(port.jacobians(cpf, hf, df), jop.jacobians(cpf, hf, df)):
        assert a.shape == b.shape
        assert rel(a, b) <= 1e-10
    ct = np.random.default_rng(4).normal(size=s.size)
    for a, b in zip(port.vjp(cpf, hf, df, ct), jop.vjp(cpf, hf, df, ct)):
        assert rel(a, b) <= 1e-12
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_rows_sum_to_the_vjp():
    from goldfish_tpu_torch.physics import kl_shell

    cp, h, _, dn, gbar = plate_state()
    s = port_plate()
    P, C = s.cp.shape[:2]
    for zeta in (0.5, -0.5):
        args = (s.stack, t(dn), t(cp), t(h), s.E, s.nu, zeta)
        rows = kl_shell.vm_stress_rows(*args)
        assert rows.shape == s.stack.R00.shape + (7,)
        contrib = torch.einsum("peqlc,peq->pelc", rows, t(gbar))
        tot = kl_shell._index_add_nodes(s.stack.conn, contrib, P, C)
        dd, dcp, dh = kl_shell.vm_stress_vjp(*args, t(gbar))
        assert rel(tot[..., 0:3], dd.numpy()) <= 1e-13
        assert rel(tot[..., 3:6], dcp.numpy()) <= 1e-13
        assert rel(tot[..., 6], dh.numpy()) <= 1e-13


def test_void_qps_are_dropped(ops):
    from goldfish_tpu_torch.operations.exops import VMStressExOperation

    s = port_plate()
    wq = s.stack.wq.clone()
    wq[0, 0, :2] = 0.0   # two void qps of a real element
    s.stack = s.stack._replace(wq=wq)
    op = VMStressExOperation(s)
    full, _, (cpf, hf, df) = ops
    assert op.out_size == full.out_size - 2
    keep = np.ones(full.out_size, dtype=bool)
    keep[:2] = False
    assert np.array_equal(op.compute(cpf, hf, df),
                          full.compute(cpf, hf, df)[keep])
    Ja, Jb = op.jacobians(cpf, hf, df), full.jacobians(cpf, hf, df)
    assert all(np.array_equal(a, b[keep]) for a, b in zip(Ja, Jb))


def test_vmstress_comp_partials():
    from goldfish_tpu_torch.om_comps.components import VMStressComp, om

    s = port_plate()
    cp, h, d, _, _ = plate_state()
    comp = VMStressComp(nonmatching_sys=s)
    comp.init_parameters()
    lay = comp.op.layout
    model = om.Group()
    model.add_subsystem("vm", comp)
    p2 = om.Problem(model=model)
    p2.setup()
    p2["vm.displacements"] = lay.to_flat(t(d)).reshape(-1).numpy()
    p2["vm.thickness_IGA"] = lay.to_flat(t(h)).numpy()
    p2.run_model()
    sig = np.asarray(p2["vm.von_mises_stress"])
    assert sig.size == comp.op.out_size and np.all(np.isfinite(sig))
    assert sig.max() > 0
    report = p2.check_partials(step=1e-9)
    n = 0
    for comp_name, pairs in report.items():
        for key, entry in pairs.items():
            denom = np.linalg.norm(entry["J_fd"])
            if denom < 1e-6 * np.abs(entry["J_fwd"]).max():
                continue
            n += 1
            assert entry["rel error"] < 5e-4, (comp_name, key,
                                               entry["rel error"])
    assert n == 3
