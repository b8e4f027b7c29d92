"""The port's patch sharding (goldfish_tpu_torch/parallel/sharding.py), the
counterpart of tests/test_sharding.py at its size: the 4-patch wing
`wing.build(n_chord=2, n_span=2, num_el=2, p=2)`.

- padding: Pi and r of the system padded to 8 patches against the JAX
  package's unpadded Pi and r (tests/data/torch_port_sharding_reference.json,
  scripts/torch_port_sharding_reference.py) at d = 0 (Pi within 1e-12,
  r within 1e-12 absolute) and at a seeded state (1e-12 relative); the
  phantom rows exactly 0; K keeps a unit diagonal on the phantom dofs;
- `padded_patch_count` at the reference's five cases;
- `maybe_init_distributed`'s guard with `init_process_group` patched out;
- `system_shardings`' placements and `shard_system`'s blocks;
- the sharded operators and solve at world size 1 (a gloo group of one
  process on a FileStore, the decision guard on) against the unsharded
  port: Pi, r, K, K v, the residual's VJP and JVP, and the Newton solve d
  within 1e-9 max|d| (the reference's bar), J and dJ/dh_ffd;
- a sharded operator without a process group raises.
"""

import datetime
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_port_common import rel, t

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_sharding_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)["wing_small"]


@pytest.fixture(scope="module")
def small_wing():
    from goldfish_tpu_torch.models import wing

    return wing.build(n_chord=2, n_span=2, num_el=2, p=2, device="cpu")


def seeded_d(free, seed=21):
    """scripts/torch_port_sharding_reference.py's seeded state."""
    rng = np.random.default_rng(seed)
    free = np.asarray(free)
    return t(1e-3 * rng.standard_normal(free.shape) * free)


def padded(s, P_new, d):
    from goldfish_tpu_torch.parallel.sharding import pad_state, pad_system

    return (pad_system(s.data, P_new), pad_state(s.cp, P_new, "repeat"),
            pad_state(s.h_init, P_new, "repeat"),
            pad_state(d, P_new, "zero"))


@pytest.fixture
def group(tmp_path, monkeypatch):
    """A gloo group of one process on a FileStore, destroyed after the
    test, with the decision guard on (GOLDFISH_SHARD_CHECK=1)."""
    monkeypatch.setenv("GOLDFISH_SHARD_CHECK", "1")
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield
    dist.destroy_process_group()


def test_padded_system_equivalence(small_wing, ref):
    from goldfish_tpu_torch.solver.system import assemble_K, \
        potential_and_residual

    s = small_wing
    P = s.num_splines
    assert list(s.cp.shape) == ref["shape"]
    for d, Pi_ref, r_ref in ((s.zero_displacement(), ref["Pi0"], ref["r0"]),
                             (seeded_d(s.data.free), ref["Pi"], ref["r"])):
        data8, cp8, h8, d8 = padded(s, 8, d)
        Pi8, r8 = potential_and_residual(data8, d8, cp8, h8)
        r_ref = np.reshape(r_ref, ref["shape"])
        assert abs(float(Pi8) - Pi_ref) <= 1e-12 * max(abs(Pi_ref), 1.0)
        if not d.any():
            assert np.abs(r8[:P].numpy() - r_ref).max() <= 1e-12
        assert rel(r8[:P], r_ref) <= 1e-12
        assert np.abs(r8[P:].numpy()).max() == 0.0
    K = assemble_K(data8, d8, cp8, h8)
    n = P * s.stack.max_cp * 3
    ph = K[n:, :]
    assert torch.equal(ph[:, n:], torch.eye(K.shape[0] - n,
                                            dtype=K.dtype))
    assert float(ph[:, :n].abs().max()) == 0.0


def test_padded_patch_count():
    from goldfish_tpu_torch.parallel.sharding import padded_patch_count

    assert padded_patch_count(91, 8) == 96
    assert padded_patch_count(91, 32) == 96
    assert padded_patch_count(20, 8) == 24
    assert padded_patch_count(8, 8) == 8
    assert padded_patch_count(1, 8) == 8


def test_maybe_init_distributed_guarded(monkeypatch):
    """No-op when unconfigured or single-process; otherwise one
    init_process_group with the cluster spec (the call is patched out:
    only the guard and its plumbing are pinned here, the real groups run
    in tests/test_torch_multichip.py)."""
    from goldfish_tpu_torch.parallel import sharding

    calls = []

    def fake_init(backend, init_method, world_size, rank, timeout):
        calls.append((backend, init_method, world_size, rank,
                      timeout.total_seconds()))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(sharding, "_initialized", False)
    init = sharding.maybe_init_distributed

    assert init(env={}) is False
    assert init(env={"GOLDFISH_COORDINATOR": "h0:1234",
                     "GOLDFISH_NUM_PROCESSES": "1"}) is False
    assert calls == []
    spec = {"GOLDFISH_COORDINATOR": "h0:1234",
            "GOLDFISH_NUM_PROCESSES": "4", "GOLDFISH_PROCESS_ID": "2"}
    assert init(env=spec) is True
    assert calls == [("gloo", "tcp://h0:1234", 4, 2,
                      sharding.DEFAULT_TIMEOUT_S)]
    # idempotent: a second configured call does not initialize again
    assert init(env=spec) is True
    assert len(calls) == 1
    # torch's spellings work too; explicit arguments win
    monkeypatch.setattr(sharding, "_initialized", False)
    assert init(process_id=3, timeout_s=7.0,
                env={"MASTER_ADDR": "h1", "MASTER_PORT": "99",
                     "WORLD_SIZE": "8", "RANK": "0"}) is True
    assert calls[-1] == ("gloo", "tcp://h1:99", 8, 3, 7.0)
    monkeypatch.setattr(sharding, "_initialized", False)
    assert init(coordinator="file:///tmp/x", num_processes=2,
                process_id=1, env={}) is True
    assert calls[-1][1:4] == ("file:///tmp/x", 2, 1)


def test_system_shardings_and_blocks(small_wing, group):
    from goldfish_tpu_torch.parallel.sharding import (
        PatchMesh,
        make_mesh,
        shard_system,
        split_block,
        system_shardings,
    )

    s = small_wing
    data8, *_ = padded(s, 8, s.zero_displacement())
    place = system_shardings(data8)
    assert {k for k, v in place.items() if v == "patch"} == {
        f"stack.{f}" for f in data8.stack._fields}
    assert {k for k, v in place.items() if v == "interface"} == {
        f"ifs.{f}" for f in data8.ifs._fields}
    for k in ("free", "E", "nu", "f_areal"):
        assert place[k] == "replicated"
    assert [split_block(5, r, 3) for r in range(3)] == [(0, 1), (1, 3),
                                                       (3, 5)]
    I = data8.ifs.n_interfaces
    for r in range(4):
        # rank r of 4 (a mesh built by hand: only the split is read)
        m = PatchMesh(group=None, rank=r, world_size=4,
                      device=torch.device("cpu"))
        sh = shard_system(data8, m)
        assert (sh.shard.lo, sh.shard.hi) == (2 * r, 2 * r + 2)
        assert sh.stack.R00.shape[0] == 2
        assert torch.equal(sh.stack.R00, data8.stack.R00[2 * r:2 * r + 2])
        a, b = split_block(I, r, 4)
        assert (sh.shard.if_lo, sh.shard.if_hi) == (a, b)
        assert torch.equal(sh.ifs.pairA, data8.ifs.pairA[a:b])
        assert sh.free is data8.free
    with pytest.raises(ValueError):
        shard_system(padded(s, 6, s.zero_displacement())[0],
                     PatchMesh(None, 0, 4, torch.device("cpu")))
    mesh = make_mesh(device="cpu")
    assert mesh.world_size == 1 and mesh.check


def test_sharded_operators_match_unsharded(small_wing, group):
    from goldfish_tpu_torch.parallel.sharding import make_mesh, shard_system
    from goldfish_tpu_torch.solver import system as sy

    s = small_wing
    d = seeded_d(s.data.free)
    data8, cp8, h8, d8 = padded(s, 8, d)
    ds = shard_system(data8, make_mesh(device="cpu"))
    Pi, r = sy.potential_and_residual(data8, d8, cp8, h8)
    Pis, rs = sy.potential_and_residual(ds, d8, cp8, h8)
    assert abs(float(Pis - Pi)) <= 1e-12 * abs(float(Pi))
    assert rel(rs, r) <= 1e-13
    assert rel(sy.assemble_K(ds, d8, cp8, h8),
               sy.assemble_K(data8, d8, cp8, h8)) <= 1e-14
    rng = np.random.default_rng(3)
    v = t(rng.standard_normal(d8.shape))
    assert rel(sy.tangent_matvec(ds, d8, cp8, h8, v),
               sy.tangent_matvec(data8, d8, cp8, h8, v)) <= 1e-13
    for a, b in zip(sy.residual_vjp(ds, d8, cp8, h8, v),
                    sy.residual_vjp(data8, d8, cp8, h8, v)):
        assert rel(a, b) <= 1e-13
    th = t(rng.standard_normal(h8.shape))
    assert rel(sy.residual_jvp(ds, d8, cp8, h8, v, th),
               sy.residual_jvp(data8, d8, cp8, h8, v, th)) <= 1e-13


def test_sharded_solve_matches_unsharded(small_wing, group):
    """The reference's bar: d within 1e-9 max|d| (reads ~1e-14 here)."""
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.parallel.legs import thickness_eval
    from goldfish_tpu_torch.parallel.sharding import make_mesh, shard_system
    from goldfish_tpu_torch.solver.implicit import build_solve_fn_dataarg

    s = small_wing
    P = s.num_splines
    data8, cp8, h8, d08 = padded(s, 8, s.zero_displacement())
    mesh = make_mesh(device="cpu")
    solve = build_solve_fn_dataarg(rtol=1e-10)
    d_ref = solve(data8, cp8, h8, d08)
    d_sh = solve(shard_system(data8, mesh), cp8, h8, d08)
    err = float((d_sh[:P] - d_ref[:P]).abs().max())
    scale = float(d_ref.abs().max())
    assert err < 1e-9 * scale, (err, scale)
    assert float(d_sh[P:].abs().max()) == 0.0

    th = ThicknessFFD(s, num_els=(2, 1, 1), p=(2, 1, 1))
    h0 = torch.tensor(th.init_h_ffd(wing.H_TH), dtype=torch.float64)
    J_u, g_u, _, _ = thickness_eval(s, 2, None, th, h0, 1e-8, 12)
    J_s, g_s, _, _ = thickness_eval(s, 2, mesh, th, h0, 1e-8, 12)
    assert abs(float(J_s - J_u)) <= 1e-9 * abs(float(J_u))
    assert rel(g_s, g_u) <= 1e-6


def test_sharded_operator_without_group_raises(small_wing):
    from goldfish_tpu_torch.parallel.sharding import PatchMesh, shard_system
    from goldfish_tpu_torch.solver.system import potential_and_residual

    s = small_wing
    data8, cp8, h8, d8 = padded(s, 8, s.zero_displacement())
    assert not dist.is_initialized()
    ds = shard_system(data8, PatchMesh(None, 0, 2, torch.device("cpu")))
    with pytest.raises(RuntimeError, match="process group"):
        potential_and_residual(ds, d8, cp8, h8)
