"""Real multi-process patch sharding on the CPU: gloo groups of 2 and 3
ranks (tests/_torch_distributed_worker.py, one FileStore a group, the
decision guard on: GOLDFISH_SHARD_CHECK=1) and one rank in this process,
against the unsharded port in this process and the JAX package's numbers
(tests/data/torch_port_sharding_reference.json,
scripts/torch_port_sharding_reference.py):

- 2 ranks, the 4-patch wing through `build_solve_fn_dataarg` (the port of
  tests/test_multichip.py's two-process gradient parity): every rank holds
  the same bits; J within 1e-9 and dJ/dh_ffd within 1e-6 of the unsharded
  port, J within 1e-8 and dJ within 1e-6 of the JAX package;
- 3 ranks, a split that does not divide P = 4 (padded to 6): the same;
- 2 ranks, TBEAM_STOP_SMALL (moving seam, contact, areal field load, 3
  patches padded to 4): J within 1e-9, dJ/d(amp) and dJ/dh within 1e-6;
- 2 ranks, the small tube under a follower pressure, edge loads, a point
  load on rank 1's patch, a dead and a field load (the terms rank 0 alone
  evaluates, and the loads that follow the patches): Pi, r, K, K v, the
  residual's VJP, JVP and field VJP within 1e-12 of the unsharded port,
  J within 1e-9, dJ/dcp and dJ/dh within 1e-6;
- the double-count guard: dJ at 2 ranks within 1e-6 of dJ at 1 rank;
- `entry.dryrun_multichip(2, device="cpu")`'s wing and MI legs against the
  JAX package (1e-8 / 1e-6; the dry run's own bars, J 1e-9 and dJ 1e-6,
  gate sharded against unsharded); its box-wing leg runs in chip_smoke.py;
- a rank whose peer never comes fails within its group's timeout.

Every spawned rank is bounded by a subprocess timeout and the test fails
loudly on it.
"""

import concurrent.futures
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from _torch_port_common import rel

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
WORKER = os.path.join(HERE, "_torch_distributed_worker.py")
REF = os.path.join(HERE, "data", "torch_port_sharding_reference.json")
TIMEOUT_S = 120
GROUPS = {2: ("wing_small", "tbeam_stop", "tube_loads"), 3: ("wing_small",)}


@pytest.fixture(scope="module")
def ref():
    with open(REF) as f:
        return json.load(f)


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MASTER_", "GOLDFISH_", "WORLD_SIZE",
                                "RANK"))}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    env["GOLDFISH_SHARD_CHECK"] = "1"
    return env


def _spawn(tmp, world, args):
    out = os.path.join(tmp, f"w{world}")
    procs = []
    for r in range(world):
        log = open(os.path.join(tmp, f"w{world}.r{r}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, WORKER, os.path.join(tmp, f"store{world}"),
             str(r), str(world), out, *args], env=_env(), cwd=tmp,
            stdout=log, stderr=subprocess.STDOUT), log))
    return out, procs


def _finish(procs, timeout=TIMEOUT_S):
    """Wait for each rank; kill and fail loudly on a timeout or error."""
    for p, log in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
                q.wait()
        log.close()
    for p, log in procs:
        if p.returncode != 0:
            with open(log.name) as fh:
                pytest.fail(f"rank rc={p.returncode}\n{fh.read()[-4000:]}")


def _one_rank(tmp, task):
    """The leg sharded over a one-rank gloo group in this process."""
    import datetime

    import torch.distributed as dist

    from goldfish_tpu_torch.parallel.legs import run_leg
    from goldfish_tpu_torch.parallel.sharding import make_mesh

    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store1"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        return run_leg(task, 1, make_mesh(device="cpu"), "cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group started at once; the dry run, the one-rank leg and the
    unsharded port run here while they work."""
    from _torch_distributed_worker import tbeam_stop, tube_loads

    from goldfish_tpu_torch.entry import dryrun_multichip
    from goldfish_tpu_torch.parallel.legs import run_leg

    tmp = str(tmp_path_factory.mktemp("groups"))
    started = {w: _spawn(tmp, w, tasks) for w, tasks in GROUPS.items()}
    with pytest.MonkeyPatch.context() as mp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        mp.setenv("GOLDFISH_SHARD_CHECK", "1")
        # the dry run waits on its own ranks most of its time: it runs in a
        # thread beside the unsharded work below
        dry = pool.submit(dryrun_multichip, 2, device="cpu",
                          legs=("wing", "mi"), timeout_s=TIMEOUT_S)
        one = _one_rank(tmp, "wing_small")
        whole = {("wing_small", w): run_leg("wing_small", w, None, "cpu")
                 for w in (2, 3)}
        whole["tbeam_stop"] = tbeam_stop(2, None)
        whole["tube_loads"] = tube_loads(2, None)
        dry = dry.result()
    got = {}
    for w, (out, procs) in started.items():
        _finish(procs)
        got[w] = [dict(np.load(f"{out}.rank{r}.npz")) for r in range(w)]
    return got, whole, one, dry


def _same_on_ranks(ranks, *keys):
    for k in keys:
        for r in ranks[1:]:
            assert np.array_equal(r[k], ranks[0][k]), k


def _wing_parity(runs, ref, world):
    got, whole, _, _ = runs
    ranks = got[world]
    _same_on_ranks(ranks, "wing_small.J", "wing_small.g")
    J, g = float(ranks[0]["wing_small.J"]), ranks[0]["wing_small.g"]
    u = whole[("wing_small", world)]
    assert abs(J - float(u["J"])) <= 1e-9 * abs(float(u["J"]))
    assert rel(g, u["g"]) <= 1e-6
    j = ref["wing_small"]
    assert abs(J - j["J"]) <= 1e-8 * abs(j["J"])
    assert rel(g, j["dJ"]) <= 1e-6


def test_two_rank_gradient_parity(runs, ref):
    _wing_parity(runs, ref, 2)


def test_padded_split_three_ranks(runs, ref):
    """P = 4 over 3 ranks: padded to 6, two phantom patches on rank 2."""
    _wing_parity(runs, ref, 3)


def test_mi_contact_field_load_two_ranks(runs):
    got, whole, _, _ = runs
    ranks = got[2]
    keys = ("tbeam_stop.J", "tbeam_stop.da", "tbeam_stop.dh", "tbeam_stop.d")
    _same_on_ranks(ranks, *keys)
    J, da, dh, d = (ranks[0][k] for k in keys)
    J_u, da_u, dh_u, d_u, _ = whole["tbeam_stop"]
    # rank 0 alone holds the contact patches' copy (2 of the 3 patches)
    assert int(ranks[0]["tbeam_stop.contact_bytes"]) > 0
    assert int(ranks[1]["tbeam_stop.contact_bytes"]) == 0
    assert abs(float(J) - J_u) <= 1e-9 * abs(J_u)
    assert abs(float(da) - da_u) <= 1e-6 * abs(da_u)
    assert rel(dh, dh_u) <= 1e-6
    assert rel(d, d_u) <= 1e-9


def test_rank0_loads_two_ranks(runs):
    """Pressure, edge, point, dead and field loads at 2 ranks against the
    unsharded port: the rank-0 terms (point and edge loads) and the loads
    that follow the patches, in every operator and the gradient."""
    got, whole, _, _ = runs
    ranks = got[2]
    u = whole["tube_loads"]
    ops = ("r", "K", "Kv", "vjp_cp", "vjp_h", "jvp", "vjpf_cp", "vjpf_h",
           "vjpf_f")
    _same_on_ranks(ranks, *(f"tube_loads.{k}" for k in ops + (
        "Pi", "J", "dJ_cp", "dJ_h", "d")))
    g = {k: ranks[0][f"tube_loads.{k}"] for k in u}
    assert abs(float(g["Pi"]) - float(u["Pi"])) <= 1e-12 * abs(float(u["Pi"]))
    for k in ops:
        assert rel(g[k], u[k]) <= 1e-12, k
    assert abs(float(g["J"]) - float(u["J"])) <= 1e-9 * abs(float(u["J"]))
    assert rel(g["dJ_cp"], u["dJ_cp"]) <= 1e-6
    assert rel(g["dJ_h"], u["dJ_h"]) <= 1e-6
    assert rel(g["d"], u["d"]) <= 1e-9


def test_no_double_count(runs):
    """dJ is summed once: 2 ranks against 1 (a double count reads ~1)."""
    got, _, one, _ = runs
    assert rel(got[2][0]["wing_small.g"], one["g"]) <= 1e-6


def test_dryrun_multichip_legs_match_jax(runs, ref):
    res = runs[3]
    for name in ("wing", "mi"):
        j = ref["legs"][name]
        r = res[name]
        assert r["rel_J"] < 1e-9 and r["rel_g"] < 1e-6
        assert abs(r["J"] - j["J"]) <= 1e-8 * abs(j["J"])
        assert rel(r["g"], np.reshape(j["dJ"], r["g"].shape)) <= 1e-6
        for c in r["counts"]:
            assert c["shell_qp/value_grad"] == 0   # CPU: no kernel launch


def test_lone_rank_times_out(tmp_path):
    """A rank whose peer never joins fails within its group's timeout
    instead of hanging."""
    out, procs = _spawn(str(tmp_path), 2, ("--timeout", "1", "wing_small"))
    procs[1][0].kill()
    procs[1][0].wait()
    p, log = procs[0]
    try:
        p.wait(timeout=60)
    except subprocess.TimeoutExpired:
        p.kill()
        pytest.fail("a lone rank outlived its group's timeout")
    finally:
        for _, lg in procs:
            lg.close()
    assert p.returncode != 0
