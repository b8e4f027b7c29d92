"""Rank worker of the port's multi-process tests (tests/test_torch_multichip.py).

Run as:  python tests/_torch_distributed_worker.py STORE RANK WORLD OUT
             [--timeout S] TASK...

Each process joins one gloo group of WORLD ranks on a FileStore at STORE
(no TCP port, so parallel test workers never race for one), runs the tasks
patch-sharded on the CPU and writes OUT.rank{RANK}.npz. The test starts
it with GOLDFISH_SHARD_CHECK=1, the decision guard: every host decision of
the solves must read the same bits on all ranks. The tasks:

  wing_small  `parallel.legs`' leg: the 4-patch wing, J = W_int and
              dJ/dh_ffd through `build_solve_fn_dataarg`
  tbeam_stop  the T-beam pressed into the stop plate (TBEAM_STOP_SMALL:
              moving seam, contact, areal field load): four load levels
              from d = 0, then J = W_int, dJ/d(amp) and dJ/dh through the
              CP -> xi and MI displacement solves from the third level
  tube_loads  the small tube under every kind of load the split divides
              or leaves to rank 0: follower pressure, the tip force as
              edge loads, a point load on patch 3, a dead areal load and a
              seeded areal field load; Pi, r, K, K v, the residual's VJP,
              JVP and field VJP at a seeded state, then J = W_int, dJ/dcp
              and dJ/dh through `build_solve_fn_dataarg`

`tbeam_stop` and `tube_loads` are also what the parent runs unsharded
(`mesh=None`).
The port's imports only: no JAX here.
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from _torch_port_common import TBEAM_STOP_SMALL, mi_bend, \
    port_tbeam_stop  # noqa: E402

TIMEOUT_S = 90.0


def tbeam_stop(n_ranks, mesh=None):
    """(J, dJ/d(amp), dJ/dh (P, C), d (P, C, 3), the bytes of the contact
    copy) of TBEAM_STOP_SMALL padded for n_ranks, sharded over `mesh` when
    given."""
    from goldfish_tpu_torch.parallel.sharding import (
        pad_state,
        pad_system,
        padded_patch_count,
        shard_system,
    )
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.system import scale_loads
    from goldfish_tpu_torch.solver.system_mi import (
        PersistentDeviceFactorMI,
        build_solve_fn_mi,
        newton_solve_mi_host,
    )

    s = port_tbeam_stop(**TBEAM_STOP_SMALL)
    P = s.num_splines
    P_pad = padded_patch_count(P, n_ranks)
    data = pad_system(s.data, P_pad)
    if mesh is not None:
        data = shard_system(data, mesh)
    args = (s.mi, s.co, s.ss, s.pdeg, s.qdeg)
    bend = torch.from_numpy(mi_bend(s))
    n1 = s.metas[1].n_cp

    def cp_of(a):
        cp = s.cp.clone()
        cp[1, :n1, 0] = cp[1, :n1, 0] + a * bend
        return cp

    cp = cp_of(0.05)
    xi = s.c2x.solve(cp).detach()
    cp_p = pad_state(cp, P_pad)
    h_p = pad_state(s.h_init, P_pad)
    fac = PersistentDeviceFactorMI(data, *args)
    d = pad_state(s.zero_displacement(), P_pad, "zero")
    levels = []
    for k in range(1, 5):
        d, its, rn = newton_solve_mi_host(
            scale_loads(data, k / 4), *args, cp_p, h_p, xi, d, rtol=1e-10,
            atol=0.0, max_it=40, device_fac=fac)
        levels.append(d)

    solve_d = build_solve_fn_mi(data, *args, rtol=1e-10, max_it=40)
    a = torch.tensor(0.05, dtype=torch.float64, requires_grad=True)
    h = s.h_init.clone().requires_grad_(True)
    cp_a = cp_of(a)
    cp_ap = pad_state(cp_a, P_pad)
    h_ap = pad_state(h, P_pad)
    d = solve_d(cp_ap, h_ap, s.c2x.solve(cp_a), levels[-2])
    J = kl_shell.internal_energy(data.stack, d, cp_ap, h_ap, data.E, data.nu,
                                 shard=data.shard)
    J.backward()
    return (float(J.detach()), float(a.grad), h.grad.numpy().copy(),
            d.detach()[:P].numpy().copy(),
            0 if data.shard is None else data.shard.contact_bytes)


def tube_loads(n_ranks, mesh=None):
    """{name: array} of the loaded tube (module docstring), padded for
    n_ranks, sharded over `mesh` when given."""
    from goldfish_tpu_torch.models import tube
    from goldfish_tpu_torch.parallel.sharding import (
        pad_state,
        pad_system,
        padded_patch_count,
        shard_system,
    )
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver import system as sy
    from goldfish_tpu_torch.solver.implicit import build_solve_fn_dataarg

    s = tube.build(num_el=3, p=3, pressure=5e2, tip_force=(0.0, 0.0, 50.0),
                   device="cpu")
    s.add_point_load(3, [0.5, 1.0], [0.0, 20.0, 5.0])
    s.set_dead_load([0.0, 3.0, 1.0])
    rng = np.random.default_rng(5)
    s.set_areal_field(rng.normal(size=tuple(s.cp.shape)))
    P = s.num_splines
    P_pad = padded_patch_count(P, n_ranks)
    data = pad_system(s.data, P_pad)
    if mesh is not None:
        data = shard_system(data, mesh)
    cp, h = pad_state(s.cp, P_pad), pad_state(s.h_init, P_pad)
    free = data.free.numpy()
    d = torch.from_numpy(1e-3 * rng.normal(size=free.shape) * free)
    v = torch.from_numpy(rng.normal(size=free.shape))
    th = torch.from_numpy(rng.normal(size=tuple(h.shape)))
    out = {}
    out["Pi"], out["r"] = sy.potential_and_residual(data, d, cp, h)
    out["K"] = sy.assemble_K(data, d, cp, h)
    out["Kv"] = sy.tangent_matvec(data, d, cp, h, v)
    out["vjp_cp"], out["vjp_h"] = sy.residual_vjp(data, d, cp, h, v)
    out["jvp"] = sy.residual_jvp(data, d, cp, h, v, th)
    out["vjpf_cp"], out["vjpf_h"], out["vjpf_f"] = sy.residual_vjp_field(
        data, d, cp, h, v)

    solve = build_solve_fn_dataarg(rtol=1e-10, max_it=30)
    cp_v = s.cp.clone().requires_grad_(True)
    h_v = s.h_init.clone().requires_grad_(True)
    cp_p, h_p = pad_state(cp_v, P_pad), pad_state(h_v, P_pad)
    d = solve(data, cp_p, h_p, torch.zeros_like(cp_p))
    J = kl_shell.internal_energy(data.stack, d, cp_p, h_p, data.E, data.nu,
                                 shard=data.shard)
    J.backward()
    out.update(J=J, dJ_cp=cp_v.grad, dJ_h=h_v.grad, d=d[:P])
    return {k: np.asarray(t.detach().numpy() if torch.is_tensor(t) else t)
            for k, t in out.items()}


def main(argv):
    import torch.distributed as dist

    from goldfish_tpu_torch.parallel.legs import run_leg
    from goldfish_tpu_torch.parallel.sharding import make_mesh

    store, rank, world, out = argv[:4]
    tasks = argv[4:]
    timeout_s = TIMEOUT_S
    if tasks[:1] == ["--timeout"]:
        timeout_s, tasks = float(tasks[1]), tasks[2:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh(device="cpu")
        res = {}
        for task in tasks:
            if task == "tube_loads":
                res.update({f"tube_loads.{k}": v
                            for k, v in tube_loads(world, mesh).items()})
            elif task == "tbeam_stop":
                J, da, dh, d, nb = tbeam_stop(world, mesh)
                res.update({"tbeam_stop.J": J, "tbeam_stop.da": da,
                            "tbeam_stop.dh": dh, "tbeam_stop.d": d,
                            "tbeam_stop.contact_bytes": nb})
            else:
                r = run_leg(task, world, mesh, "cpu")
                res[f"{task}.J"] = float(r["J"])
                res[f"{task}.g"] = r["g"].numpy()
        np.savez(f"{out}.rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
