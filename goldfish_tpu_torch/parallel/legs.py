"""The multi-chip dry run's legs and the rank worker that runs them.

Each leg is one optimizer evaluation, the forward Newton solve and the
adjoint gradient, on one model, either patch-sharded over the ranks of a
`PatchMesh` or whole in one process, with every tensor padded to
`padded_patch_count(P, n_ranks)` in both cases:

  wing       `wing.build(num_el=2, p=2)`, P = 20, J = W_int, dJ/dh_ffd of
             `ThicknessFFD((2, 1, 1), (2, 1, 1))`, rtol 1e-8, max_it 12
  boxwing    `boxwing.build(n_sections=18, num_el=1, p=2)`, P = 91,
             ragged patches, many interfaces across the rank blocks;
             `ThicknessFFD((2, 2, 1), (1, 1, 1))`, rtol 1e-8, max_it 12
  mi         the eVTOL 4-patch wing box (`build_system(num_el=1, p=2)`),
             four moving seams: the CP -> xi solve feeds the MI solve,
             dJ/dCP, rtol 1e-10, max_it 12
  wing_full  the full-width wing `wing.build(num_el=6, p=3)` (N = 6600),
             `ThicknessFFD((4, 4, 1), (2, 2, 1))`, rtol 1e-9, max_it 30
  wing_small `wing.build(n_chord=2, n_span=2, num_el=2, p=2)`, P = 4, the
             wing leg's FFD and tolerances

The first three are the reference's `dryrun_multichip` legs
(__graft_entry__.py). `entry.dryrun_multichip` starts the ranks as

    python -m goldfish_tpu_torch.parallel.legs STORE RANK WORLD OUT DEVICE
        LEG [LEG ...]

which join one gloo group on a FileStore (no TCP port to race for), run
the legs sharded and write OUT.rank{RANK}.npz.
"""

from __future__ import annotations

import datetime
import sys
import time

import numpy as np
import torch

from goldfish_tpu_torch.config import DTYPE

__all__ = ["LEGS", "run_leg", "worker_main"]

LEGS = ("wing", "boxwing", "mi")


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _padded(sys_, n_ranks, mesh):
    """(data, cp, d0, P_pad) of sys_ padded for n_ranks, sharded over
    `mesh` when given."""
    from goldfish_tpu_torch.parallel.sharding import (
        pad_state,
        pad_system,
        padded_patch_count,
        shard_system,
    )

    P_pad = padded_patch_count(sys_.num_splines, n_ranks)
    data = pad_system(sys_.data, P_pad)
    if mesh is not None:
        data = shard_system(data, mesh)
    return (data, pad_state(sys_.cp, P_pad, "repeat"),
            pad_state(sys_.zero_displacement(), P_pad, "zero"), P_pad)


def thickness_eval(sys_, n_ranks, mesh, th, h_ffd, rtol, max_it, d0=None):
    """J = W_int and dJ/dh_ffd of one thickness design through
    `build_solve_fn_dataarg` (a fresh factor), from d0 (default 0).
    Returns (J, dJ/dh_ffd, d, wall seconds)."""
    from goldfish_tpu_torch.parallel.sharding import pad_state
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn_dataarg

    data, cp, d_zero, P_pad = _padded(sys_, n_ranks, mesh)
    solve = build_solve_fn_dataarg(rtol=rtol, max_it=max_it)
    dev = cp.device
    _sync(dev)
    t0 = time.perf_counter()
    hf = h_ffd.detach().clone().requires_grad_(True)
    h = pad_state(th(hf), P_pad, "repeat")
    d = solve(data, cp, h, d_zero if d0 is None else d0)
    J = kl_shell.internal_energy(data.stack, d, cp, h, data.E, data.nu,
                                 shard=data.shard)
    J.backward()
    _sync(dev)
    return J.detach(), hf.grad, d.detach(), time.perf_counter() - t0


def _result(J, g, wall, sys_, n_ranks):
    from goldfish_tpu_torch.parallel.sharding import padded_patch_count

    P_pad = padded_patch_count(sys_.num_splines, n_ranks)
    return dict(J=J, g=g, wall=wall, P=sys_.num_splines,
                N=P_pad * sys_.stack.max_cp * 3)


def _thickness_leg(build, ffd, h0, rtol, max_it):
    def leg(n_ranks, mesh, device):
        from goldfish_tpu_torch.design.pipeline import ThicknessFFD

        sys_ = build(device)
        th = ThicknessFFD(sys_, num_els=ffd[0], p=ffd[1])
        h_ffd = torch.tensor(th.init_h_ffd(h0), dtype=DTYPE, device=device)
        J, g, _, wall = thickness_eval(sys_, n_ranks, mesh, th, h_ffd,
                                       rtol, max_it)
        return _result(J, g, wall, sys_, n_ranks)
    return leg


def _wing(**kw):
    from goldfish_tpu_torch.models import wing
    return lambda dev: wing.build(device=dev, **kw)


def _boxwing(dev):
    from goldfish_tpu_torch.models import boxwing
    return boxwing.build(n_sections=18, num_el=1, p=2, device=dev)


def _mi_leg(n_ranks, mesh, device):
    """The MI chain: xi = c2x.solve(cp), the MI solve at xi, J = W_int;
    dJ/dCP through both implicit adjoints."""
    from goldfish_tpu_torch.demos.evtol_wing_shopt_mi import build_system
    from goldfish_tpu_torch.parallel.sharding import pad_state
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.system_mi import build_solve_fn_mi

    s = build_system(num_el=1, p=2, device=device)
    assert s.num_splines == 4 and int(s.mi.n_int) == 4
    data, _, d0, P_pad = _padded(s, n_ranks, mesh)
    h = pad_state(s.h_init, P_pad, "repeat")
    solve_d = build_solve_fn_mi(data, s.mi, s.co, s.ss, s.pdeg, s.qdeg,
                                rtol=1e-10, max_it=12)
    dev = torch.device(device)
    _sync(dev)
    t0 = time.perf_counter()
    cp_u = s.cp.detach().clone().requires_grad_(True)
    xi = s.c2x.solve(cp_u)
    cp_p = pad_state(cp_u, P_pad, "repeat")
    d = solve_d(cp_p, h, xi, d0)
    J = kl_shell.internal_energy(data.stack, d, cp_p, h, data.E, data.nu,
                                 shard=data.shard)
    J.backward()
    _sync(dev)
    return _result(J.detach(), cp_u.grad, time.perf_counter() - t0, s,
                   n_ranks)


def _legs():
    from goldfish_tpu_torch.models import boxwing, wing

    small = dict(num_el=2, p=2)
    return {
        "wing": _thickness_leg(_wing(**small), ((2, 1, 1), (2, 1, 1)),
                               wing.H_TH, 1e-8, 12),
        "boxwing": _thickness_leg(_boxwing, ((2, 2, 1), (1, 1, 1)),
                                  boxwing.H_TH, 1e-8, 12),
        "mi": _mi_leg,
        "wing_full": _thickness_leg(_wing(num_el=6, p=3),
                                    ((4, 4, 1), (2, 2, 1)), wing.H_TH,
                                    1e-9, 30),
        "wing_small": _thickness_leg(
            _wing(n_chord=2, n_span=2, **small), ((2, 1, 1), (2, 1, 1)),
            wing.H_TH, 1e-8, 12),
    }


def run_leg(name, n_ranks, mesh=None, device="cpu"):
    """One leg (module docstring), sharded over `mesh` or whole: a dict of
    J (0-dim tensor), g (the design gradient), wall (seconds), P (patches)
    and N (dofs of the padded system)."""
    return _legs()[name](n_ranks, mesh, device)


def collective_ms(mesh, n, reps=3):
    """Milliseconds of one all-reduce of a dense (n, n) f64 K and of one
    (n,) K v on the mesh (median of reps, after one untimed call)."""
    dev = mesh.device
    out = []
    for shape in ((n, n), (n,)):
        t = torch.ones(shape, dtype=DTYPE, device=dev)
        mesh.sum(t)
        ts = []
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            mesh.sum(t)
            _sync(dev)
            ts.append(1e3 * (time.perf_counter() - t0))
        out.append(float(np.median(ts)))
        del t
    return out


def worker_main(argv):
    """Rank worker: STORE RANK WORLD OUT DEVICE LEG [LEG ...]."""
    import torch.distributed as dist

    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.parallel.sharding import (
        DEFAULT_TIMEOUT_S,
        make_mesh,
    )

    store_path, rank, world, out, device = argv[:5]
    legs = argv[5:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cuda":
            # untimed: the rank's first solve loads the CUDA libraries and
            # their handles, which no leg's wall should carry
            run_leg("wing_small", world, mesh, device)
        res = {}
        for name in legs:
            _cuda.reset_launch_counts()
            r = run_leg(name, world, mesh, device)
            res[f"{name}.J"] = float(r["J"])
            res[f"{name}.g"] = r["g"].detach().cpu().numpy()
            res[f"{name}.wall"] = r["wall"]
            res[f"{name}.counts"] = np.array(
                [_cuda.launch_counts[k] for k in _cuda.COUNTERS])
            if mesh.device.type == "cuda":
                res[f"{name}.allreduce_ms"] = np.array(
                    collective_ms(mesh, r["N"]))
        np.savez(f"{out}.rank{rank}.npz", **res)
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker_main(sys.argv[1:])
