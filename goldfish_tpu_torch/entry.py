"""Driver entry point: one damped-Newton update on the flagship model.

Port of `__graft_entry__.entry`: `entry()` returns `(fn, example_args)`,
`fn(data, cp, h, d) -> (d_new, |r|)` being one Newton update on the small
4-patch wing (`wing.build(n_chord=2, n_span=2, num_el=2, p=2)`): the
residual, the tangent K (the shell and penalty jet Hessians, kernel K1 and
K2 mode b, assembled by K3), the Cholesky solve of the diagonally
equilibrated K (K14's factor, K13's substitution), and the update
masked to the free dofs. It is the per-iteration step of the hot loop, on
the card by default.

    from goldfish_tpu_torch.entry import entry
    fn, args = entry()
    d_new, r_norm = fn(*args)

`dryrun_multichip(n_ranks)` is the multi-chip dry run: the reference's
three legs (the 20-patch wing, the 91-patch box wing, the moving-
intersection wing box), each a forward solve and its adjoint gradient,
patch-sharded over `n_ranks` processes of one gloo group against the same
leg unsharded in this process.

    from goldfish_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(2, device="cpu")     # or on the card: device=None
"""

from __future__ import annotations

import torch

__all__ = ["entry", "newton_update", "dryrun_multichip"]


@torch.no_grad()
def newton_update(data, cp, h, d):
    """(d_new, |r|): d_new = d + free * K^-1 (-r) at d."""
    from goldfish_tpu_torch.solver.cholesky import chol_factor, chol_solve
    from goldfish_tpu_torch.solver.system import assemble_K, residual

    r = residual(data, d, cp, h)
    K = assemble_K(data, d, cp, h)
    s = torch.rsqrt(K.diagonal().abs())
    K.mul_(s[:, None]).mul_(s[None, :])   # equilibrate, then factor in place
    L, info, invs = chol_factor(K)
    if int(info) != 0:
        raise RuntimeError(f"the tangent is not positive definite "
                           f"(chol_factor info {int(info)})")
    delta = chol_solve(L, s, -r.reshape(-1, 1), invs)
    d_new = d + delta.reshape(r.shape) * data.free
    return d_new, torch.linalg.norm(r)


def entry(device=None):
    """(fn, example_args): `newton_update` and (data, cp, h, d = 0) of the
    small 4-patch wing on `device` (the current CUDA device by default)."""
    from goldfish_tpu_torch.models import wing

    sys_ = wing.build(n_chord=2, n_span=2, num_el=2, p=2, device=device)
    return newton_update, (sys_.data, sys_.cp, sys_.h_init,
                           sys_.zero_displacement())


_LABELS = {"wing": "wing P=20", "boxwing": "boxwing P=91", "mi": "MI",
           "wing_full": "wing_full P=20", "wing_small": "wing_small P=4"}


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def _wait(procs, logs, timeout_s):
    """Wait for every rank within timeout_s in all; on a timeout or a
    failed rank, kill the rest and raise with the ranks' logs."""
    import subprocess
    import time

    end = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(end - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    bad = [r for r, p in enumerate(procs) if p.poll() != 0]
    _kill(procs)
    if bad:
        tails = []
        for r in bad:
            with open(logs[r]) as fh:
                tails.append(f"--- rank {r} (rc {procs[r].returncode}) ---\n"
                             + fh.read()[-4000:])
        raise RuntimeError(f"dryrun_multichip: ranks {bad} failed or timed "
                           f"out ({timeout_s:.0f} s)\n" + "\n".join(tails))


def dryrun_multichip(n_ranks: int, device=None, legs=None, timeout_s=600.0):
    """Port of `__graft_entry__.dryrun_multichip`: each leg (default the
    reference's three, `parallel.legs.LEGS`) runs patch-sharded over
    `n_ranks` processes, started here
    (`python -m goldfish_tpu_torch.parallel.legs`, one gloo group on a
    FileStore in a temporary directory), and unsharded in this process
    (on the CPU while they run, on the card after them), all padded to
    `padded_patch_count(P, n_ranks)`. Bars:
    J within 1e-9 and dJ within 1e-6 (relative), and every rank must hold
    the same bits of J and dJ. Prints the reference's `dryrun leg i/n ...
    ok: dJ rel=... wall sharded=... unsharded=...` lines and returns
    {leg: {J, J_unsharded, g, g_unsharded, rel_J, rel_g, wall_sharded,
    wall_unsharded, counts (one launch-count dict a rank),
    allreduce_ms (per rank, on the card: (K, K v))}}.

    `device` is the card unless device="cpu"; on the card every rank works
    on CUDA tensors of that one card (two ranks may share it: gloo, not
    NCCL). A rank that fails or outlives `timeout_s` makes this raise.
    The ranks inherit the environment, so GOLDFISH_SHARD_CHECK=1 turns on
    their decision guard.
    The walls are of the one call each (the port compiles nothing; its
    kernels are built before the first launch)."""
    import os
    import subprocess
    import sys
    import tempfile

    import numpy as np

    import goldfish_tpu_torch
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.config import as_device
    from goldfish_tpu_torch.parallel.legs import LEGS, run_leg

    legs = tuple(LEGS if legs is None else legs)
    dev = as_device(device)
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        goldfish_tpu_torch.__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if dev.type == "cuda":
        _cuda.library()     # build once here; the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(n_ranks)]
        procs = []
        try:
            for r in range(n_ranks):
                with open(logs[r], "w") as fh:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "goldfish_tpu_torch.parallel.legs",
                         os.path.join(tmp, "store"), str(r), str(n_ranks),
                         out, dev.type, *legs],
                        env=env, cwd=tmp, stdout=fh,
                        stderr=subprocess.STDOUT))
            # on the CPU the unsharded legs run while the ranks work; on
            # the card after them, so that no wall shares the card
            if dev.type == "cpu":
                whole = {k: run_leg(k, n_ranks, None, dev) for k in legs}
            _wait(procs, logs, timeout_s)
            if dev.type != "cpu":
                whole = {k: run_leg(k, n_ranks, None, dev) for k in legs}
        finally:
            _kill(procs)
        ranks = [dict(np.load(f"{out}.rank{r}.npz")) for r in range(n_ranks)]
    res = {}
    for i, name in enumerate(legs):
        u = whole[name]
        J, g = ranks[0][f"{name}.J"], ranks[0][f"{name}.g"]
        for r, rk in enumerate(ranks[1:], 1):
            if not (rk[f"{name}.J"] == J
                    and np.array_equal(rk[f"{name}.g"], g)):
                raise AssertionError(f"{name}: rank {r}'s J or dJ differs "
                                     "from rank 0's")
        J_u = float(u["J"])
        g_u = u["g"].detach().cpu().numpy()
        rel_J = abs(float(J) - J_u) / max(abs(J_u), 1e-300)
        rel_g = float(np.linalg.norm(g - g_u)
                      / (np.linalg.norm(g_u) + 1e-300))
        if not (np.isfinite(float(J)) and np.all(np.isfinite(g))):
            raise AssertionError(f"{name}: non-finite objective or gradient")
        if not rel_J < 1e-9:
            raise AssertionError(f"{name}: sharded-vs-unsharded J "
                                 f"{rel_J:.3e}")
        if not rel_g < 1e-6:
            raise AssertionError(f"{name}: sharded-vs-unsharded dJ "
                                 f"{rel_g:.3e}")
        wall_s = max(float(rk[f"{name}.wall"]) for rk in ranks)
        print(f"dryrun leg {i + 1}/{len(legs)} {_LABELS[name]} ok: "
              f"dJ rel={rel_g:.2e} wall sharded={wall_s:.2f}s "
              f"unsharded={u['wall']:.2f}s", flush=True)
        res[name] = dict(
            J=float(J), J_unsharded=J_u, g=g, g_unsharded=g_u, rel_J=rel_J,
            rel_g=rel_g, wall_sharded=wall_s, wall_unsharded=u["wall"],
            counts=[dict(zip(_cuda.COUNTERS,
                             rk[f"{name}.counts"].tolist()))
                    for rk in ranks],
            allreduce_ms=[rk[f"{name}.allreduce_ms"].tolist()
                          for rk in ranks if f"{name}.allreduce_ms" in rk])
    print(f"dryrun_multichip({n_ranks}): "
          + ", ".join(f"{_LABELS[k]} J={v['J']:.6e} dJ rel={v['rel_g']:.2e}"
                      for k, v in res.items())
          + f", device={dev}", flush=True)
    return res
