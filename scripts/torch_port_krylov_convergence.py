"""Does the reference's matrix-free route solve the box wing? (CPU, f64)

Evidence for ROADMAP Queue C's entry on solver/krylov.py, on the small box
wing `boxwing.build(n_sections=2, num_el=2, p=2)` (11 patches, N = 660):

1. the JAX package's `newton_krylov_solve(schwarz=PairSchwarz)` (the
   pegasus demo's forward solve, rtol 1e-8, cg_rtol 1e-8) against its dense
   `newton_solve`: |d_mf - d_dense| / |d_dense|, and both |r|;
2. the port's pair-Schwarz sweep as an operator: the eigenvalues of
   M^-1 K on the free dofs at d = 0 (smallest |mu|, how many below 1e-6,
   1e-4, 1e-2);
3. the port's GMRES-IR (restart 32, one refinement pass, at most 20
   restart cycles) on the cold Newton system K(0) x = -r(0) with each
   preconditioner: cycles and |K x + r| / |r|; with `--medium` also on
   `boxwing.build(n_sections=4, num_el=3, p=3)` (21 patches, N = 2646);
   on the small wing also SciPy's GMRES(32) with the pair-Schwarz sweep for
   3000 iterations; with `--wing` also on the 20-patch wing
   `wing.build(num_el=2, p=3)` (N = 2520).

    JAX_PLATFORMS=cpu python scripts/torch_port_krylov_convergence.py
        [--medium] [--wing]

Part 1 compiles the JAX package's jitted Newton-Krylov solve (~4 min).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_part():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from goldfish_tpu.models import boxwing
    from goldfish_tpu.solver.implicit import newton_solve
    from goldfish_tpu.solver.krylov import PairSchwarz, newton_krylov_solve

    s = boxwing.build(n_sections=2, num_el=2, p=2)
    t0 = time.perf_counter()
    d_mf, it, rn = newton_krylov_solve(
        s.data, s.cp, s.h_init, jnp.zeros_like(s.cp), rtol=1e-8,
        cg_rtol=1e-8, schwarz=PairSchwarz(s.data))
    t1 = time.perf_counter()
    d_de, it_d, rn_d = newton_solve(s.data, s.cp, s.h_init,
                                    jnp.zeros_like(s.cp), rtol=1e-11)
    d_mf, d_de = np.asarray(d_mf), np.asarray(d_de)
    print(f"[jax] newton_krylov_solve(PairSchwarz): {int(it)} its, |r| "
          f"{float(rn)!r} ({t1 - t0:.1f} s incl. compile); dense "
          f"newton_solve: {int(it_d)} its, |r| {float(rn_d)!r}; "
          f"|d_mf - d_dense|/|d_dense| "
          f"{np.linalg.norm(d_mf - d_de) / np.linalg.norm(d_de)!r}",
          flush=True)


def port_part(model, spectrum, builder="boxwing"):
    import importlib

    import torch

    from goldfish_tpu_torch.solver import krylov, system

    mod = importlib.import_module(f"goldfish_tpu_torch.models.{builder}")
    s = mod.build(**model, device="cpu")
    data, cp, h = s.data, s.cp, s.h_init
    d = s.zero_displacement()
    ps = krylov.PairSchwarz(data)
    tables = ps.tables
    Hs = system.jet_hessians(data, d, cp, h)
    op = lambda v: system.tangent_matvec_from(tables, Hs, v)  # noqa: E731
    _, r = system.potential_and_residual(data, d, cp, h)
    N = r.numel()
    print(f"[port] {builder} {model}: {s.num_splines} patches, N = {N}, "
          f"{len(ps.colors)} colours", flush=True)
    pre = {"pair_schwarz": (ps, ps.assemble(data, d, cp, h, Hs=Hs)),
           "patch_block": krylov.patch_block_precond(data, d, cp, h,
                                                     tables=tables, Hs=Hs),
           "full": krylov.full_precond(data, d, cp, h, tables=tables,
                                       Hs=Hs)}
    if spectrum:
        K = system.assemble_K_from(tables, Hs).numpy()
        fi = np.nonzero(data.free.numpy().reshape(-1))[0]
        M = krylov._mop(pre["pair_schwarz"], op)
        cols = []
        for j in fi:
            cols.append(M(torch.from_numpy(np.ascontiguousarray(
                K[:, j])).reshape(r.shape)).reshape(-1).numpy()[fi])
        mu = np.sort(np.abs(np.linalg.eigvals(np.stack(cols, 1))))
        print(f"[port] eigenvalues of M^-1 K (pair-Schwarz) on {len(fi)} "
              f"free dofs: smallest |mu| {mu[0]:.3e}, largest {mu[-1]:.3e};"
              f" below 1e-6 / 1e-4 / 1e-2: {int((mu < 1e-6).sum())} / "
              f"{int((mu < 1e-4).sum())} / {int((mu < 1e-2).sum())}",
              flush=True)
    for name, p in pre.items():
        t0 = time.perf_counter()
        x, cyc = krylov._gmres_ir(op, krylov._mop(p, op), -r, 1e-8, 32, 20,
                                  1)
        res = float(torch.linalg.norm(op(x) + r) / torch.linalg.norm(r))
        print(f"[port] GMRES-IR with {name}: {cyc} restart cycles, "
              f"|Kx + r|/|r| {res:.3e} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    if spectrum:
        # SciPy's own GMRES with the port's pair-Schwarz sweep as its
        # preconditioner, 3000 iterations: a long run without the port's
        # stagnation stop
        import scipy.sparse.linalg as sla

        Mop = krylov._mop(pre["pair_schwarz"], op)

        def mv(v):
            return Mop(torch.from_numpy(np.asarray(v, dtype=np.float64))
                       .reshape(r.shape)).reshape(-1).numpy()

        b = -r.reshape(-1).numpy()
        it = []
        x, _ = sla.gmres(K, b, M=sla.LinearOperator((N, N), matvec=mv),
                         rtol=1e-10, restart=32, maxiter=3000 // 32,
                         callback=lambda rk: it.append(rk),
                         callback_type="pr_norm")
        print(f"[port] SciPy GMRES(32) with pair_schwarz: {len(it)} "
              f"iterations, |Kx + r|/|r| "
              f"{np.linalg.norm(K @ x - b) / np.linalg.norm(b):.3e}",
              flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--medium", action="store_true")
    ap.add_argument("--wing", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    port_part(dict(n_sections=2, num_el=2, p=2), spectrum=True)
    if args.medium:
        port_part(dict(n_sections=4, num_el=3, p=3), spectrum=False)
    if args.wing:
        port_part(dict(num_el=2, p=3), spectrum=False, builder="wing")
    jax_part()


if __name__ == "__main__":
    main()
