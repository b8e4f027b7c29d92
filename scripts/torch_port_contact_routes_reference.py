"""Reference numbers for the PyTorch port's contact routes (JAX, CPU, f64).

- `mi_small`: the T-beam driven into a stop plate
  (tests/_torch_port_common.py: `port_tbeam_stop`, TBEAM_STOP_SMALL, built
  here from the JAX package's public calls) at amp = 0.05 on
  scripts/bench_mi.py's shape mode, in the JAX package's direct mode:
  Pi, r, K v and the assembled K of the MI system at a contact-active
  state; the field load alone (contact off): the MI residual and the field
  load's pullback -lam^T dR/df; four load levels warm-started
  (`newton_solve_mi`, rtol 1e-10) from d = 0; J = W_int with dJ/d(amp)
  and dJ/dh through `build_forward` at full load from the third level's d;
  `DispMintImOperation.apply_linear_fwd`/`apply_linear_rev` with contact at
  the equilibrium for seeded tangents.
- `mi_load`: the same at q = 200, the four levels' d (ROADMAP C20).
- `press_small`: tests/test_contact.py's press at num_el=4: the dense
  continuation (4 levels, rtol 1e-9, max_it 40), then `newton_krylov_solve`
  (the reference's route, f32 dense preconditioner) from 0.98 times that
  equilibrium, then J = W_int and dJ/dh by `build_solve_fn` (the JAX
  `build_solve_fn_krylov` builds a PairSchwarz, which asserts on a model
  without interfaces).
- `field_card`: the T-beam and stop plate at bench_mi's full width
  (TBEAM_STOP_CARD) with contact off: the four field-load levels and J,
  dJ/d(amp), dJ/dh as in `mi_small`. The JAX package's contact at this
  width is out of reach: its energy holds every pair of the two patches'
  13120 qps (4 GB of pair differences a call) and its Hessian is
  jax.hessian over 6072 pair dofs.

The machine with the GPU has no JAX, so `chip_smoke.py` and the port's CPU
tests check the port against
tests/data/torch_port_contact_routes_reference.json.

    JAX_PLATFORMS=cpu python scripts/torch_port_contact_routes_reference.py
        [--only mi_small mi_load press_small field_card]

Each part is merged into the existing file as it ends. CPU walls (one
process on an 8-core host, f64): mi_small ~200 s (most of it compiling;
the contact Hessian is jax.hessian), press_small ~56 s, field_card ~6.5
min and ~5 GB.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_contact_routes_reference.json")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

AMP = 0.05
LEVELS = 4
RTOL = 1e-10


def enc(a):
    """A float64 array as {"shape", "b64"} (little-endian bytes)."""
    a = np.ascontiguousarray(np.asarray(a, dtype="<f8"))
    return {"shape": list(a.shape),
            "b64": base64.b64encode(a.tobytes()).decode("ascii")}


def jax_tbeam_stop(num_el, p, n_pts, q, gap, r_max, k_pen, contact=True):
    """The JAX package's twin of `port_tbeam_stop`."""
    from _torch_port_common import STOP_X, STOP_Y, stop_plate_els

    from goldfish_tpu.models import tbeam
    from goldfish_tpu.physics.coupling import InterfaceSpec
    from goldfish_tpu.solver.system_mi import MINonMatchingSystem

    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
            [0, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = tbeam.create_surf(pts1, max((num_el + 1) // 2, 1), num_el + 1, p)
    nx, ny = stop_plate_els(num_el)
    (y0, y1), x = STOP_Y, STOP_X
    stop = tbeam.create_surf([[-x, y0, gap], [x, y0, gap], [-x, y1, gap],
                              [x, y1, gap]], nx, ny, p)
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=n_pts - 1)]
    s = MINonMatchingSystem([srf0, srf1, stop], tbeam.E, tbeam.NU,
                            tbeam.H_TH, specs=specs, n_pts_list=[n_pts])
    s.add_side_bc(0, direction=1, side=0, n_layers=1)
    s.add_side_bc(1, direction=1, side=0, n_layers=1)
    for direction in (0, 1):
        for side in (0, 1):
            s.add_side_bc(2, direction=direction, side=side, n_layers=1)
    f = np.zeros(np.asarray(s.cp).shape)
    f[0, : s.metas[0].n_cp, 2] = q
    s.set_areal_field(f)
    if contact:
        s.set_contact([(0, 2)], k_pen=k_pen, r_max=r_max)
    return s


def _bend(s):
    m = s.metas[1]
    gv = s.surfs[1].greville_points(1)
    return np.tile(np.sin(np.pi * gv)[None, :], (m.n_u, 1)).ravel()


def _levels_and_grad(s, out):
    """Four warm load levels at cp(AMP), then J, dJ/d(amp), dJ/dh through
    build_forward at full load from the third level's d."""
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.physics.contact import contact_energy
    from goldfish_tpu.solver.system import scale_loads
    from goldfish_tpu.solver.system_mi import newton_solve_mi, residual_mi

    m = s.metas[1]
    bend = jnp.asarray(_bend(s))
    cp_of = lambda a: s.cp.at[1, : m.n_cp, 0].add(a * bend)  # noqa: E731
    cp = cp_of(AMP)
    h = s.h_init
    xi = s.c2x.solve(cp)
    args = (s.mi, s.co, s.ss, s.pdeg, s.qdeg)
    d = s.zero_displacement()
    levels = []
    ds = []
    for k in range(1, LEVELS + 1):
        data = scale_loads(s.data, k / LEVELS)
        r0 = float(jnp.linalg.norm(residual_mi(
            data, *args, jnp.zeros_like(d), cp, h, xi)))
        d, it, rn = newton_solve_mi(data, *args, cp, h, xi, d, rtol=RTOL,
                                    max_it=40)
        Wc = float(contact_energy(s.data.contact, s.stack, d, cp))
        levels.append({"its": int(it), "r": float(rn), "r0": r0, "Wc": Wc})
        ds.append(d)
        print(f"  level {k}: its {int(it)} |r| {float(rn):.3e} "
              f"(|r0| {r0:.3e}) W_c {Wc:.6g}", flush=True)
    forward = s.build_forward(rtol=RTOL, max_it=40)

    def J_of(amp, h_):
        c = cp_of(amp)
        dd, _ = forward(c, h_, ds[-2])
        return kl_shell.internal_energy(s.stack, dd, c, h_, s.E, s.nu), dd

    (J, dd), (g_amp, g_h) = jax.value_and_grad(
        J_of, argnums=(0, 1), has_aux=True)(jnp.asarray(AMP), h)
    out.update(levels=levels, d_levels=enc(np.stack(ds)), d=enc(dd),
               xi=enc(xi), cp=enc(cp), J=float(J), dJ_damp=float(g_amp),
               dJ_dh=enc(g_h),
               Wc=float(contact_energy(s.data.contact, s.stack, dd, cp)),
               tip=[float(v) for v in s.evaluate_displacement(
                   dd, 0, [1.0, 1.0])])
    print(f"  J {float(J)!r} dJ/damp {float(g_amp)!r}", flush=True)
    return cp, h, xi, dd


def mi_small():
    import jax
    import jax.numpy as jnp

    from _torch_port_common import TBEAM_STOP_SMALL

    from goldfish_tpu.operations.disp_mi_imop import DispMintImOperation
    from goldfish_tpu.physics.contact import contact_energy
    from goldfish_tpu.solver.system_mi import (
        assemble_K_mi,
        residual_mi,
        total_potential_mi,
    )

    t0 = time.perf_counter()
    s = jax_tbeam_stop(**TBEAM_STOP_SMALL)
    out = {"config": dict(TBEAM_STOP_SMALL), "amp": AMP}
    args = (s.mi, s.co, s.ss, s.pdeg, s.qdeg)
    cp, h, xi, d_eq = _levels_and_grad(s, out)
    # a contact-active state: the equilibrium plus seeded noise
    rng = np.random.default_rng(20)
    free = np.asarray(s.data.free)
    scale = np.linalg.norm(np.asarray(cp)) / np.sqrt(np.asarray(cp).size)
    d = np.asarray(d_eq) + 1e-4 * scale * rng.normal(size=free.shape) * free
    v = rng.normal(size=free.shape)
    lam = rng.normal(size=free.shape)
    d = jnp.asarray(d)
    Pi = total_potential_mi(s.data, *args, d, cp, h, xi)
    r = residual_mi(s.data, *args, d, cp, h, xi)
    Kv = jax.jvp(lambda dd: residual_mi(s.data, *args, dd, cp, h, xi),
                 (d,), (jnp.asarray(v) * s.data.free,))[1] * s.data.free
    K = assemble_K_mi(s.data, *args, d, cp, h, xi)
    out.update(state_d=enc(d), v=enc(v), lam=enc(lam), Pi=float(Pi),
               r=enc(r), Kv=enc(Kv), K=enc(K),
               state_Wc=float(contact_energy(s.data.contact, s.stack, d,
                                             cp)))
    # the field load alone
    nc = s.data._replace(contact=None)

    def r_of_f(f):
        return residual_mi(nc._replace(f_field=f), *args, d, cp, h, xi)

    r_f, vjp = jax.vjp(r_of_f, nc.f_field)
    out.update(field_r=enc(r_f), field_pull=enc(vjp(-jnp.asarray(lam))[0]))
    # DispMintImOperation with contact at the equilibrium
    op = DispMintImOperation(s)
    lay = op.layout
    flat = lambda a: np.asarray(lay.to_flat(jnp.asarray(a))).ravel()  # noqa
    cp_f, h_f, d_f = flat(cp), np.asarray(lay.to_flat(h)).ravel(), \
        flat(d_eq)
    xi_f = np.asarray(xi).ravel()
    op.linearize(cp_f, h_f, xi_f, d_f)
    tan = {"d_cp": rng.normal(size=cp_f.shape),
           "d_h": 1e-2 * rng.normal(size=h_f.shape),
           "d_xi": 1e-3 * rng.normal(size=xi_f.shape),
           "d_d": rng.normal(size=d_f.shape)}
    w = rng.normal(size=d_f.shape)
    fwd = op.apply_linear_fwd(**tan)
    rev = op.apply_linear_rev(w)
    lhs = float(fwd @ w)
    rhs = float(sum(t @ b for t, b in zip(
        (tan["d_cp"], tan["d_h"], tan["d_xi"], tan["d_d"]), rev)))
    out["op"] = {"tan": {k: enc(a) for k, a in tan.items()}, "w": enc(w),
                 "fwd": enc(fwd), "rev": [enc(a) for a in rev],
                 "dot_fwd": lhs, "dot_rev": rhs}
    out["seconds"] = time.perf_counter() - t0
    print(f"mi_small: Pi {float(Pi)!r} W_c(state) {out['state_Wc']!r} "
          f"dot {lhs!r} {rhs!r} ({out['seconds']:.1f} s)", flush=True)
    return out


def mi_load():
    """The small T-beam and stop plate at 2.5 times the load (q = 200): the
    four levels' d (ROADMAP C20: iterates with an indefinite tangent)."""
    import jax.numpy as jnp

    from _torch_port_common import TBEAM_STOP_SMALL

    from goldfish_tpu.physics.contact import contact_energy
    from goldfish_tpu.solver.system import scale_loads
    from goldfish_tpu.solver.system_mi import newton_solve_mi

    t0 = time.perf_counter()
    cfg = dict(TBEAM_STOP_SMALL, q=200.0)
    s = jax_tbeam_stop(**cfg)
    m = s.metas[1]
    cp = s.cp.at[1, : m.n_cp, 0].add(AMP * jnp.asarray(_bend(s)))
    xi = s.c2x.solve(cp)
    args = (s.mi, s.co, s.ss, s.pdeg, s.qdeg)
    d = s.zero_displacement()
    ds, its = [], []
    for k in range(1, LEVELS + 1):
        d, it, _ = newton_solve_mi(scale_loads(s.data, k / LEVELS), *args,
                                   cp, s.h_init, xi, d, rtol=RTOL, max_it=40)
        ds.append(d)
        its.append(int(it))
    out = {"config": cfg, "amp": AMP, "d_levels": enc(np.stack(ds)),
           "its": its, "Wc": float(contact_energy(s.data.contact, s.stack,
                                                  d, cp)),
           "seconds": time.perf_counter() - t0}
    print(f"mi_load: its {its} W_c {out['Wc']!r} ({out['seconds']:.1f} s)",
          flush=True)
    return out


def press_small():
    import jax.numpy as jnp

    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.physics.contact import contact_energy
    from goldfish_tpu.solver.implicit import (
        build_solve_fn,
        continuation_solve,
    )
    from goldfish_tpu.solver.krylov import newton_krylov_solve
    from goldfish_tpu.solver.system import residual
    from test_contact import _press_problem

    import jax

    t0 = time.perf_counter()
    s = _press_problem(num_el=4)
    data = s.data
    d_dense, _, _ = continuation_solve(data, s.cp, s.h_init,
                                       s.zero_displacement(), n_steps=4,
                                       rtol=1e-9, max_it=40)
    d_k, it, rn = newton_krylov_solve(data, s.cp, s.h_init, 0.98 * d_dense,
                                      rtol=1e-10, cg_rtol=1e-8)
    r0 = float(jnp.linalg.norm(residual(data, jnp.zeros_like(d_k), s.cp,
                                        s.h_init)))
    solve = build_solve_fn(data, rtol=1e-10, max_it=60)

    def J_of(h):
        d = solve(s.cp, h, d_k)
        return kl_shell.internal_energy(s.stack, d, s.cp, h, s.E, s.nu), d

    (J, d), g = jax.value_and_grad(J_of, has_aux=True)(s.h_init)
    out = {"num_el": 4, "start": "0.98 x the dense continuation's d",
           "d_dense": enc(d_dense), "d_krylov": enc(d_k), "its": int(it),
           "r": float(rn), "r0": r0, "d": enc(d), "J": float(J),
           "dJ_dh": enc(g),
           "Wc": float(contact_energy(data.contact, s.stack, d, s.cp)),
           "krylov_vs_dense": float(jnp.linalg.norm(d_k - d_dense)
                                    / jnp.linalg.norm(d_dense)),
           "seconds": time.perf_counter() - t0}
    print(f"press_small: Krylov its {int(it)} |r| {float(rn):.3e} / "
          f"{r0:.3e}, vs dense {out['krylov_vs_dense']:.2e}, J {float(J)!r}"
          f" ({out['seconds']:.1f} s)", flush=True)
    return out


def field_card():
    from _torch_port_common import TBEAM_STOP_CARD

    t0 = time.perf_counter()
    s = jax_tbeam_stop(**TBEAM_STOP_CARD, contact=False)
    out = {"config": dict(TBEAM_STOP_CARD), "contact": False, "amp": AMP,
           "n_dofs": int(np.asarray(s.cp).size)}
    _levels_and_grad(s, out)
    # the levels' d as norms; d, dJ/dh kept whole
    a = np.frombuffer(base64.b64decode(out.pop("d_levels")["b64"]), "<f8")
    out["d_levels_norm"] = [float(np.linalg.norm(x))
                            for x in a.reshape(LEVELS, -1)]
    for k in ("xi", "cp"):
        a = np.frombuffer(base64.b64decode(out.pop(k)["b64"]), "<f8")
        out[k + "_norm"] = float(np.linalg.norm(a))
    out["seconds"] = time.perf_counter() - t0
    print(f"field_card: ({out['seconds']:.1f} s)", flush=True)
    return out


PARTS = {"mi_small": mi_small, "mi_load": mi_load,
         "press_small": press_small, "field_card": field_card}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=list(PARTS))
    a = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from goldfish_tpu.solver import linalg

    linalg.set_mode("direct")
    for name in a.only:
        res = PARTS[name]()
        res["jax_version"] = jax.__version__
        data = {}
        if os.path.exists(OUT):
            with open(OUT) as f:
                data = json.load(f)
        data[name] = res
        with open(OUT, "w") as f:
            json.dump(data, f, indent=1)
            f.write("\n")
        print(f"{name} -> {OUT}", flush=True)


if __name__ == "__main__":
    main()
