"""Reference numbers for the PyTorch port's pressurized-tube optimizations.

Runs the objectives of the two tube shape optimizations at num_el=16, p=3
(4 patches, N = 8436 padded dofs) under a follower pressure of 1e2 with the
JAX package on the CPU in float64, direct linear-solver mode, and writes
their cold J and dJ/dp, and the residual |r| / |r(0)| of each cold solve,
to tests/data/torch_port_tube16_reference.json.

At the demos' own pressure (2e4) the num_el=16 tube does not reach an
equilibrium from d = 0: the JAX package's Newton stops after 9 iterations
at |r| = 10.3 |r(0)| (fixed seams), and the tangent along the way has
negative eigenvalues. At 1e3 both cold solves converge, but SLSQP's
first steps reach designs whose tangent is indefinite, where the port's
Cholesky factor fails. 1e2 is the largest pressure of the sweep
(scripts/torch_port_tube_pressure_sweep.py on the card: 1e3, 5e2, 2e2,
1e2, 5e1) at which the moving-seam optimization factors cleanly and both
optimizations end below their start in 3 iterations.

- fixed seams (demos/tube_shape_opt.py): the elliptic tube, ShapeFFD (2, 2, 1) of degree (3, 3, 1) on x and y (100
  design variables), build_solve_fn(rtol=1e-9, max_it=40), J = internal
  energy, `jax.value_and_grad` at p0 from d = 0;
- moving seams (demos/draft_tube_shopt_mi_wffd.py): the four seams as
  moving intersections of 2 num_el + 3 = 35 points, ShapeFFD (2, 2, 2) of
  degree 2 on x and y (128 variables), build_forward(rtol=1e-9,
  max_it=25), at the demo's ovalized start p_start from d = 0 and the
  initial seams.

The machine with the GPU has no JAX, so `chip_smoke.py` checks the port
against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_tube_reference.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_tube16_reference.json")
NUM_EL, P_DEG = 16, 3
PRESSURE = 1.0e2


def fixed_path(jax, jnp):
    """Cold J and dJ/dp_xy of demos/tube_shape_opt.py at p0."""
    from demos import tube_shape_opt as demo
    from goldfish_tpu.design.pipeline import ShapeFFD
    from goldfish_tpu.models import tube
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver.implicit import build_solve_fn
    from goldfish_tpu.solver.system import residual

    s = demo.build(NUM_EL, P_DEG, PRESSURE)
    R = tube.RADIUS
    m = 1.05 * max(demo.SCALE_X * R, demo.SCALE_Y * R)
    ffd = ShapeFFD(s, num_els=(2, 2, 1), p=(3, 3, 1),
                   lims=np.array([[-m, m], [-m, m],
                                  [-1e-3, tube.LENGTH + 1e-3]]),
                   opt_fields=(0, 1))
    solve = build_solve_fn(s.data, rtol=1e-9, max_it=40)

    def J_of(p):
        cp = ffd(p)
        d = solve(cp, s.h_init, s.zero_displacement())
        return kl_shell.internal_energy(s.stack, d, cp, s.h_init, s.E,
                                        s.nu), d

    p0 = ffd.init_p_ffd()
    (J, d), g = jax.value_and_grad(J_of, has_aux=True)(jnp.asarray(p0))
    cp = ffd(jnp.asarray(p0))
    r_rel = float(jnp.linalg.norm(residual(s.data, d, cp, s.h_init))
                  / jnp.linalg.norm(residual(s.data, 0 * d, cp, s.h_init)))
    return dict(J=float(J), dJ_dp=np.asarray(g).tolist(), r_rel=r_rel,
                d_norm=float(np.linalg.norm(np.asarray(d))),
                n_dofs=int(np.asarray(s.cp).size), n_design=int(p0.size))


def mi_path(jax, jnp):
    """Cold J and dJ/dp_ffd of demos/draft_tube_shopt_mi_wffd.py at its
    ovalized start p_start."""
    from demos import draft_tube_shopt_mi_wffd as demo
    from goldfish_tpu.design.pipeline import ShapeFFD
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver.system_mi import residual_mi

    s = demo.build_mi_tube(num_el=NUM_EL, p=P_DEG, pressure=PRESSURE)
    sh = ShapeFFD(s, num_els=(2, 2, 2), p=2, opt_fields=(0, 1))
    forward = s.build_forward(rtol=1e-9, max_it=25)
    p0 = sh.init_p_ffd()
    n = sh.n_ffd
    nx, ny, _ = sh.shape
    free_z = ((np.arange(n) // (nx * ny)) > 0).astype(float)
    p_start = p0.copy()
    p_start[:n] *= 1.0 + 0.08 * free_z
    p_start[n:] *= 1.0 - 0.07 * free_z

    def J_of(p):
        cp = sh(p)
        d, xi = forward(cp, s.h_init, s.zero_displacement())
        return kl_shell.internal_energy(s.stack, d, cp, s.h_init, s.E,
                                        s.nu), (d, xi)

    (J, (d, xi)), g = jax.value_and_grad(J_of, has_aux=True)(
        jnp.asarray(p_start))
    xi0 = np.asarray(s.c2x.xi0_flat)
    cp = sh(jnp.asarray(p_start))
    args = (s.data, s.mi, s.co, s.ss, s.pdeg, s.qdeg)
    r_rel = float(jnp.linalg.norm(residual_mi(*args, d, cp, s.h_init, xi))
                  / jnp.linalg.norm(residual_mi(*args, 0 * d, cp, s.h_init,
                                                xi)))
    return dict(J=float(J), dJ_dp=np.asarray(g).tolist(), r_rel=r_rel,
                d_norm=float(np.linalg.norm(np.asarray(d))),
                xi_shift_norm=float(np.linalg.norm(np.asarray(xi) - xi0)),
                n_dofs=int(np.asarray(s.cp).size), n_design=int(p0.size),
                n_seams=int(s.mi.n_int), n_pts=int(2 * NUM_EL + 3))


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from goldfish_tpu.solver import linalg

    linalg.set_mode("direct")
    out = {"num_el": NUM_EL, "p": P_DEG, "pressure": PRESSURE,
           "solver_mode": "direct",
           "platform": "cpu", "dtype": "float64",
           "jax_version": jax.__version__}
    try:
        for name, fn in (("fixed", fixed_path), ("mi", mi_path)):
            t0 = time.perf_counter()
            out[name] = fn(jax, jnp)
            out[name]["seconds"] = time.perf_counter() - t0
            jax.clear_caches()
            print(f"{name}: J={out[name]['J']!r} |dJ/dp|="
                  f"{np.linalg.norm(out[name]['dJ_dp'])!r} |r|/|r(0)|="
                  f"{out[name]['r_rel']:.3e} "
                  f"({out[name]['seconds']:.1f} s)", flush=True)
    finally:
        linalg.set_mode(None)
    try:
        out["commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out["commit"] = None
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
