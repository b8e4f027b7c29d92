"""Reference numbers for the port's small-tube CPU tests (JAX, CPU, f64).

At the tests' small tube (num_el=3, p=3, follower pressure 5e2: the
objectives of tests/_torch_port_common.py's `jax_fixed_tube` and
`jax_mi_tube`):

- `fixed`: J and dJ/dp of demos/tube_shape_opt.py's objective at p0 from
  d = 0 (`jax.value_and_grad`, jitted);
- `fixed_slsqp`: the JAX demo's OptProblem (its bounds, the pin and regu
  constraints of demos/tube_shape_opt.py:82-100) on that objective,
  `run_slsqp(maxiter=2, tol=1e-14)`: nit, nfev, njev, x, fun, history;
- `mi`: J and dJ/dp of demos/draft_tube_shopt_mi_wffd.py's objective at
  the ovalized start p_start from d = 0 (direct linear-solver mode,
  `build_forward(rtol=1e-9, max_it=25)`).

tests/test_torch_tube.py and tests/test_torch_tube_mi.py hold the port
against tests/data/torch_port_tube_small_reference.json instead of
recomputing these numbers with the JAX package on every run.

    JAX_PLATFORMS=cpu python scripts/torch_port_tube_small_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_tube_small_reference.json")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def fixed(jax, jnp):
    from _torch_port_common import jax_fixed_tube

    s, _, obj, p0 = jax_fixed_tube()
    (J, _), g = jax.jit(jax.value_and_grad(
        lambda p: obj(p, s.zero_displacement()), has_aux=True))(
            jnp.asarray(p0))
    return dict(J=float(J), dJ_dp=np.asarray(g).tolist(),
                p0=np.asarray(p0).tolist())


def fixed_slsqp(jax, jnp):
    from _torch_port_common import jax_fixed_tube
    from goldfish_tpu.design.constraints import pin_operator, regu_operator
    from goldfish_tpu.models import tube
    from goldfish_tpu.opt.problem import OptProblem

    s, ffd, obj, p0 = jax_fixed_tube()
    nx, ny, _ = ffd.shape
    P1 = pin_operator(ffd.shape, [(i, j, 0) for i in range(nx)
                                  for j in range(ny)])
    P = np.block([[P1, np.zeros_like(P1)], [np.zeros_like(P1), P1]])
    Dx = regu_operator(ffd.shape, axis=0)
    Dy = regu_operator(ffd.shape, axis=1)
    D = np.block([[Dx, np.zeros_like(Dx)], [np.zeros_like(Dy), Dy]])
    R = tube.RADIUS
    prob = OptProblem()
    prob.add_design_var("p_xy", p0, lower=p0 - 0.45 * R, upper=p0 + 0.45 * R)
    prob.set_objective(lambda dvs, d0: obj(dvs["p_xy"], d0), scaler=1.0,
                       state0=s.zero_displacement())
    prob.add_constraint("pin", lambda dvs: jnp.asarray(P) @ dvs["p_xy"],
                        equals=np.asarray(P @ p0))
    prob.add_constraint("regu", lambda dvs: jnp.asarray(D) @ dvs["p_xy"],
                        lower=1e-3)
    res = prob.run_slsqp(maxiter=2, tol=1e-14)
    return dict(nit=int(res.nit), nfev=int(res.nfev), njev=int(res.njev),
                x=np.asarray(res.x["p_xy"]).tolist(), fun=float(res.fun),
                history=[float(v) for v in res.history])


def mi(jax, jnp):
    from _torch_port_common import jax_mi_tube
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver import linalg

    s, sh, _, p_start = jax_mi_tube()
    linalg.set_mode("direct")
    try:
        forward = s.build_forward(rtol=1e-9, max_it=25)

        def J_of(p):
            cp = sh(p)
            d, _ = forward(cp, s.h_init, s.zero_displacement())
            return kl_shell.internal_energy(s.stack, d, cp, s.h_init, s.E,
                                            s.nu)

        J, g = jax.value_and_grad(J_of)(jnp.asarray(p_start))
    finally:
        linalg.set_mode(None)
    return dict(J=float(J), dJ_dp=np.asarray(g).tolist(),
                p_start=np.asarray(p_start).tolist())


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    out = {}
    for name, fn in (("fixed", fixed), ("fixed_slsqp", fixed_slsqp),
                     ("mi", mi)):
        t0 = time.perf_counter()
        out[name] = fn(jax, jnp)
        print(f"{name}: {time.perf_counter() - t0:.1f} s", flush=True)
    with open(OUT, "w") as fh:
        json.dump(out, fh)


if __name__ == "__main__":
    main()
