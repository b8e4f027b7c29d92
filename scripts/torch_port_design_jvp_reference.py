"""Reference numbers for the port's forward design tangents (JAX, CPU, f64).

The JAX package's `jax.jvp` of its residuals at the seeded states of
tests/test_torch_design_jvp.py (tests/_torch_port_common.py: the small
wing's `seeded_state(0)`, the small pressurized tube's `seeded_state(0,
jax_tube())`, the OpenMDAO MI T-beam at num_el=3 `om_mi_design_state`;
tangents `design_tangents`):

- `k1`: the jvp in (cp, h) of jax.grad(internal_energy) in d (small wing);
- `k2`: the same of jax.grad(penalty_energy) (small wing);
- `pressure`: the jvp in cp of -jax.grad(follower_pressure_work) in d
  (small tube);
- `residual_wing`, `residual_tube`: the jvp of system.residual in (cp, h);
- `k6`: the jvp in xi of system_mi.residual_mi (OM MI T-beam);
- `k7`: the jvp in cp of cpiga2xi._c2x_res (OM MI T-beam);
- `residual_mi`: the jvp of residual_mi in (cp, h, xi);
- `inputs`: the norm of every input, so that the test sees the same state.

tests/test_torch_design_jvp.py holds the port against
tests/data/torch_port_design_jvp_reference.json instead of recomputing
these with the JAX package on every run (~70 s of JAX tracing there).

    JAX_PLATFORMS=cpu python scripts/torch_port_design_jvp_reference.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data",
                   "torch_port_design_jvp_reference.json")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def flat(a):
    return np.asarray(a, dtype=np.float64).ravel().tolist()


def main():
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_enable_x64", True)
    from _torch_port_common import (
        OM_MI_SMALL,
        design_tangents,
        jax_tube,
        jax_wing,
        om_mi_design_state,
        seeded_state,
    )
    from demos.om_tbeam_shopt_mi import build_mi_tbeam
    from goldfish_tpu.geometry.cpiga2xi import _c2x_res
    from goldfish_tpu.physics import coupling, kl_shell, loads
    from goldfish_tpu.solver import system
    from goldfish_tpu.solver.system_mi import residual_mi

    t0 = time.perf_counter()
    out, inputs = {}, {}
    s = jax_wing()
    cp, h, d, _, _ = seeded_state(0)
    tcp, th = design_tangents(cp, h, 10)
    inputs["wing"] = [float(np.linalg.norm(a)) for a in (cp, h, d, tcp, th)]
    g1 = jax.grad(kl_shell.internal_energy, argnums=1)
    out["k1"] = jax.jvp(lambda c, hh: g1(s.stack, d, c, hh, s.E, s.nu),
                        (cp, h), (tcp, th))[1]
    g2 = jax.grad(coupling.penalty_energy, argnums=1)
    out["k2"] = jax.jvp(lambda c, hh: g2(s.data.ifs, d, c, hh, s.E),
                        (cp, h), (tcp, th))[1]
    out["residual_wing"] = jax.jvp(
        lambda c, hh: system.residual(s.data, d, c, hh), (cp, h),
        (tcp, th))[1]

    s = jax_tube()
    cp, h, d, _, _ = seeded_state(0, s)
    tcp, th = design_tangents(cp, h, 11)
    inputs["tube"] = [float(np.linalg.norm(a)) for a in (cp, h, d, tcp, th)]
    gp = jax.grad(loads.follower_pressure_work, argnums=1)
    out["pressure"] = jax.jvp(
        lambda c: -gp(s.stack, d, c, s.data.pressure), (cp,), (tcp,))[1]
    out["residual_tube"] = jax.jvp(
        lambda c, hh: system.residual(s.data, d, c, hh), (cp, h),
        (tcp, th))[1]

    s = build_mi_tbeam(**OM_MI_SMALL)
    cp, h, xi, d, tcp, th, txi = om_mi_design_state(s)
    inputs["om_mi"] = [float(np.linalg.norm(a))
                       for a in (cp, h, xi, d, tcp, th, txi)]

    def res(c, hh, x):
        return residual_mi(s.data, s.mi, s.co, s.ss, s.pdeg, s.qdeg, d, c,
                           hh, x)

    z = np.zeros_like
    out["k6"] = jax.jvp(res, (cp, h, xi), (z(cp), z(h), txi))[1]
    out["residual_mi"] = jax.jvp(res, (cp, h, xi), (tcp, th, txi))[1]
    c2x = s.c2x
    out["k7"] = jax.jvp(lambda c: _c2x_res.__wrapped__(
        c2x.ss, c2x.mi, c, xi, p=c2x.p, q=c2x.q), (cp,), (tcp,))[1]

    doc = {k: flat(v) for k, v in out.items()}
    doc["inputs"] = inputs
    doc["seconds"] = time.perf_counter() - t0
    with open(OUT, "w") as fh:
        json.dump(doc, fh)
    print(f"wrote {OUT} in {doc['seconds']:.1f} s")


if __name__ == "__main__":
    main()
