"""Reference numbers for the PyTorch port's stress-constrained plate sizing.

Runs demos/plate_var_th_opt_stress.py at num_el=32 (2 patches of degree 2,
1190 CPs each, N = 7140 padded dofs, 19,008 quadrature points) with the JAX
package on the CPU in float64, direct linear-solver mode, through its own
OpenMDAO graph (om_shim when OpenMDAO is absent), and writes
tests/data/torch_port_plate32_reference.json:

- the start: h_ffd0 (36 thickness FFD coefficients), the KS stress sigma0
  at rho = 100 (the demo's `build_problem`), the graph's volume and KS
  stress after `run_model`, and the largest top-surface von Mises stress m
  over the real quadrature points;
- totals through the graph (`compute_totals`): d(volume)/dh_ffd, and
  dsigma_KS/dh_ffd with the stress component's rho set to 50/m. At the
  demo's dimensional rho = 100 (1/Pa) the KS weights resolve differences
  of ~0.05 Pa in a ~6e6 Pa field, below what two correct solvers agree to
  on the plate's mirror-symmetric twin maxima; at rho * m = 50 they do not;
- the demo's SLSQP (`run_driver`, maxiter 30): volume and KS stress at
  every model evaluation, nit/nfev/njev, the end point, and which of the
  demo's three assertions (lighter; stress <= 1.02 sigma_allow; stress >=
  0.95 sigma_allow) hold at this size;
- the sibling demo (demos/om_plate_var_th_opt_wint.py, minimum W_int at
  constant volume) at the same size: w_int after `run_model` and the totals
  of w_int and the volume w.r.t. its thickness FFD.

The machine with the GPU has no JAX, so `chip_smoke.py` checks the port
against this file.

    JAX_PLATFORMS=cpu python scripts/torch_port_plate_reference.py
        [--sibling]

The cold part is written first, then the SLSQP part and the sibling part as
each ends; `--sibling` reruns only the sibling part into the existing file.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_plate32_reference.json")
NUM_EL, MAXITER = 32, 30
FFD = "inputs_comp.thickness_FFD"
VOL = "volume_comp.volume"
SIG = "max_vmstress_comp.max_vmstress"
DISP = "disp_states_comp.displacements"


def _write(out):
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")


def sibling_part():
    """w_int and its totals through the sibling demo's graph."""
    from demos import om_plate_var_th_opt_wint as demo

    t0 = time.perf_counter()
    prob = demo.build_problem(num_el=NUM_EL)[0]
    prob.run_model()
    w, vol = "int_energy_comp.w_int", VOL
    tot = prob.compute_totals([w, vol], [FFD])
    return dict(num_el=NUM_EL, w_int=float(prob[w][0]),
                volume=float(prob[vol][0]),
                dw_int_dh_ffd=np.asarray(tot[(w, FFD)]).ravel().tolist(),
                dvolume_dh_ffd=np.asarray(tot[(vol, FFD)]).ravel().tolist(),
                seconds=time.perf_counter() - t0)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from demos import plate_var_th_opt_stress as demo
    from goldfish_tpu.operations.exops import MaxvMStressExOperation
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver import linalg

    linalg.set_mode("direct")
    if "--sibling" in sys.argv[1:]:
        with open(OUT) as fh:
            out = json.load(fh)
        out["sibling"] = sibling_part()
        _write(out)
        print(f"sibling: {out['sibling']['w_int']!r} -> {OUT}")
        return
    out = {"num_el": NUM_EL, "p": 2, "num_patches": 2, "maxiter": MAXITER,
           "solver_mode": "direct", "platform": "cpu", "dtype": "float64",
           "jax_version": jax.__version__}
    try:
        out["commit"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True,
            text=True, check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        out["commit"] = None

    t0 = time.perf_counter()
    prob, sys_, th, sigma_allow, sigma0 = demo.build_problem(
        num_el=NUM_EL, maxiter=MAXITER)
    prob.run_model()
    lay = th.layout
    d = lay.to_padded(jnp.asarray(prob[DISP]).reshape(-1, 3))
    h = lay.to_padded(jnp.asarray(prob["h_th_fe2iga_comp.thickness_IGA"]))
    s = np.asarray(kl_shell.qp_stress_vm(sys_.stack, d, sys_.cp, h, sys_.E,
                                         sys_.nu, through="top"))
    m = float(s[np.asarray(sys_.stack.wq) > 0].max())
    out.update(
        h_ffd0=np.asarray(prob[FFD]).tolist(), sigma0=float(sigma0),
        sigma_allow=float(sigma_allow), volume=float(prob[VOL][0]),
        sigma_ks=float(prob[SIG][0]), m=m, rho_grad=50.0 / m,
        d_norm=float(np.linalg.norm(np.asarray(prob[DISP]))),
        n_dofs=int(np.asarray(sys_.cp).size), n_design=int(th.n_ffd))
    tot = prob.compute_totals([VOL], [FFD])
    out["dvolume_dh_ffd"] = np.asarray(tot[(VOL, FFD)]).ravel().tolist()
    comp = prob.model._subs["max_vmstress_comp"]
    op100 = comp.op
    comp.op = MaxvMStressExOperation(sys_, rho=50.0 / m, through="top")
    prob.run_model()
    out["sigma_ks_rho_grad"] = float(prob[SIG][0])
    tot = prob.compute_totals([SIG], [FFD])
    out["dsigma_dh_ffd"] = np.asarray(tot[(SIG, FFD)]).ravel().tolist()
    comp.op = op100
    out["cold_seconds"] = time.perf_counter() - t0
    print(f"cold: sigma0 {sigma0!r} volume {out['volume']!r} m {m!r} "
          f"|dsigma/dh_ffd| {np.linalg.norm(out['dsigma_dh_ffd'])!r} "
          f"({out['cold_seconds']:.1f} s)", flush=True)
    _write(out)

    t0 = time.perf_counter()
    hist = []
    run_model = prob.run_model

    def recording_run_model():
        run_model()
        hist.append((float(prob[VOL][0]), float(prob[SIG][0])))

    prob.run_model = recording_run_model
    prob.run_model()
    V0 = hist[0][0]
    prob.run_driver()
    res = prob._driver_result
    V1, s1 = hist[-1]
    out["slsqp"] = dict(
        nit=int(res.nit), nfev=int(res.nfev), njev=int(res.njev),
        message=str(res.message), volume_end=V1, sigma_end=s1,
        h_ffd_end=np.asarray(prob[FFD]).tolist(),
        evaluations=[list(e) for e in hist[1:]],
        assertions={"lighter": V1 < V0,
                    "stress_le_1.02_allow": s1 <= 1.02 * sigma_allow,
                    "stress_ge_0.95_allow": s1 >= 0.95 * sigma_allow},
        seconds=time.perf_counter() - t0)
    print(f"slsqp: volume {V0!r} -> {V1!r}, KS stress {s1!r} (allowable "
          f"{sigma_allow!r}), nit {res.nit} nfev {res.nfev} njev "
          f"{res.njev}, {out['slsqp']['assertions']} "
          f"({out['slsqp']['seconds']:.1f} s)", flush=True)
    _write(out)
    out["sibling"] = sibling_part()
    _write(out)
    print(f"-> {OUT}")


if __name__ == "__main__":
    main()
