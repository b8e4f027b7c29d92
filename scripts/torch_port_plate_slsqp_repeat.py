"""How often the plate's SLSQP runs to its iteration limit, on the GPU, and
where two runs part.

ROADMAP Queue C2: the stress-constrained plate sizing
(goldfish_tpu_torch/demos/plate_var_th_opt_stress.py at num_el=32, the size
of chip_smoke.py's phase 11) stops after 11 SLSQP iterations in some runs
and runs to its 30-iteration limit in others, the runs differing only in
the rounding order of the f64-atomic kernels. This script repeats the
demo's SLSQP `--runs` times in one process (a fresh problem each time) and
prints each run's iterations, evaluations, end volume (and its distance
from the JAX package's end volume in
tests/data/torch_port_plate32_reference.json), the demo's three
assertions, the wall and the median host walls of its fun and jac
evaluations (as chip_smoke.py phase 11 prints them), so that two trees can
be compared in one chip call: `--root` names
the tree whose `goldfish_tpu_torch` is imported (default: this checkout),
e.g. a `git archive` of the parent commit unpacked into a gitignored
directory.

`--trace FILE` also records, for every model evaluation, the bits of the
design x, the volume and the KS stress (float.hex), and for every
derivative evaluation those of each total (d volume/dx, d sigma_KS/dx),
each beside the solver's decisions in that evaluation (Newton iterations,
factorizations, iterative-refinement sweeps), writes every run's record
to FILE (JSON) and prints, for each run against the first, the first
evaluation and the first quantity whose bits differ, with the largest
relative difference of that quantity there.

    python scripts/torch_port_plate_slsqp_repeat.py [--runs 4] [--root DIR]
        [--trace c2_trace.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bits(a):
    return [float(v).hex() for v in np.asarray(a, dtype=np.float64).ravel()]


def trace(prob, demo):
    """Wrap the model and derivative evaluations of `prob` to append, per
    evaluation, the bits of what it returned to the returned list, and
    beside them (not compared) the solver's decisions in it: the forward
    Newton iterations, the factorizations so far and the new entries of
    the factor's iterative-refinement log (tag, IR sweeps, ratio)."""
    events = []
    run_model, compute_totals = prob.run_model, prob.compute_totals
    op = prob.model._subs["disp_states_comp"].op
    seen = [0]

    def decisions():
        cert = op.factor.cert_log[seen[0]:]
        seen[0] = len(op.factor.cert_log)
        return {"newton_its": op.solver.last_its,
                "n_factor": op.factor.n_factor,
                "ir": [[t, int(n), float(r)] for t, n, r in cert]}

    def traced_run_model():
        run_model()
        events.append({"what": "fun", "x": bits(prob[demo.FFD]),
                       "volume": bits(prob[demo.VOL]),
                       "sigma_ks": bits(prob[demo.SIG]),
                       "solver": decisions()})

    def traced_compute_totals(*args, **kwargs):
        out = compute_totals(*args, **kwargs)
        ev = {"what": "jac", "solver": decisions()}
        for (of, wrt), v in out.items():
            if of in (demo.VOL, demo.SIG) and wrt == demo.FFD:
                ev["d" + ("volume" if of == demo.VOL else "sigma_ks")] = \
                    bits(v)
        events.append(ev)
        return out

    prob.run_model = traced_run_model
    prob.compute_totals = traced_compute_totals
    return events


def first_parting(a, b):
    """(event index, kind, quantity, largest relative difference) of the
    first quantity whose bits differ between two runs' events, or None."""
    for k, (ea, eb) in enumerate(zip(a, b)):
        for key in ea:
            if key in ("what", "solver") or ea[key] == eb.get(key):
                continue
            va = np.array([float.fromhex(v) for v in ea[key]])
            vb = np.array([float.fromhex(v) for v in eb[key]])
            den = max(np.abs(va).max(), 1e-300)
            return k, ea["what"], key, float(np.abs(va - vb).max() / den)
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script needs one GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    with open(os.path.join(ROOT, "tests", "data",
                           "torch_port_plate32_reference.json")) as fh:
        v_ref = json.load(fh)["slsqp"]["volume_end"]
    dev = torch.device("cuda", 0)
    rows, traces = [], []
    for k in range(args.runs):
        prob, _, _, sigma_allow, _ = demo.build_problem(
            num_el=32, maxiter=30, device=dev)
        if args.trace:
            traces.append(trace(prob, demo))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = demo.run(prob)
        torch.cuda.synchronize()
        res = out.result
        rows.append({"run": k, "nit": int(res.nit), "nfev": int(res.nfev),
                     "njev": int(res.njev), "volume_end": float(out.V1),
                     "volume_rel_jax": abs(out.V1 - v_ref) / v_ref,
                     "assertions": bool(out.V1 < out.V0
                                        and out.s1 <= 1.02 * sigma_allow
                                        and out.s1 >= 0.95 * sigma_allow),
                     "seconds": time.perf_counter() - t0,
                     "fun_median": float(np.median(out.log.fun_wall)),
                     "jac_median": float(np.median(out.log.jac_wall))})
        print(json.dumps(rows[-1]), flush=True)
    if args.trace:
        for k in range(1, len(traces)):
            part = first_parting(traces[0], traces[k])
            n_fun = sum(e["what"] == "fun" for e in traces[0][:part[0] + 1]) \
                if part else None
            print(json.dumps({"trace": f"run {k} vs run 0",
                              "nit": [rows[0]["nit"], rows[k]["nit"]],
                              "first_parting": part,
                              "model_evaluations_to_there": n_fun}),
                  flush=True)
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        with open(args.trace, "w") as fh:
            json.dump({"runs": rows, "events": traces}, fh)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "nit": [r["nit"] for r in rows],
                      "volume_rel_jax_max": max(r["volume_rel_jax"]
                                                for r in rows),
                      "assertions": all(r["assertions"] for r in rows)}))


if __name__ == "__main__":
    main()
