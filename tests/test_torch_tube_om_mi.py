"""The 4-patch moving-seam tube with multi-block FFD through the OpenMDAO
graph in the port (`demos/tube_shopt_mi_4patch_wffd.py`: z-aligned
multi-block FFD, pin and regularization rows, the KS bounds on the free
xi), against the JAX package's numbers in
tests/data/torch_port_om_mi_5b_reference.json
(scripts/torch_port_om_mi_5b_reference.py, part "tube_small"), on the CPU,
at the JAX test's size (num_el=2, maxiter 3) and 5e2 Pa:

- the start: J (1e-8), the designs (1e-14) and the totals of J w.r.t.
  both design fields (1e-6) against the JAX package's;
- SLSQP: every free xi in (0, 1) and J lower (the JAX test's criteria,
  tests/test_demos.py::test_tube_shopt_mi_4patch_wffd_demo_reduced), and
  the end state the graph's own: a fresh graph evaluated cold at the end
  design gives the same J (1e-8).

The end of the JAX run is not compared: at its third trial design the
JAX package's warm-started MI Newton reaches another equilibrium (J 28.0;
a cold solve there gives 0.12536 in both packages, the port's warm solve
too), and its iterates part from there (ROADMAP C11;
scripts/torch_port_tube_om_mi_parting.py records both runs). At the demo's
2e4 Pa the two packages already part at the first trial design (J 2.03e3
against 1.59e4, designs 1.3e-5 apart); 5e2 Pa is the pressure of the
port's other small tube tests.

CPU runs launch no kernel."""

import json
import os

import numpy as np

import _torch_port_common  # noqa: F401  (one CPU torch thread)
from _torch_port_common import rel

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_om_mi_5b_reference.json")
J = "internal_energy_comp.int_E"
X = ("inputs_comp.CP_design_FFD0", "inputs_comp.CP_design_FFD1")


def _problem(want):
    from goldfish_tpu_torch.demos.tube_shopt_mi_4patch_wffd import (
        build_problem,
    )

    return build_problem(num_el=want["num_el"], p=want["p"],
                         maxiter=want["maxiter"], pressure=want["pressure"],
                         device="cpu")[0]


def test_tube_4patch_reduced():
    with open(REF) as fh:
        want = json.load(fh)["tube_small"]
    prob = _problem(want)
    prob.run_model()
    J0 = float(np.asarray(prob[J]).ravel()[0])
    assert abs(J0 - want["J0"]) <= 1e-8 * want["J0"]
    for x, w in zip(X, want["x0"]):
        assert np.abs(prob[x] - np.asarray(w)).max() <= 1e-14
    tot = prob.compute_totals([J], list(X))
    for x, w in zip(X, want["dJ_dx"]):
        assert rel(tot[(J, x)].ravel(), w) <= 1e-6, x

    prob.run_driver()
    J1 = float(np.asarray(prob[J]).ravel()[0])
    xi = np.asarray(prob["cpiga2xi_comp.int_para"]).ravel()
    free = xi[prob.model.xi_free]
    assert free.min() > 0.0 and free.max() < 1.0
    assert J1 < J0

    cold = _problem(want)
    for x in X:
        cold[x] = np.asarray(prob[x]).copy()
    cold.run_model()
    assert abs(float(np.asarray(cold[J]).ravel()[0]) - J1) <= 1e-8 * J1
