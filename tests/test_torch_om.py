"""The OpenMDAO adapter layer of the port (its own `om_shim`, the
`om_comps` components and the two plate demos) against the JAX package's:

- the sibling demo's graph (goldfish_tpu_torch/demos/
  om_plate_var_th_opt_wint.py at num_el=2, ffd (3, 2, 1), as
  tests/test_om_adapters.py builds it): `run_model` values 1e-10 against
  the JAX graph, `check_partials` clean (the JAX test's bars), and
  `compute_totals` of w_int and the volume w.r.t. the thickness FFD 1e-6;
- the stress demo (plate_var_th_opt_stress.py): sigma0 and sigma_allow of
  `build_problem(num_el=3)` 1e-8 against the JAX demo's, and 3 SLSQP
  iterations that lower the volume; its full `main` (30 iterations, the
  demo's three assertions) is slow-marked, as its JAX twin is.

CPU runs launch no kernel."""

import numpy as np
import pytest

from _torch_port_common import rel

SIBLING = dict(num_el=2, p=2, num_patches=2, ffd_els=(3, 2, 1), maxiter=4)
FFD = "inputs_comp.thickness_FFD"


@pytest.fixture(scope="module")
def sibling():
    from demos.om_plate_var_th_opt_wint import build_problem as jax_build
    from goldfish_tpu_torch.demos.om_plate_var_th_opt_wint import (
        build_problem,
    )

    jprob = jax_build(**SIBLING)[0]
    jprob.run_model()
    prob = build_problem(**SIBLING, device="cpu")[0]
    prob.run_model()
    return jprob, prob


def test_sibling_graph_values_match_jax(sibling):
    from goldfish_tpu_torch import _cuda

    jprob, prob = sibling
    for path in ("int_energy_comp.w_int", "volume_comp.volume",
                 "disp_states_comp.displacements",
                 "h_th_fe2iga_comp.thickness_IGA"):
        assert rel(prob[path], jprob[path]) <= 1e-10, path
    assert all(n == 0 for n in _cuda.launch_counts.values())


def test_sibling_check_partials_clean(sibling):
    _, prob = sibling
    report = prob.check_partials(compact_print=False, step=1e-7)
    checked = 0
    for comp, pairs in report.items():
        for key, entry in pairs.items():
            if np.linalg.norm(entry["J_fd"]) < 1e-14:  # zero blocks
                assert entry["abs error"] < 1e-8, (comp, key)
                continue
            checked += 1
            assert entry["rel error"] < 5e-5, (comp, key,
                                               entry["rel error"])
    assert checked


def test_sibling_totals_match_jax(sibling):
    jprob, prob = sibling
    of = ["int_energy_comp.w_int", "volume_comp.volume"]
    tot = prob.compute_totals(of, [FFD])
    ref = jprob.compute_totals(of, [FFD])
    for key in ref:
        assert rel(tot[key], ref[key]) <= 1e-6, key


@pytest.fixture(scope="module")
def stress_problem():
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    return demo.build_problem(num_el=3, maxiter=3, device="cpu")


def test_stress_demo_allowable_matches_jax(stress_problem):
    from demos import plate_var_th_opt_stress as jax_demo

    _, _, _, sigma_allow, sigma0 = stress_problem
    _, _, _, ref_allow, ref0 = jax_demo.build_problem(num_el=3, maxiter=3)
    assert abs(sigma0 - ref0) <= 1e-8 * ref0
    assert abs(sigma_allow - ref_allow) <= 1e-8 * ref_allow


def test_stress_demo_slsqp_lowers_the_volume(stress_problem):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    prob, _, _, sigma_allow, _ = stress_problem
    _cuda.reset_launch_counts()
    out = demo.run(prob)
    assert out.result.nit == 3
    assert out.V1 < out.V0 and np.isfinite(out.s1)
    assert len(out.log.jac_wall) == out.result.njev
    assert len(out.log.evaluations) >= out.result.nfev
    assert all(n == 0 for n in _cuda.launch_counts.values())


@pytest.mark.slow
def test_stress_demo_main_runs():
    from goldfish_tpu_torch.demos import plate_var_th_opt_stress as demo

    demo.main(num_el=3, maxiter=30, device="cpu")
