"""The Newton stop test of the port's persistent-factor solves
(`goldfish_tpu_torch/solver/implicit.py`, ROADMAP C2 and C10), on the CPU.

A converged solve takes one more full Newton step after its stop test
passes (`implicit._polish`), so a warm solve no longer ends just under its
threshold: with an inexact-Newton step (forcing 1e-3) the residual it
returns sits about 1e-3 of the threshold below it. Without the step the
warm solves of these sequences ended anywhere in (1e-3, 1) of the
threshold, so which side of the test rounding put |r| decided the state
an optimizer saw (C2), and finite differences of the design saw the
stopping error (C10; `test_torch_om_mi.py::
test_demo_check_partials_and_totals` holds the JAX test's step of 1e-6).

The tolerance rtol = 1e-5 keeps the threshold far above the residual
floor of these small models (~1e-8 of |r(0)|), where |r| shows the step.
CPU runs launch no kernel."""

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (one CPU torch thread)

RTOL = 1e-5


def _warm_sequence(solve, shared, h0, n=8, seed=0, step=1e-3):
    """Warm solves at h0 (1 + step v) for seeded v: |r| / (rtol |r(0)|)
    of each, from the solver's own last residual."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = torch.tensor(rng.uniform(-1.0, 1.0, size=tuple(h0.shape)))
        rn = solve(h0 * (1.0 + step * v))
        out.append(rn / (RTOL * shared["r_ref"]))
    return out


def test_plate_warm_solves_end_well_below_threshold():
    from goldfish_tpu_torch.models import plate
    from goldfish_tpu_torch.solver import implicit

    sys_ = plate.build(num_el=3, p=2, device="cpu")
    solver = implicit._Solver(sys_.data, RTOL, 1e-14, 30)
    state = {"d": solver.solve(sys_.cp, sys_.h_init,
                               sys_.zero_displacement())}

    def solve(h):
        d, its, rn = implicit.newton_solve_host(
            sys_.data, solver.factor, sys_.cp, h, state["d"], rtol=RTOL,
            shared=solver.shared)
        assert 1 <= its < 30
        state["d"] = d
        return rn

    ratios = _warm_sequence(solve, solver.shared, sys_.h_init)
    assert max(ratios) <= 1e-2, ratios


def test_mi_warm_solves_end_well_below_threshold():
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.solver.system_mi import newton_solve_mi_host

    sys_ = tbeam.build_mi(num_el=3, p=2, n_pts=7, device="cpu")
    xi = sys_.c2x.solve(sys_.cp)
    shared = {}
    fac = None
    state = {"d": sys_.zero_displacement()}

    def solve(h):
        nonlocal fac
        from goldfish_tpu_torch.solver.system_mi import (
            PersistentDeviceFactorMI,
        )

        fac = fac or PersistentDeviceFactorMI(*sys_.mi_args)
        d, its, rn = newton_solve_mi_host(
            *sys_.mi_args, sys_.cp, h, xi, state["d"], rtol=RTOL,
            device_fac=fac, shared=shared)
        assert its < 30
        state["d"] = d
        return rn

    solve(sys_.h_init)
    ratios = _warm_sequence(solve, shared, sys_.h_init)
    assert max(ratios) <= 1e-2, ratios


@pytest.mark.parametrize("growth", [1.0, 4.0])
def test_polish_keeps_a_step_at_the_floor(growth, monkeypatch):
    """At the residual floor the polishing step's |r| may be larger than
    the one it starts from (roundoff), and the step is still kept up to
    `POLISH_GROWTH` times; a step that grows |r| more is a failed one and
    is dropped."""
    from goldfish_tpu_torch.solver import implicit

    d = torch.zeros(4, dtype=torch.float64)
    r = torch.ones(4, dtype=torch.float64)

    def trial(data, cp, h, d_, delta, alpha):
        return d_ + delta, growth * r, torch.tensor(growth * 2.0), None

    monkeypatch.setattr(implicit, "_trial", trial)
    direction = lambda d_, r_, slow: (torch.full_like(d_, 0.5), -1.0)
    d_new, _, rn = implicit._polish(None, None, None, d, r, 2.0, direction,
                                    False)
    assert torch.equal(d_new, torch.full_like(d, 0.5)) and rn == growth * 2
    monkeypatch.setattr(implicit, "POLISH_GROWTH", 2.0)
    d_new, _, rn = implicit._polish(None, None, None, d, r, 2.0, direction,
                                    False)
    assert torch.equal(d_new, d if growth > 2.0 else torch.full_like(d, .5))
