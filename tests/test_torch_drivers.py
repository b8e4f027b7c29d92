"""The port's optimizer drivers on the CPU: `utils.checkpoint.resume_run`
(process death and an exhausted budget, the cases of tests/test_utils.py),
`utils.profiling.Profiler`, `entry()` against the JAX package's entry, and
the flagship wing driver (demos/wing_thickness_opt) at the JAX test's size
(num_el=2, p=2, maxiter=3) against the JAX run stored in
tests/data/torch_port_drivers_reference.json
(`JAX_PLATFORMS=cpu python scripts/torch_port_drivers_reference.py`)."""

import json
import os

import numpy as np
import pytest
import torch
from _torch_port_common import record_start, rel

from goldfish_tpu_torch.opt.problem import OptProblem
from goldfish_tpu_torch.utils.checkpoint import Checkpointer, resume_run
from goldfish_tpu_torch.utils.profiling import Profiler

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_drivers_reference.json")


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)


# ------------------------------------------------------------ resume_run
def test_resume_run_survives_process_death(tmp_path):
    """A run killed after 2 accepted iterations resumes in a fresh problem
    from the last accepted iterate, the warm-start state rehydrated as a
    tensor on the problem's device and the budget reduced by the
    iterations done."""
    ckpt_path = str(tmp_path / "resume.npz")
    x_star = torch.tensor([0.3, -0.2, 0.7], dtype=torch.float64)

    def build():
        prob = OptProblem(device="cpu")
        prob.add_design_var("x", np.zeros(3), lower=-1.0, upper=1.0)

        def obj(dvs, state):
            # the state threads a stand-in warm start: an evaluation count
            return torch.sum((dvs["x"] - x_star) ** 2), state + 1.0
        prob.set_objective(obj, state0=torch.zeros((), dtype=torch.float64))
        return prob

    class Killed(RuntimeError):
        pass

    prob1 = build()
    nits = [0]

    def killer(xdict, J):
        nits[0] += 1
        if nits[0] >= 2:
            raise Killed()
    prob1.iter_callback = killer

    ck = Checkpointer(ckpt_path)
    with pytest.raises(Killed):
        resume_run(prob1, ck, maxiter=50)
    snap = ck.load()
    assert snap is not None
    design_mid, state_mid, meta = snap
    assert meta["iter"] == 2
    assert state_mid is not None and float(state_mid) > 0

    prob2 = build()
    res, done = resume_run(prob2, Checkpointer(ckpt_path), maxiter=50)
    assert done == 2
    assert np.allclose(np.asarray(prob2._dvs[0].init).ravel(),
                       design_mid["x"].ravel())
    st = prob2.state_box[0]
    assert isinstance(st, torch.Tensor) and st.device.type == "cpu"
    assert float(state_mid) <= float(st)
    assert res.success and np.allclose(res.x["x"], x_star.numpy(), atol=1e-6)
    *_, meta2 = Checkpointer(ckpt_path).load()
    assert meta2["iter"] > 2


def test_resume_run_exhausted_budget_is_restore_only(tmp_path):
    """done >= maxiter: no evaluation, the snapshot's design and its
    objective descaled by the objective scaler."""
    ckpt_path = str(tmp_path / "full.npz")
    x_done = np.array([0.1, 0.2])
    Checkpointer(ckpt_path).save({"x": x_done}, meta={"iter": 5, "J": 1.25})

    prob = OptProblem(device="cpu")
    prob.add_design_var("x", np.zeros(2))
    evals = [0]

    def obj(dvs):
        evals[0] += 1
        return torch.sum(dvs["x"] ** 2)
    prob.set_objective(obj)
    res, done = resume_run(prob, Checkpointer(ckpt_path), maxiter=5)
    assert done == 5 and evals[0] == 0
    assert res.nit == 0 and res.success
    np.testing.assert_allclose(res.x["x"], x_done)
    assert abs(res.fun - 1.25) < 1e-14

    prob_s = OptProblem(device="cpu")
    prob_s.add_design_var("x", np.zeros(2))
    prob_s.set_objective(lambda dvs: torch.sum(dvs["x"] ** 2), scaler=100.0)
    Checkpointer(str(tmp_path / "scaled.npz")).save(
        {"x": x_done}, meta={"iter": 5, "J": 100.0 * 0.25})
    res_s, done_s = resume_run(prob_s, Checkpointer(
        str(tmp_path / "scaled.npz")), maxiter=5)
    assert done_s == 5 and res_s.nit == 0
    assert abs(res_s.fun - 0.25) < 1e-12


# ------------------------------------------------------------ profiler
def test_profiler(tmp_path):
    prof = Profiler(trace_dir=str(tmp_path))
    with prof.stage("stage_a") as box:
        box[0] = torch.ones(16, dtype=torch.float64) * 2
    with prof.stage("stage_a"):
        pass
    with prof.stage("traced", trace=True):
        torch.ones(8).sum()
    s = prof.summary()
    assert "stage_a" in s and "2" in s
    assert len(prof.records["stage_a"]) == 2
    assert len(prof.traces) == 1 and os.path.exists(prof.traces[0])


# ------------------------------------------------------------ entry
def test_entry_matches_the_jax_entry(ref):
    """`entry()`'s update at the JAX entry's inputs: d = 0 and the state the
    first update gives. |r| and K v (the operator of the update) agree to
    1e-12 and 1e-10; the updates themselves to 1e-7: K's condition number
    here is ~1e12, and the JAX package's own LU solve is 2.6e-8 from an
    extended-precision solve at d = 0 (ROADMAP C15)."""
    from goldfish_tpu_torch.entry import entry
    from goldfish_tpu_torch.solver.system import assemble_K

    want = ref["entry"]
    fn, (data, cp, h, d0) = entry(device="cpu")
    assert list(cp.shape) == want["shape"] and not d0.any()
    for tag in ("zero", "step1"):
        w = want[tag]
        d = torch.tensor(w["d_in"], dtype=torch.float64).reshape(cp.shape)
        d_new, rn = fn(data, cp, h, d)
        assert abs(float(rn) - w["r_norm"]) <= 1e-12 * w["r_norm"], tag
        v = torch.tensor(w["v"], dtype=torch.float64)
        Kv = assemble_K(data, d, cp, h) @ v
        assert rel(Kv, w["Kv"]) <= 1e-10, tag
        assert rel(d_new.reshape(-1), w["d_new"]) <= 1e-7, tag


# ------------------------------------------------------------ wing driver
def test_wing_driver_against_the_jax_run(ref, tmp_path):
    """demos/wing_thickness_opt at the JAX test's size, `main(maxiter=3)`:
    the start J (1e-8) and gradient (1e-6) of the SLSQP surface as the run
    evaluates them, the
    JAX test's criteria (J lowered, checkpoint written, finite design),
    the VTK output, and the end design (1e-6) and J (1e-7) of the JAX run
    (both runs take the same SLSQP path here; their end designs differ by
    1.1e-7, which moves J by 1.8e-8, while J at the JAX end design is the
    JAX J to 1.3e-13)."""
    from goldfish_tpu_torch.demos import wing_thickness_opt as demo

    want = ref["wing_small"]
    ns = demo.setup(num_el=2, p=2, device="cpu")
    assert np.array_equal(ns.prob._x0(), np.asarray(want["x0"]))
    seen = record_start(ns.prob)
    res, _, _ = demo.main(maxiter=3, results=str(tmp_path), verbose=False,
                          ns=ns)
    assert abs(seen["J"] - want["J_start"]) <= 1e-8 * abs(want["J_start"])
    assert rel(seen["g"], want["g_start"]) <= 1e-6
    assert res.fun < res.history[0]
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(want["files"])
    assert "opt_state.npz" in files
    assert np.all(np.isfinite(res.x["h_ffd"]))
    assert (res.nit, res.nfev, res.njev) == (want["nit"], want["nfev"],
                                             want["njev"])
    assert rel(res.x["h_ffd"], want["x_end"]) <= 1e-6
    assert abs(res.fun - want["fun_end"]) <= 1e-7 * abs(want["fun_end"])
