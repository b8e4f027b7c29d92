"""The wing-sized CAD-path demos (the eVTOL wing through IGES and the
preprocessor, the curved moving-seam T-beam, the CADDEE wing) at the JAX
tests' reduced sizes against tests/data/torch_port_cad_reference.json;
the tolerances and their reasons are test_torch_cad_demos.py's."""

import os
import tempfile

import numpy as np
import pytest
import torch

from _torch_port_common import rel
from test_torch_cad_demos import _check_end, _check_start, ref  # noqa: F401


@pytest.fixture
def own_tmp(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    return tmp_path


def test_evtol_demo(ref, own_tmp):
    from goldfish_tpu_torch.demos import evtol_wing_shopt as demo

    want = ref["evtol_small"]
    kw = dict(want["kw"])
    maxiter = kw.pop("maxiter")
    ns = demo.setup(**kw, verbose=False, device="cpu")
    assert os.path.exists(own_tmp / "evtol_wing.igs")
    _check_start(ns.prob, want["start"], tol_J=1e-6, tol_g=1e-2)
    res = demo.setup(**kw, verbose=False, device="cpu").prob.run_slsqp(
        maxiter=maxiter, tol=1e-12)
    _check_end(res, want["run"], tol=1e-3)


def test_curved_mi_demo(ref):
    from goldfish_tpu_torch.demos import shape_opt_mint_tbeam_curved as demo

    want = ref["curved_small"]
    kw = dict(want["kw"])
    maxiter = kw.pop("maxiter")
    ns = demo.setup(**kw, device="cpu")
    _check_start(ns.prob, want["start"])
    res = demo.setup(**kw, device="cpu").prob.run_slsqp(maxiter=maxiter,
                                                       tol=1e-14)
    _check_end(res, want["run"])


def test_caddee_demo(ref, own_tmp):
    from goldfish_tpu_torch.demos import caddee_aeroelastic_wing as demo

    want = ref["caddee_small"]
    J0, tip, gh, model = demo.main(**want["kw"], verbose=False,
                                   device="cpu")
    assert np.isfinite(J0) and J0 > 0
    assert abs(J0 - want["J0"]) <= 1e-8 * want["J0"]
    assert rel(tip, want["tip"]) <= 1e-8
    assert rel(gh, want["gh"]) <= 1e-6
    assert model.preprocessor.num_intersections == want["num_intersections"]
    assert os.path.exists(own_tmp / "boxwing_int_data.npz")
    assert isinstance(gh, torch.Tensor)
