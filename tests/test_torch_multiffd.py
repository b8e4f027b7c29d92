"""Multi-block FFD maps of the port (`design/pipeline.py`:
`MultiThicknessFFD`, `MultiShapeFFD`) and `design/constraints.py`'s
`align_expansion_operator`, on the CPU:

- the JAX tests' criteria (tests/test_multiffd.py): partition of unity
  and block independence of the thickness map, the shape map reproducing
  the geometry at its initial design;
- the maps on seeded designs and the expansion operators equal to the JAX
  package's to 1e-14, from tests/data/torch_port_om_mi_5b_reference.json
  (scripts/torch_port_om_mi_5b_reference.py, part "maps").

CPU runs launch no kernel."""

import json
import os

import numpy as np
import pytest
import torch

import _torch_port_common  # noqa: F401  (one CPU torch thread)

REF = os.path.join(os.path.dirname(__file__), "data",
                   "torch_port_om_mi_5b_reference.json")
THICK_GROUPS = [dict(patches=[0, 1], num_els=(2, 1, 1), p=(2, 1, 1)),
                dict(patches=[2, 3], num_els=(1, 1, 1), p=(1, 1, 1))]
SHAPE_GROUPS = [dict(patches=[0, 1], num_els=(2, 1, 1), p=(2, 1, 1)),
                dict(patches=[2, 3], num_els=(2, 1, 1), p=(2, 1, 1))]


@pytest.fixture(scope="module")
def ref():
    with open(REF) as fh:
        return json.load(fh)["maps"]


@pytest.fixture(scope="module")
def plate4():
    from goldfish_tpu_torch.models import plate

    return plate.build(num_el=3, p=2, num_patches=4, device="cpu")


def test_multi_thickness_partition_of_unity(plate4):
    from goldfish_tpu_torch.design.pipeline import MultiThicknessFFD
    from goldfish_tpu_torch.models import plate

    s = plate4
    th = MultiThicknessFFD(s, THICK_GROUPS)
    h = th(torch.tensor(th.init_h_ffd(plate.H_TH), dtype=torch.float64))
    mask = s.stack.cp_mask
    assert float(((h - plate.H_TH) * mask).abs().max()) < 1e-12
    # block independence: block 1 alone moves patches 2 and 3 only
    x = th.init_h_ffd(plate.H_TH)
    x[th.offsets[1]:] *= 2.0
    h2 = th(torch.tensor(x, dtype=torch.float64))
    assert torch.allclose(h2[:2], h[:2])
    assert float((h2[2:] * mask[2:]).max()) > 1.9 * plate.H_TH


def test_multi_shape_reproduces_geometry(plate4):
    from goldfish_tpu_torch.design.pipeline import MultiShapeFFD

    s = plate4
    sh = MultiShapeFFD(s, SHAPE_GROUPS, opt_fields=(2,))
    cp = sh(torch.tensor(sh.init_p_ffd(), dtype=torch.float64))
    err = float(((cp - s.cp) * s.stack.cp_mask[..., None]).abs().max())
    assert err < 1e-9


def test_multi_thickness_matches_jax(plate4, ref):
    from goldfish_tpu_torch.design.pipeline import MultiThicknessFFD

    th = MultiThicknessFFD(plate4, THICK_GROUPS)
    assert th.sizes == ref["thick_sizes"]
    got = th(torch.tensor(ref["thick_x"], dtype=torch.float64)).numpy()
    assert np.abs(got - np.asarray(ref["thick"])).max() <= 1e-14


@pytest.mark.parametrize("fields", [(2,), (0, 1)])
def test_multi_shape_matches_jax(plate4, ref, fields):
    from goldfish_tpu_torch.design.pipeline import MultiShapeFFD

    sh = MultiShapeFFD(plate4, SHAPE_GROUPS, opt_fields=fields)
    key = "shape_" + "".join(map(str, fields))
    assert np.abs(sh.init_p_ffd() - np.asarray(ref[key + "_x0"])).max() \
        <= 1e-14
    x = torch.tensor(ref[key + "_x"], dtype=torch.float64,
                     requires_grad=True)
    cp = sh(x)
    assert np.abs(cp.detach().numpy() - np.asarray(ref[key])).max() <= 1e-14
    # the map is linear in x: its pullback is the blocks' F^T on their rows
    g = torch.autograd.grad(cp.sum(), x)[0]
    want = np.concatenate([F.sum(0).numpy() for F in sh.Fs
                           for _ in sh.opt_fields])
    assert np.abs(g.numpy() - want).max() <= 1e-14


@pytest.mark.parametrize("case", range(3))
def test_align_expansion_operator_matches_jax(ref, case):
    from goldfish_tpu_torch.design.constraints import (
        align_expansion_operator,
    )

    want = ref["align"][case]
    axis = want["axis"]
    A, reps = align_expansion_operator(
        tuple(want["shape"]), tuple(axis) if isinstance(axis, list)
        else axis)
    assert np.array_equal(A, np.asarray(want["A"]))
    assert reps.tolist() == want["reps"]
    # every full dof belongs to exactly one design column, its rep's
    assert np.array_equal(A.sum(1), np.ones(A.shape[0]))
    assert np.array_equal(A[reps], np.eye(A.shape[1]))
