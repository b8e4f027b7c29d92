"""The port's copied host builders reproduce the JAX package's arrays bit
for bit, and importing the port pulls in no JAX."""

import subprocess
import sys

import numpy as np
import pytest

from _torch_port_common import (
    FFD_SMALL,
    PRESSURE,
    TUBE_SMALL,
    WING_SMALL,
    jax_plate,
    jax_tube,
    jax_wing,
    port_plate,
)

TIP = (0.0, 0.0, 50.0)


@pytest.fixture(scope="module")
def port_wing():
    from goldfish_tpu_torch.models import wing

    return wing.build(**WING_SMALL, device="cpu")


def _same(a, b):
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    b = np.asarray(b)
    return a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("field", ["R00", "R10", "R01", "R20", "R11", "R02",
                                   "conn", "wq", "cp_mask"])
def test_patch_stack_bit_identical(port_wing, field):
    assert _same(getattr(port_wing.stack, field),
                 getattr(jax_wing().stack, field))


def test_interface_stack_bit_identical(port_wing):
    j = jax_wing().ifs
    for field in j._fields:
        assert _same(getattr(port_wing.ifs, field), getattr(j, field)), field


def test_system_arrays_bit_identical(port_wing):
    j = jax_wing()
    for name in ("cp", "h_init", "E", "nu"):
        assert _same(getattr(port_wing, name), getattr(j, name)), name
    assert _same(port_wing.data.free, j.data.free)
    assert _same(port_wing.data.f_areal, j.data.f_areal)


def test_thickness_ffd_matrix_bit_identical(port_wing):
    import torch

    from goldfish_tpu.design.pipeline import ThicknessFFD as JaxTFFD
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD

    jt = JaxTFFD(jax_wing(), **FFD_SMALL)
    pt = ThicknessFFD(port_wing, **FFD_SMALL)
    assert _same(pt.F, jt.F)
    # the map itself is a matvec: equal to roundoff (different BLAS)
    h = np.random.default_rng(3).normal(size=pt.n_ffd)
    a, b = pt(torch.from_numpy(h)).numpy(), np.asarray(jt(h))
    assert np.linalg.norm(a - b) <= 1e-14 * np.linalg.norm(b)


def test_tube_arrays_bit_identical():
    """models/tube.py's copy: the rational (3, 2) stack, the four seams,
    the clamp, the pressure and the tip force's edge loads."""
    from goldfish_tpu_torch.models import tube

    j = jax_tube(TIP)
    p = tube.build(**TUBE_SMALL, tip_force=TIP, device="cpu")
    for field in j.stack._fields:
        if hasattr(p.stack, field):
            assert _same(getattr(p.stack, field), getattr(j.stack, field)), \
                field
    for field in j.ifs._fields:
        assert _same(getattr(p.ifs, field), getattr(j.ifs, field)), field
    for field in j.data.edge_loads._fields:
        assert _same(getattr(p.data.edge_loads, field),
                     getattr(j.data.edge_loads, field)), field
    assert _same(p.cp, j.cp) and _same(p.data.free, j.data.free)
    pp = tube.build(**TUBE_SMALL, pressure=PRESSURE, device="cpu")
    assert _same(pp.data.pressure, jax_tube().data.pressure)


def test_plate_arrays_bit_identical():
    """models/plate.py's copy: the two degree-2 strips, their interface,
    the clamp and the edge load; the thickness FFD of the demos."""
    import torch

    from goldfish_tpu.design.pipeline import ThicknessFFD as JaxTFFD
    from goldfish_tpu_torch.design.pipeline import ThicknessFFD

    j = jax_plate()
    p = port_plate()
    for field in j.stack._fields:
        if hasattr(p.stack, field):
            assert _same(getattr(p.stack, field), getattr(j.stack, field)), \
                field
    for field in j.ifs._fields:
        assert _same(getattr(p.ifs, field), getattr(j.ifs, field)), field
    for field in j.data.edge_loads._fields:
        assert _same(getattr(p.data.edge_loads, field),
                     getattr(j.data.edge_loads, field)), field
    assert _same(p.cp, j.cp) and _same(p.data.free, j.data.free)
    assert _same(p.h_init, j.h_init)
    kw = dict(num_els=(4, 2, 1), p=(2, 1, 1))
    jt, pt = JaxTFFD(j, **kw), ThicknessFFD(p, **kw)
    assert _same(pt.F, jt.F) and pt.shape == jt.shape
    # CPLayout.to_flat inverts to_padded and drops the padding
    x = np.random.default_rng(1).normal(size=(pt.layout.n_flat, 3))
    pad = pt.layout.to_padded(torch.from_numpy(x))
    assert np.array_equal(pt.layout.to_flat(pad).numpy(), x)
    assert _same(pt.layout.to_flat(pad), jt.layout.to_flat(np.asarray(pad)))


@pytest.mark.parametrize("which", ["pin", "regu", "align", "align2"])
def test_constraint_operators_identical(which):
    from goldfish_tpu.design import constraints as jc
    from goldfish_tpu_torch.design import constraints as pc

    shape = (4, 3, 2)
    if which == "pin":
        args = (shape, [(i, j, 0) for i in range(4) for j in range(3)]
                + [5, 7])
    elif which == "regu":
        args = (shape, 1)
    elif which == "align":
        args = (shape, 2)
    else:
        args = (shape, (0, 2))
    name = "align_operator" if which.startswith("align") \
        else f"{which}_operator"
    assert _same(getattr(pc, name)(*args), getattr(jc, name)(*args))
    assert pc.grid_dof(1, 2, 1, 4, 3) == jc.grid_dof(1, 2, 1, 4, 3)


def test_shape_ffd_matches_jax():
    import torch

    from goldfish_tpu.design.pipeline import ShapeFFD as JaxShapeFFD
    from goldfish_tpu_torch.design.pipeline import ShapeFFD
    from goldfish_tpu_torch.models import tube

    kw = dict(num_els=(2, 2, 1), p=(3, 3, 1), opt_fields=(0, 1))
    js = JaxShapeFFD(jax_tube(), **kw)
    ps = ShapeFFD(tube.build(**TUBE_SMALL, pressure=PRESSURE, device="cpu"),
                  **kw)
    assert _same(ps.F, js.F) and ps.shape == js.shape
    assert np.array_equal(ps.init_p_ffd(), js.init_p_ffd())
    x = js.init_p_ffd() * (1.0 + 0.01 * np.random.default_rng(2).normal(
        size=ps.init_p_ffd().size))
    a, b = ps(torch.from_numpy(x)).numpy(), np.asarray(js(x))
    assert np.linalg.norm(a - b) <= 1e-14 * np.linalg.norm(b)


def test_bridge_round_trip():
    from goldfish_tpu_torch.bridge import from_numpy_tree
    from goldfish_tpu_torch.solver.system import SystemData

    j = jax_wing().data
    p = from_numpy_tree(j, device="cpu")
    assert isinstance(p, SystemData)
    assert _same(p.stack.conn, j.stack.conn)
    assert p.stack.conn.dtype.is_floating_point is False
    assert _same(p.ifs.RB01, j.ifs.RB01)
    assert p.point_loads is None and p.contact is None


def test_port_imports_without_jax():
    code = ("import sys; import goldfish_tpu_torch.solver.implicit, "
            "goldfish_tpu_torch.models.wing, goldfish_tpu_torch.bridge, "
            "goldfish_tpu_torch.design.pipeline, "
            "goldfish_tpu_torch.opt.warmstart, "
            "goldfish_tpu_torch.models.tbeam, "
            "goldfish_tpu_torch.ops.bspline_traced, "
            "goldfish_tpu_torch.geometry.cpiga2xi, "
            "goldfish_tpu_torch.physics.coupling_mi, "
            "goldfish_tpu_torch.solver.system_mi, "
            "goldfish_tpu_torch.physics.loads, "
            "goldfish_tpu_torch.models.tube, "
            "goldfish_tpu_torch.design.constraints, "
            "goldfish_tpu_torch.opt.problem, "
            "goldfish_tpu_torch.demos.tube_shape_opt, "
            "goldfish_tpu_torch.demos.draft_tube_shopt_mi_wffd, "
            "goldfish_tpu_torch.models.plate, "
            "goldfish_tpu_torch.physics.objectives, "
            "goldfish_tpu_torch.operations, "
            "goldfish_tpu_torch.operations.custom_exop, "
            "goldfish_tpu_torch.om_shim, "
            "goldfish_tpu_torch.om_comps.components, "
            "goldfish_tpu_torch.nonmatching_opt_om, "
            "goldfish_tpu_torch.demos.om_plate_var_th_opt_wint, "
            "goldfish_tpu_torch.demos.plate_var_th_opt_stress, "
            "goldfish_tpu_torch.models.boxwing, "
            "goldfish_tpu_torch.solver.krylov, "
            "goldfish_tpu_torch.demos.pegasus_thickness_opt, "
            "goldfish_tpu_torch.physics.vlm, "
            "goldfish_tpu_torch.models.slr, "
            "goldfish_tpu_torch.demos.vlm_aeroelastic_wing, "
            "goldfish_tpu_torch.design.cp_design, "
            "goldfish_tpu_torch.operations.disp_mi_imop, "
            "goldfish_tpu_torch.demos.om_tbeam_shopt_mi, "
            "goldfish_tpu_torch.operations.exops, "
            "goldfish_tpu_torch.demos.tube_shopt_mi_4patch_wffd, "
            "goldfish_tpu_torch.demos.evtol_wing_shopt_mi, "
            "goldfish_tpu_torch.geometry.trim, "
            "goldfish_tpu_torch.geometry.igs_io, "
            "goldfish_tpu_torch.geometry.step_io, "
            "goldfish_tpu_torch.geometry.native, "
            "goldfish_tpu_torch.geometry.preprocessing, "
            "goldfish_tpu_torch.caddee, "
            "goldfish_tpu_torch.utils.vtk_io, "
            "goldfish_tpu_torch.utils.checkpoint, "
            "goldfish_tpu_torch.demos.plate_hole_thickness_opt, "
            "goldfish_tpu_torch.demos.thickness_opt_plate, "
            "goldfish_tpu_torch.demos.evtol_wing_shopt, "
            "goldfish_tpu_torch.demos.shape_opt_mint_tbeam_curved, "
            "goldfish_tpu_torch.demos.caddee_aeroelastic_wing, "
            "goldfish_tpu_torch.utils.profiling, "
            "goldfish_tpu_torch.pyoptsparse_shim, "
            "goldfish_tpu_torch.csdl_shim, "
            "goldfish_tpu_torch.csdl_models, "
            "goldfish_tpu_torch.csdl_models.models, "
            "goldfish_tpu_torch.nonmatching_opt_csdl, "
            "goldfish_tpu_torch.entry, "
            "goldfish_tpu_torch.demos.wing_thickness_opt, "
            "goldfish_tpu_torch.demos.tbeam_shape_opt, "
            "goldfish_tpu_torch.demos.shape_opt_arch, "
            "goldfish_tpu_torch.demos.shape_opt_mint_tbeam, "
            "goldfish_tpu_torch.demos.aeroelastic_wing, "
            "goldfish_tpu_torch.demos.csdl_plate_const_th_opt, "
            "goldfish_tpu_torch.parallel.sharding, "
            "goldfish_tpu_torch.parallel.legs; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'goldfish_tpu' "
            "or m.startswith('goldfish_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
