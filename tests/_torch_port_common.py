"""Shared inputs for the PyTorch-port parity tests (test_torch_*.py).

The small wing: `wing.build(n_chord=2, n_span=2, num_el=3, p=3)`, 4
patches, 20 (padded) elements each, N = 672 dofs. Both packages build it
from the same host code; `from_numpy_tree` hands the JAX package's arrays
to the port bit for bit. Seeded states come from numpy, so both packages
see identical inputs.

The small moving-intersection T-beam: tests/test_system_mi.py's
`_mi_tbeam(num_el=4, p=3, n_pts=17)` in the JAX package and
`tbeam.build_mi(num_el=4, p=3, n_pts=17, device="cpu")` in the port
(2 patches, C = 40, N = 240 dofs, one seam of 17 points). The design map
is scripts/bench_mi.py's: cp(amp) = cp0 + amp * bend on the web's x.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

WING_SMALL = dict(n_chord=2, n_span=2, num_el=3, p=3)
FFD_SMALL = dict(num_els=(2, 2, 1), p=(2, 2, 1))


@functools.lru_cache(maxsize=1)
def jax_wing():
    from goldfish_tpu.models import wing

    return wing.build(**WING_SMALL)


@functools.lru_cache(maxsize=1)
def port_data():
    from goldfish_tpu_torch.bridge import from_numpy_tree

    return from_numpy_tree(jax_wing().data, device="cpu")


def seeded_state(seed=0, system=None):
    """(cp, h, d, lam, v) as numpy: d ~ 1e-3 |cp| on free dofs, lam and v
    standard normal. `system` defaults to the JAX package's small wing;
    the port's own (CPU) small wing gives the same arrays without JAX."""
    s = jax_wing() if system is None else system
    cp = np.asarray(s.cp)
    h = np.asarray(s.h_init)
    free = np.asarray(s.data.free)
    rng = np.random.default_rng(seed)
    scale = np.linalg.norm(cp) / np.sqrt(cp.size)
    d = 1e-3 * scale * rng.normal(size=cp.shape) * free
    lam = rng.normal(size=cp.shape)
    v = rng.normal(size=cp.shape)
    return cp, h, d, lam, v


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def rel(a, b):
    """Relative error in norm of a against the reference b."""
    a = np.asarray(a.detach() if isinstance(a, torch.Tensor) else a,
                   dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


MI_SMALL = dict(num_el=4, p=3, n_pts=17)


@functools.lru_cache(maxsize=1)
def jax_mi_tbeam():
    from goldfish_tpu.models import tbeam
    from goldfish_tpu.physics.coupling import InterfaceSpec
    from goldfish_tpu.solver.system_mi import MINonMatchingSystem

    num_el, p, n_pts = MI_SMALL["num_el"], MI_SMALL["p"], MI_SMALL["n_pts"]
    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
            [0, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = tbeam.create_surf(pts1, max((num_el + 1) // 2, 1), num_el + 1, p)
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=n_pts - 1)]
    s = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU, tbeam.H_TH,
                            specs=specs, n_pts_list=[n_pts])
    s.add_side_bc(0, direction=1, side=0, n_layers=1)
    s.add_side_bc(1, direction=1, side=0, n_layers=1)
    s.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return s


def port_mi_tbeam():
    """A fresh port system (its solve functions keep state)."""
    from goldfish_tpu_torch.models import tbeam

    return tbeam.build_mi(**MI_SMALL, device="cpu")


def mi_bend(system):
    """bench_mi's design direction: sin(pi v) on the web's x (numpy)."""
    m = system.metas[1]
    gv = system.surfs[1].greville_points(1)
    return np.tile(np.sin(np.pi * gv)[None, :], (m.n_u, 1)).ravel()


def mi_cp(system, amp):
    """cp(amp) as numpy."""
    cp = np.array(system.cp, dtype=np.float64)
    m = system.metas[1]
    cp[1, : m.n_cp, 0] += amp * mi_bend(system)
    return cp


def mi_state(seed=0, amp=0.05):
    """(cp, h, xi, d, lam) as numpy on the small JAX T-beam: cp at amp, xi
    the initial seam moved by up to 1e-3 (clipped to [0, 1]), d ~ 1e-3
    |cp| on free dofs, lam standard normal."""
    s = jax_mi_tbeam()
    rng = np.random.default_rng(seed)
    cp = mi_cp(s, amp)
    h = np.array(s.h_init)
    free = np.asarray(s.data.free)
    xi0 = np.asarray(s.c2x.xi0_flat)
    xi = np.clip(xi0 + 1e-3 * rng.uniform(-1, 1, size=xi0.shape), 0.0, 1.0)
    scale = np.linalg.norm(cp) / np.sqrt(cp.size)
    d = 1e-3 * scale * rng.normal(size=cp.shape) * free
    lam = rng.normal(size=cp.shape)
    return cp, h, xi, d, lam


# The small pressurized tube: `tube.build(num_el=3, p=3, pressure=2e4)` in
# both packages (4 patches of degree (3, 2), 12 qps, C = 66, N = 792 dofs,
# four fixed seams); the demos' systems at num_el=3 for the two shape
# optimizations, under SLICE_PRESSURE: at the demos' 2e4 SLSQP's first
# steps reach designs whose tangent is indefinite, where the port's
# Cholesky factor fails and the JAX package's LU does not, so the two
# optimizations part ways; at 5e2 every tangent on the way is positive
# definite.
TUBE_SMALL = dict(num_el=3, p=3)
PRESSURE = 2.0e4
SLICE_PRESSURE = 5.0e2


@functools.lru_cache(maxsize=2)
def jax_tube(tip_force=None):
    """The JAX package's small tube: pressurized, or with a tip force
    (a tuple) as edge loads instead."""
    from goldfish_tpu.models import tube

    if tip_force is None:
        return tube.build(**TUBE_SMALL, pressure=PRESSURE)
    return tube.build(**TUBE_SMALL, tip_force=np.asarray(tip_force))


@functools.lru_cache(maxsize=1)
def jax_fixed_tube():
    """demos/tube_shape_opt.py's objective at num_el=3 under
    SLICE_PRESSURE: (system, ShapeFFD, obj(p, d0) -> (J, d), p0)."""
    from demos import tube_shape_opt as demo
    from goldfish_tpu.design.pipeline import ShapeFFD
    from goldfish_tpu.models import tube
    from goldfish_tpu.physics import kl_shell
    from goldfish_tpu.solver.implicit import build_solve_fn

    s = demo.build(**TUBE_SMALL, pressure=SLICE_PRESSURE)
    m = 1.05 * max(demo.SCALE_X, demo.SCALE_Y) * tube.RADIUS
    ffd = ShapeFFD(s, num_els=(2, 2, 1), p=(3, 3, 1),
                   lims=np.array([[-m, m], [-m, m],
                                  [-1e-3, tube.LENGTH + 1e-3]]),
                   opt_fields=(0, 1))
    solve = build_solve_fn(s.data, rtol=1e-9, max_it=40)

    def obj(p, d0):
        cp = ffd(p)
        d = solve(cp, s.h_init, d0)
        return kl_shell.internal_energy(s.stack, d, cp, s.h_init, s.E,
                                        s.nu), d

    return s, ffd, obj, ffd.init_p_ffd()


@functools.lru_cache(maxsize=1)
def jax_mi_tube():
    """demos/draft_tube_shopt_mi_wffd.py's objective pieces at num_el=3
    under SLICE_PRESSURE: (system, ShapeFFD, p0, p_start)."""
    from demos import draft_tube_shopt_mi_wffd as demo
    from goldfish_tpu.design.pipeline import ShapeFFD

    s = demo.build_mi_tube(**TUBE_SMALL, pressure=SLICE_PRESSURE)
    sh = ShapeFFD(s, num_els=(2, 2, 2), p=2, opt_fields=(0, 1))
    p0 = sh.init_p_ffd()
    n = sh.n_ffd
    nx, ny, _ = sh.shape
    free_z = ((np.arange(n) // (nx * ny)) > 0).astype(float)
    p_start = p0.copy()
    p_start[:n] *= 1.0 + 0.08 * free_z
    p_start[n:] *= 1.0 - 0.07 * free_z
    return s, sh, p0, p_start


# The small plate: `plate.build(num_el=3, p=2, num_patches=2)` in both
# packages, the stress demo's model at its own size (2 bilinear strips
# elevated to degree 2, 5 x 6 and 6 x 5 CPs, C = 30, N = 180 dofs, 9 qps per
# element, one interface). Seeded states are numpy, so both packages see
# identical inputs; the solved state comes from the port (CPU), so no test
# needs the JAX package's Newton solve for it.
PLATE_SMALL = dict(num_el=3, p=2, num_patches=2)


@functools.lru_cache(maxsize=1)
def jax_plate():
    from goldfish_tpu.models import plate

    s = plate.build(**PLATE_SMALL)
    # build the lazily cached SystemData now: built first inside a jax
    # transformation, it would cache tracers for every later test
    s.data
    return s


def port_plate():
    """A fresh port plate on the CPU."""
    from goldfish_tpu_torch.models import plate

    return plate.build(**PLATE_SMALL, device="cpu")


@functools.lru_cache(maxsize=1)
def plate_state(seed=0):
    """(cp, h, d, d_noisy, gbar) as numpy: d the port's Newton solution
    (rtol 1e-12), d_noisy = d + seeded noise at 1e-3 of its largest entry
    on free dofs, gbar a standard-normal qp cotangent (P, E, Q)."""
    s = port_plate()
    d = s.solve_nonlinear(rtol=1e-12).numpy()
    rng = np.random.default_rng(seed)
    free = s.data.free.numpy()
    d_noisy = d + 1e-3 * np.abs(d).max() * rng.normal(size=d.shape) * free
    gbar = rng.normal(size=tuple(s.stack.wq.shape))
    return s.cp.numpy(), s.h_init.numpy(), d, d_noisy, gbar
