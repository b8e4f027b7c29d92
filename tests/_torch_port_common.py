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

# One intra-op thread per test process: the suite runs in several xdist
# workers on a few cores, and a torch thread pool per worker oversubscribes
# them (the port's test files: 688 s on six workers and 8 cores with the
# default pool, 250 s with one thread). Set here, at collection, before any
# test runs: this torch build's MKL fails in its LU (DLASWP errors, then a
# hang) once the count is changed after use.
torch.set_num_threads(1)

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


# The two-plate contact press of tests/test_contact.py (`_press_problem`: a
# plate at z = 0.12 under q = 120 pressed onto one at z = 0, both clamped
# on two sides, contact (0, 1) with k_pen = 1e7 and r_max = 0.1) and the
# shallow cylindrical panel of tests/test_riks.py, built by the port from
# its own cadkit (the JAX package has no model module for either).
def port_press(num_el=4, p=2, q=120.0, k_pen=1e7, device="cpu"):
    from goldfish_tpu_torch.geometry.cadkit import bilinear
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    def plate_at(z):
        s = bilinear([0, 0, z], [1, 0, z], [0, 1, z], [1, 1, z])
        s = s.elevate(0, p - 1).elevate(1, p - 1)
        nk = np.linspace(0, 1, num_el + 1)[1:-1]
        return s.refine(0, nk).refine(1, nk)

    s = NonMatchingSystem([plate_at(0.12), plate_at(0.0)], E=1e7, nu=0.3,
                          h_th=0.01, device=device)
    for side in (0, 1):
        s.add_side_bc(0, direction=1, side=side, n_layers=2)
        s.add_side_bc(1, direction=1, side=side, n_layers=2)
    s.set_dead_load([[0, 0, -q], [0, 0, 0]])
    s.set_contact([(0, 1)], k_pen=k_pen, r_max=0.1)
    return s


# The T-beam driven into a stop plate: bench_mi's moving-seam T-beam
# (scripts/bench_mi.py:47-76) with its tip point load replaced by an upward
# areal field load of q on the flange, and a flat plate at z = gap above the
# outer 30% of the span (x in [-1.2, 1.2], y in [14, 20]), clamped on its
# four sides, meshed no coarser than the flange, contact (flange, stop).
# The small size is the CPU tests'; the card's is bench_mi's full width,
# where r_max (0.25) is above both patches' qp spacing (0.17 along the
# span) and the gap (0.3) above r_max, so W_c = 0 at d = 0. At the small
# size the flange's qps are 1.9 apart along the span, so r_max is 1.5 and
# the gap 1.6 (contact-free tip rise at q = 80: 2.1).
TBEAM_STOP_SMALL = dict(num_el=4, p=2, n_pts=5, q=80.0, gap=1.6,
                        r_max=1.5, k_pen=1e7)
TBEAM_STOP_CARD = dict(num_el=40, p=3, n_pts=17, q=40.0, gap=0.3,
                       r_max=0.25, k_pen=1e7)
STOP_X, STOP_Y = 1.2, (14.0, 20.0)


def stop_plate_els(num_el):
    """(elements across, elements along) of the stop plate: no coarser than
    the flange's num_el // 2 across 2 and num_el along 20."""
    nx = -(-12 * max(num_el // 2, 1) // 10)
    ny = -(-3 * num_el // 10)
    return nx, ny


def port_tbeam_stop(num_el, p, n_pts, q, gap, r_max, k_pen, device="cpu"):
    from goldfish_tpu_torch.models import tbeam
    from goldfish_tpu_torch.solver.system_mi import MINonMatchingSystem

    nx, ny = stop_plate_els(num_el)
    (y0, y1), x = STOP_Y, STOP_X
    stop = tbeam.create_surf([[-x, y0, gap], [x, y0, gap], [-x, y1, gap],
                              [x, y1, gap]], nx, ny, p)
    surfs = tbeam._surfs(num_el, p) + [stop]
    s = MINonMatchingSystem(surfs, tbeam.E, tbeam.NU, tbeam.H_TH,
                            specs=[tbeam._seam(n_pts - 1)],
                            n_pts_list=[n_pts], device=device)
    s.add_side_bc(0, direction=1, side=0, n_layers=1)
    s.add_side_bc(1, direction=1, side=0, n_layers=1)
    for direction in (0, 1):
        for side in (0, 1):
            s.add_side_bc(2, direction=direction, side=side, n_layers=1)
    f = np.zeros(tuple(s.cp.shape))
    f[0, : s.metas[0].n_cp, 2] = q
    s.set_areal_field(f)
    s.set_contact([(0, 2)], k_pen=k_pen, r_max=r_max)
    return s


def dec(e):
    """A float64 array stored as {"shape", "b64"} (little-endian bytes) by
    the reference scripts."""
    import base64

    return np.frombuffer(base64.b64decode(e["b64"]), "<f8").reshape(
        e["shape"]).copy()


def press_state(system, seed=0, drop=0.03):
    """(cp, h, d, lam, v) as numpy on a press: d moves the upper plate down
    by `drop` (into contact range) plus seeded noise at 1e-3 on free dofs;
    lam and v standard normal."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        return np.asarray(a, dtype=np.float64)

    cp, free = host(system.cp), host(system.data.free)
    rng = np.random.default_rng(seed)
    d = np.zeros_like(cp)
    d[0, :, 2] -= drop
    d = d + 1e-3 * rng.normal(size=cp.shape) * free
    return (cp, host(system.h_init), d, rng.normal(size=cp.shape),
            rng.normal(size=cp.shape))


def port_panel(num_el=6, p=2, device="cpu"):
    from goldfish_tpu_torch.geometry.cadkit import circle, extrude
    from goldfish_tpu_torch.solver.system import NonMatchingSystem

    arc = circle(radius=2540.0, angle=(np.pi / 2 - 0.1, np.pi / 2 + 0.1))
    surf = extrude(arc, (0.0, 0.0, 508.0)).elevate(0, p - 2).elevate(1, p - 1)
    kn = np.linspace(0, 1, num_el + 1)[1:-1]
    surf = surf.refine(0, kn).refine(1, kn)
    s = NonMatchingSystem([surf], 3102.75, 0.3, 12.7, device=device)
    s.add_side_bc(0, direction=0, side=0, n_layers=1)
    s.add_side_bc(0, direction=0, side=1, n_layers=1)
    s.add_point_load(0, [0.5, 0.5], [0.0, -4000.0, 0.0])
    return s


# The forward design tangents (tests/test_torch_design_jvp.py and
# scripts/torch_port_design_jvp_reference.py): standard-normal tangents of
# cp and h, and the OpenMDAO MI T-beam's CPU test size.
OM_MI_SMALL = dict(num_el=3, p=2, n_pts=7)


def design_tangents(cp, h, seed):
    """(tcp, th) standard normal, as numpy, shaped as cp and h."""
    rng = np.random.default_rng(seed)
    return rng.normal(size=np.shape(cp)), rng.normal(size=np.shape(h))


def om_mi_design_state(system, seed=12):
    """(cp, h, xi, d, tcp, th, txi) as numpy on an OM MI T-beam of either
    package: xi the initial seam moved by up to 1e-3 (clipped to [0, 1]),
    d ~ 1e-3 |cp| on free dofs, the tangents standard normal."""
    def host(a):
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu()
        return np.asarray(a, dtype=np.float64)

    cp, h = host(system.cp), host(system.h_init)
    free, xi0 = host(system.data.free), host(system.c2x.xi0_flat)
    rng = np.random.default_rng(seed)
    xi = np.clip(xi0 + 1e-3 * rng.uniform(-1, 1, size=xi0.shape), 0.0, 1.0)
    scale = np.linalg.norm(cp) / np.sqrt(cp.size)
    d = 1e-3 * scale * rng.normal(size=cp.shape) * free
    tcp, th = design_tangents(cp, h, seed + 1)
    txi = rng.normal(size=xi.shape)
    return cp, h, xi, d, tcp, th, txi


def record_start(prob):
    """Record the SLSQP surface's J and gradient at the start design x0 as
    the run evaluates them (its first fun and jac calls at x0): no extra
    cold evaluation. Returns the dict that fills in."""
    x0 = prob._x0()
    seen = {}
    build = prob._build_callables

    def recording():
        fun, jac, cons = build()

        def f(x):
            J = fun(x)
            if "J" not in seen and np.array_equal(x, x0):
                seen["J"] = J
            return J

        def g(x):
            out = jac(x)
            if "g" not in seen and np.array_equal(x, x0):
                seen["g"] = np.array(out)
            return out
        return f, g, cons

    prob._build_callables = recording
    return seen
