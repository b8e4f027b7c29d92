"""External loads (port of goldfish_tpu/physics/loads.py: dead, point, edge
and follower-pressure loads).

The dead, point and edge loads are linear in d, so their work is a
contraction and a reduction (plain PyTorch, no kernel) and their
d-gradient is a constant force vector. A point load F . u(xi) acts at a
fixed parametric point and an edge load along a whole parametric edge: the
basis rows of both are evaluated once on the host (`build_point_loads`,
`build_edge_loads`, NumPy, the reference's builders). The edge load's line
measure |dX/ds| depends on cp (autograd in plain torch).

The follower pressure is not linear in d: its work per qp is

    w = p ((x . (x_u x x_v) - X . (X_u x X_v)) / 3) wq,   x = X + u,

a function of the 9-jet (u, u_u, u_v) through (R00, R10, R01). Its value
and d-gradient, its per-qp 9x9 jet Hessian and its adjoint run the CUDA
kernel K8 `pressure_qp` (csrc/pressure_qp.cu) on CUDA tensors and their
plain PyTorch versions (torch.func on `pressure_density`) on CPU tensors.
Its forward design product (`pressure_design_jvp`) needs no mode of its
own: W_p is f(X + z) - f(X) summed, so the cp-Jacobian of dW_p/dd is the
symmetric B^T H_f(X + z) B, and mode (c) at lambda = tcp gives it. The
areal field load (a force-density coefficient field, the aeroelastic
coupling's input) is linear in d: its work and force are plain
contractions (`areal_field_work`, `areal_field_force`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.geometry.patch_stack import PatchStack
from goldfish_tpu_torch.ops.bspline import rational_basis_2d
from goldfish_tpu_torch.ops.quadrature import gauss_points_1d
from goldfish_tpu_torch.physics.kl_shell import (
    _cross,
    _dot,
    _index_add_nodes,
    _ref_area,
    dead_load_force,
    external_work_dead_load,
    gather,
)

__all__ = ["PointLoads", "build_point_loads", "point_load_work",
           "EdgeLoads", "build_edge_loads", "edge_load_work",
           "pressure_density", "pressure_value_grad",
           "pressure_hessians",
           "pressure_adjoint", "pressure_design_jvp", "follower_pressure_work",
           "areal_field_work", "areal_field_force",
           "external_work_and_force", "external_work"]

NP = 9  # follower-pressure jet size: (value, d/du, d/dv) x 3


class PointLoads(NamedTuple):
    """Stacked point loads: F . u(xi) at fixed parametric points."""

    patch: torch.Tensor  # (n,) int32
    conn: torch.Tensor   # (n, L) int32
    R0: torch.Tensor     # (n, L)
    F: torch.Tensor      # (n, 3)


def build_point_loads(surfs: list[NURBS], entries, max_loc: int,
                      device=None) -> PointLoads | None:
    """entries: list of (patch_index, xi (2,), force (3,))."""
    device = as_device(device)
    if not entries:
        return None
    patch, conns, R0s, Fs = [], [], [], []
    for (ip, xi, F) in entries:
        s = surfs[ip]
        p, q = s.degree
        conn, tab = rational_basis_2d(
            s.knots[0], s.knots[1], p, q, s.weights,
            np.asarray(xi, dtype=np.float64)[None, :], nd=0)
        c = np.zeros(max_loc, dtype=np.int64)
        r = np.zeros(max_loc)
        c[: conn.shape[1]] = conn[0]
        r[: conn.shape[1]] = tab[(0, 0)][0]
        patch.append(ip)
        conns.append(c)
        R0s.append(r)
        Fs.append(np.asarray(F, dtype=np.float64))
    return PointLoads(
        patch=tensor(patch, device, INDEX_DTYPE),
        conn=tensor(np.stack(conns), device, INDEX_DTYPE),
        R0=tensor(np.stack(R0s), device, DTYPE),
        F=tensor(np.stack(Fs), device, DTYPE),
    )


def point_load_work(pl: PointLoads, d):
    """sum_i F_i . u(xi_i)."""
    de = d[pl.patch.long()[:, None], pl.conn.long()]   # (n, L, 3)
    u = torch.einsum("nl,nlk->nk", pl.R0, de)
    return (pl.F * u).sum()


def _nodes_add(patch, conn, contrib, P, C):
    """(n, L, 3) contributions at (patch, conn) -> (P, C, 3)."""
    node = (patch.long()[:, None] * C + conn.long()).reshape(-1)
    out = torch.zeros(P * C, 3, dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, node, contrib.reshape(-1, 3))
    return out.reshape(P, C, 3)


def point_load_force(pl: PointLoads, P: int, C: int):
    """d/dd of `point_load_work`: (P, C, 3), constant in d."""
    return _nodes_add(pl.patch, pl.conn, pl.R0[..., None] * pl.F[:, None, :],
                      P, C)


class EdgeLoads(NamedTuple):
    """Dead line loads along parametric edges: int f . u dl with the line
    measure |dX/ds| evaluated on the (differentiable) control points."""

    patch: torch.Tensor  # (M,) int32, one entry per quadrature point
    conn: torch.Tensor   # (M, L) int32
    R0: torch.Tensor     # (M, L) basis values
    R1s: torch.Tensor    # (M, L) derivative along the edge
    w: torch.Tensor      # (M,) 1D quadrature weights (parametric)
    F: torch.Tensor      # (M, 3) force per unit length


def build_edge_loads(surfs: list[NURBS], entries, max_loc: int, nq: int = 4,
                     device=None) -> EdgeLoads | None:
    """entries: list of (patch, direction, side, force (3,)): a dead line
    load on a whole parametric edge. direction/side follow the tIGAr side
    convention (geometry/patch_stack.side_dofs). A copy of the JAX
    package's host builder."""
    device = as_device(device)
    if not entries:
        return None
    patch, conns, R0s, R1s, ws, Fs = [], [], [], [], [], []
    for (ip, direction, side, F) in entries:
        s = surfs[ip]
        p, q = s.degree
        # quadrature along the free direction, per knot span
        free_dir = 1 - direction
        kts = np.unique(s.knots[free_dir])
        g, wg = gauss_points_1d(nq)
        for a, b in zip(kts[:-1], kts[1:]):
            ss = 0.5 * (a + b) + 0.5 * (b - a) * g
            ww = 0.5 * (b - a) * wg
            xi = np.zeros((nq, 2))
            xi[:, direction] = float(side)
            xi[:, free_dir] = ss
            conn, tab = rational_basis_2d(
                s.knots[0], s.knots[1], p, q, s.weights, xi, nd=1)
            dkey = (1, 0) if free_dir == 0 else (0, 1)
            for k in range(nq):
                c = np.zeros(max_loc, dtype=np.int64)
                r0 = np.zeros(max_loc)
                r1 = np.zeros(max_loc)
                c[: conn.shape[1]] = conn[k]
                r0[: conn.shape[1]] = tab[(0, 0)][k]
                r1[: conn.shape[1]] = tab[dkey][k]
                patch.append(ip)
                conns.append(c)
                R0s.append(r0)
                R1s.append(r1)
                ws.append(ww[k])
                Fs.append(np.asarray(F, dtype=np.float64))
    return EdgeLoads(
        patch=tensor(patch, device, INDEX_DTYPE),
        conn=tensor(np.stack(conns), device, INDEX_DTYPE),
        R0=tensor(np.stack(R0s), device, DTYPE),
        R1s=tensor(np.stack(R1s), device, DTYPE),
        w=tensor(ws, device, DTYPE),
        F=tensor(np.stack(Fs), device, DTYPE),
    )


def _edge_dl(el: EdgeLoads, cp):
    """w_m |dX/ds|_m (M,)."""
    pe = cp[el.patch.long()[:, None], el.conn.long()]
    t = torch.einsum("ml,mlk->mk", el.R1s, pe)
    return el.w * torch.linalg.norm(t, dim=-1)


def edge_load_work(el: EdgeLoads, d, cp):
    """sum_m w_m (F_m . u_m) |dX/ds|_m."""
    de = d[el.patch.long()[:, None], el.conn.long()]    # (M, L, 3)
    u = torch.einsum("ml,mlk->mk", el.R0, de)
    return (_edge_dl(el, cp) * (el.F * u).sum(-1)).sum()


def edge_load_force(el: EdgeLoads, cp):
    """d/dd of `edge_load_work`: (P, C, 3), constant in d."""
    f = (_edge_dl(el, cp)[:, None] * el.F)[:, None, :] * el.R0[..., None]
    return _nodes_add(el.patch, el.conn, f, cp.shape[0], cp.shape[1])


# ------------------------------------------------------------ follower pressure
def _pressure_tables(stack: PatchStack):
    return (stack.R00, stack.R10, stack.R01)


def pressure_jets(stack: PatchStack, coef):
    """(P, C, 3) field -> (P, E, Q, 9) jets (value, d/du, d/dv)."""
    ce = gather(coef, stack.conn)
    return torch.cat([torch.einsum("peql,pelk->peqk", R, ce)
                      for R in _pressure_tables(stack)], dim=-1)


def _scatter_pjets(stack: PatchStack, gz, C):
    """B^T g: (P, E, Q, 9) jet cotangents -> (P, C, 3)."""
    contrib = sum(torch.einsum("peql,peqk->pelk", R, gz[..., 3 * j:3 * j + 3])
                  for j, R in enumerate(_pressure_tables(stack)))
    return _index_add_nodes(stack.conn, contrib, gz.shape[0], C)


def pressure_density(X, z, pr, wq):
    """Follower-pressure work per qp. X, z: (..., 9) geometry /
    displacement jets; pr, wq: (...). The plain version of K8's density
    (the same formula as csrc/pressure_qp.cu)."""
    x = X + z
    vc = _dot(x[..., 0:3], _cross(x[..., 3:6], x[..., 6:9]))
    vr = _dot(X[..., 0:3], _cross(X[..., 3:6], X[..., 6:9]))
    return pr * ((vc - vr) / 3.0) * wq


def _pr_qp(stack, pressure):
    return pressure[:, None, None].expand(stack.wq.shape)


def _pressure_value_grad_plain(stack, d, cp, pressure):
    X, z = pressure_jets(stack, cp), pressure_jets(stack, d)
    prq = _pr_qp(stack, pressure)
    vals, vjp = torch.func.vjp(
        lambda zz: pressure_density(X, zz, prq, stack.wq), z)
    (gz,) = vjp(torch.ones_like(vals))
    return vals.sum(-1), _scatter_pjets(stack, gz, d.shape[1])


def _pressure_hessians_plain(stack, d, cp, pressure):
    X, z = pressure_jets(stack, cp), pressure_jets(stack, d)
    prq = _pr_qp(stack, pressure)
    shp = prq.shape
    # reverse over reverse: in eager PyTorch ~4x faster than hessian's
    # forward over reverse, the same values to rounding
    H = torch.func.vmap(torch.func.jacrev(
        torch.func.grad(pressure_density, argnums=1), argnums=1))(
        X.reshape(-1, NP), z.reshape(-1, NP), prq.reshape(-1),
        stack.wq.reshape(-1))
    return -H.reshape(shp + (NP, NP))


def _pressure_adjoint_plain(stack, d, cp, pressure, lam):
    X, z = pressure_jets(stack, cp), pressure_jets(stack, d)
    lz = pressure_jets(stack, lam)
    prq = _pr_qp(stack, pressure)

    def lam_dot_grad(XX):
        gz = torch.func.grad(
            lambda zz: pressure_density(XX, zz, prq, stack.wq).sum())(z)
        return (gz * lz).sum()

    # x = X + u, so moving X moves x; the reference term X . (X_u x X_v)
    # has no z-gradient and drops out
    gX = torch.func.grad(lam_dot_grad)(X)
    return _scatter_pjets(stack, gX, d.shape[1])


def _check_pressure(stack, d, cp, pressure, lam=None):
    P, Ne, Q, L = stack.R00.shape
    C = d.shape[1]
    dev = d.device
    for name in ("R00", "R10", "R01"):
        _cuda.check(getattr(stack, name), name, DTYPE, (P, Ne, Q, L), dev)
    _cuda.check(stack.conn, "conn", INDEX_DTYPE, (P, Ne, L), dev)
    _cuda.check(stack.wq, "wq", DTYPE, (P, Ne, Q), dev)
    _cuda.check(d, "d", DTYPE, (P, C, 3), dev)
    _cuda.check(cp, "cp", DTYPE, (P, C, 3), dev)
    _cuda.check(pressure, "pressure", DTYPE, (P,), dev)
    if lam is not None:
        _cuda.check(lam, "lam", DTYPE, (P, C, 3), dev)
    return P, Ne, Q, L, C


def _launch_pressure(mode, counter, stack, d, cp, pressure, lam, out_w, out_f,
                     dims):
    p = _cuda.ptr
    _cuda.launch(counter, "gf_pressure_qp", mode, p(stack.R00), p(stack.R10),
                 p(stack.R01), p(stack.conn), p(stack.wq), p(d), p(cp),
                 p(pressure), p(lam), p(out_w), p(out_f), *dims)


def pressure_value_grad(stack: PatchStack, d, cp, pressure):
    """K8 mode (a): (W_p (P, E) per-element pressure work, dW_p/dd
    (P, C, 3)). Sum W_p with torch.sum for a deterministic W."""
    dims = _check_pressure(stack, d, cp, pressure)
    if not _cuda.on_cuda(d):
        return _pressure_value_grad_plain(stack, d, cp, pressure)
    P, Ne, Q, L, C = dims
    W = torch.empty(P, Ne, dtype=DTYPE, device=d.device)
    f = torch.zeros(P, C, 3, dtype=DTYPE, device=d.device)
    _launch_pressure(0, "pressure_qp/value_grad", stack, d, cp, pressure,
                     None, W, f, dims)
    return W, f


def pressure_hessians(stack: PatchStack, d, cp, pressure):
    """K8 mode (b): per-qp jet Hessians of the potential's pressure term,
    -d2w/dz2 (P, E, Q, 9, 9)."""
    dims = _check_pressure(stack, d, cp, pressure)
    if not _cuda.on_cuda(d):
        return _pressure_hessians_plain(stack, d, cp, pressure)
    P, Ne, Q, L, C = dims
    H = torch.empty(P, Ne, Q, NP, NP, dtype=DTYPE, device=d.device)
    _launch_pressure(1, "pressure_qp/hess", stack, d, cp, pressure, None,
                     None, H, dims)
    return H


def pressure_adjoint(stack: PatchStack, d, cp, pressure, lam):
    """K8 mode (c): -d/dcp of lam^T r_p (P, C, 3), r_p = -dW_p/dd the
    pressure's residual term (lam unmasked; the caller masks)."""
    dims = _check_pressure(stack, d, cp, pressure, lam)
    if not _cuda.on_cuda(d):
        return _pressure_adjoint_plain(stack, d, cp, pressure, lam)
    dcp = torch.zeros_like(d)
    _launch_pressure(2, "pressure_qp/adjoint", stack, d, cp, pressure, lam,
                     None, dcp, dims)
    return dcp


def pressure_design_jvp(stack: PatchStack, d, cp, pressure, tcp):
    """d/de r_p(d; cp + e tcp) (P, C, 3), r_p = -dW_p/dd the pressure's
    residual term (tcp unmasked; the caller masks). With x = X + z, r_p =
    -B^T grad f(x) and dr_p/dcp = -B^T H_f(x) B is symmetric (the
    reference term f(X) has no z-gradient), so this is K8 mode (c) at
    lambda = tcp, negated: no kernel mode of its own."""
    return -pressure_adjoint(stack, d, cp, pressure, tcp)


def _pressure_design_jvp_plain(stack, d, cp, pressure, tcp):
    """torch.func.jvp in cp of mode (a)'s plain r_p: the yardstick of
    `pressure_design_jvp`'s symmetry route."""
    return -torch.func.jvp(
        lambda c: _pressure_value_grad_plain(stack, d, c, pressure)[1],
        (cp,), (tcp,))[1]


def follower_pressure_work(stack: PatchStack, d, cp, pressure):
    """Work of a uniform follower (normal) pressure per patch (0-dim; not
    differentiable by autograd: its d-gradient is `pressure_value_grad`'s
    second output). Exact potential for constant p: W = p/3 int x .
    (x_u x x_v) dxi (volume-swept form); pressure: (P,) outward-normal
    magnitude."""
    return pressure_value_grad(stack, d, cp, pressure)[0].sum()


# ------------------------------------------------------------ areal field
def _values_at_qps(stack: PatchStack, coef):
    """(P, C, 3) coefficient field -> its values (P, E, Q, 3) at the qps."""
    return torch.einsum("peql,pelk->peqk", stack.R00, gather(coef, stack.conn))


def areal_field_work(stack: PatchStack, d, cp, f_coef):
    """Work of a distributed dead load given as a coefficient FIELD f_coef
    (P, C, 3) (force density per reference area, interpolated with the
    displacement basis): sum over qps of (f . u) J w (0-dim).
    Differentiable by autograd in d, cp and f_coef."""
    fu = _dot(_values_at_qps(stack, f_coef), _values_at_qps(stack, d))
    return (fu * _ref_area(stack, cp)).sum()


def areal_field_force(stack: PatchStack, cp, f_coef):
    """dW_f/dd (P, C, 3): constant in d (the field load is linear in d).
    W_f is symmetric in d and f, so areal_field_force(stack, cp, lam) is
    also dW_f(lam)/df, the field's pullback of lam . dW_f/dd."""
    vals = _values_at_qps(stack, f_coef) * _ref_area(stack, cp)[..., None]
    contrib = torch.einsum("peql,peqk->pelk", stack.R00, vals)
    return _index_add_nodes(stack.conn, contrib, cp.shape[0], cp.shape[1])


# ------------------------------------------------------------ totals
def external_work_and_force(stack: PatchStack, d, cp, f_areal=None,
                            point_loads=None, pressure=None, edge_loads=None,
                            f_field=None, part=None):
    """(W_ext (0-dim), dW_ext/dd (P, C, 3)). The dead, point, edge and
    field loads are linear in d; the follower pressure's value and force
    come from one K8 launch. With `part` (a rank's part of a patch-sharded
    system, solver/system.py; `stack` is then the rank's patch block) the
    dead, pressure and field loads run on the rank's patches, the point and
    edge loads on rank 0 only, and W_ext and the force are the rank's
    share; with part=None or the whole system's, the whole."""
    loc = (lambda t: t) if part is None else part.local   # noqa: E731
    place = (lambda t: t) if part is None else part.place  # noqa: E731
    rank0 = part is None or part.rank0
    P, C = cp.shape[0], cp.shape[1]
    dl, cpl = loc(d), loc(cp)
    W = torch.zeros((), dtype=d.dtype, device=d.device)
    f = torch.zeros_like(cp)
    if f_areal is not None:
        W = W + external_work_dead_load(stack, dl, cpl, loc(f_areal))
        f = f + place(dead_load_force(stack, cpl, loc(f_areal)))
    if point_loads is not None and rank0:
        W = W + point_load_work(point_loads, d)
        f = f + point_load_force(point_loads, P, C)
    if pressure is not None:
        Wp, fp = pressure_value_grad(stack, dl, cpl, loc(pressure))
        W = W + Wp.sum()
        f = f + place(fp)
    if edge_loads is not None and rank0:
        W = W + edge_load_work(edge_loads, d, cp)
        f = f + edge_load_force(edge_loads, cp)
    if f_field is not None:
        ff = areal_field_force(stack, cpl, loc(f_field))
        W = W + (ff * dl).sum()
        f = f + place(ff)
    return W, f


def external_work(stack: PatchStack, d, cp, f_areal=None, point_loads=None,
                  pressure=None, edge_loads=None, f_field=None):
    """W_ext (0-dim tensor). Differentiable by autograd in d and cp for the
    dead, point, edge and field loads (and in the field itself)."""
    W = torch.zeros((), dtype=d.dtype, device=d.device)
    if f_areal is not None:
        W = W + external_work_dead_load(stack, d, cp, f_areal)
    if point_loads is not None:
        W = W + point_load_work(point_loads, d)
    if pressure is not None:
        W = W + follower_pressure_work(stack, d, cp, pressure)
    if edge_loads is not None:
        W = W + edge_load_work(edge_loads, d, cp)
    if f_field is not None:
        W = W + areal_field_work(stack, d, cp, f_field)
    return W
