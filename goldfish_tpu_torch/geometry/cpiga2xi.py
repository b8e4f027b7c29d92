"""Implicit control-points -> intersection-coordinates map (CPIGA2Xi).

Port of goldfish_tpu/geometry/cpiga2xi.py. Given the patches' control
points, find the parametric coordinates xi of n sample points along each
patch-patch intersection, on both sides. Unknowns per intersection, padded
to N points: x = xi (N, 2, 2) flattened (4N). Residual slots (4N):

  block1 (3N): S_A(xiA_k) - S_B(xiB_k)            [coincidence]
  block2 (N-2): |dS_A|^2_{k+1} - |dS_A|^2_k       [uniform spacing]
  block3 (2):  xiA[0/n-1, end_dir] - end_val      [ends slide on edges]

Padded points k >= n are pinned to their initial values through the
padded slots of blocks 1-2; intersections whose curves run along
parametric edges on both sides use the edge-to-edge variant of block 1.

Residual, Jacobian, Newton step and control-point adjoint come from kernel
K7 `c2x_res_jac` (csrc/c2x_res_jac.cu) on CUDA tensors and from its plain
PyTorch version (the residual on ops/bspline_traced's plain rows,
differentiated by autograd; batched f64 `torch.linalg.solve`) on CPU
tensors. K7's mode 2 is one fused Newton step (residual, Jacobian, the
solve in the block's shared memory, the trial residual and both norms;
the reference's `_c2x_step`) and mode 3 the fused adjoint (the transposed
solve and the cp pullback; `_c2x_adjoint_direct`), for seams of up to
FUSED_N_MAX = 39 points (`fused_route`); longer seams take the composed
route: mode 0, the batched solve, mode 0 or mode 1. Mode 4 is the
forward tangent dR/dcp . tcp (`c2x_res_jvp`, the CP -> xi operation's
`apply_linear_fwd` in cp). The reference's
f32-LU + IR path exists only because the TPU has no batched f64 LU, and
does not cross.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.ops.bspline_traced import (
    SurfSet,
    _rows_plain,
    _surf_set_args,
    _surf_set_dims,
    make_surf_set,
)

__all__ = ["MovingIntersections", "build_moving_intersections",
           "c2x_res_jac", "c2x_res_vjp", "c2x_res_jvp", "c2x_step",
           "c2x_solve_adjoint",
           "fused_route", "c2x_newton", "c2x_adjoint", "CPIGA2Xi",
           "xi_edge_constraints", "xi_interior_dofs"]


class MovingIntersections(NamedTuple):
    """Padded tensors; I intersections, N max points each."""

    pairA: torch.Tensor    # (I,) int32
    pairB: torch.Tensor    # (I,)
    n_pts: torch.Tensor    # (I,) int32 real points
    mask: torch.Tensor     # (I, N) 1.0 for real points
    end_dir: torch.Tensor  # (I, 2) int32: pinned coordinate at each end (A)
    end_val: torch.Tensor  # (I, 2)
    xi0: torch.Tensor      # (I, N, 2, 2) initial [.., 0, :]=xiA, [.., 1, :]=xiB
    both_edges: torch.Tensor  # (I,) 1.0 when both sides are edge curves
    epin_dir: torch.Tensor    # (I, 2) int32: pinned coord on side A / B
    epin_val: torch.Tensor    # (I, 2)

    @property
    def n_int(self):
        return self.pairA.shape[0]

    @property
    def n_max(self):
        return self.mask.shape[1]


def build_moving_intersections(specs, n_pts_list, device=None):
    """specs: InterfaceSpec-like objects (straight segments or parametric
    polylines); n_pts_list: points per intersection (>= 3). End pinning
    follows each end segment's dominant parametric direction on side A.
    The reference's NumPy builder, ending in tensors on `device`."""
    from goldfish_tpu_torch.physics.coupling import (
        polyline_interp,
        spec_polylines,
    )

    device = as_device(device)
    I = len(specs)
    N = max(n_pts_list)
    pairA = np.zeros(I, dtype=np.int32)
    pairB = np.zeros(I, dtype=np.int32)
    n_pts = np.asarray(n_pts_list, dtype=np.int32)
    mask = np.zeros((I, N))
    end_dir = np.zeros((I, 2), dtype=np.int32)
    end_val = np.zeros((I, 2))
    xi0 = np.zeros((I, N, 2, 2))
    both_edges = np.zeros(I)
    epin_dir = np.zeros((I, 2), dtype=np.int32)
    epin_val = np.zeros((I, 2))
    edge_side = np.zeros((I, 2), dtype=bool)
    for i, spec in enumerate(specs):
        pairA[i], pairB[i] = spec.pair
        n = int(n_pts[i])
        if n < 3:
            raise ValueError("an intersection needs at least 3 points")
        mask[i, :n] = 1.0
        plA, plB = spec_polylines(spec)
        s = np.linspace(0.0, 1.0, n)
        xi0[i, :n, 0, :], _ = polyline_interp(plA, s)
        xi0[i, :n, 1, :], _ = polyline_interp(plB, s)
        d0 = np.abs(plA[1] - plA[0])
        d1 = np.abs(plA[-1] - plA[-2])
        end_dir[i] = (int(np.argmax(d0)), int(np.argmax(d1)))
        end_val[i] = (plA[0, end_dir[i, 0]], plA[-1, end_dir[i, 1]])
        xi0[i, n:] = xi0[i, n - 1]  # padded points sit at the last real one
        for side, pl in ((0, plA), (1, plB)):
            for c in range(2):
                col = pl[:, c]
                if np.all(np.abs(col - col[0]) < 1e-9) and \
                        (abs(col[0]) < 1e-9 or abs(col[0] - 1) < 1e-9):
                    epin_dir[i, side] = c
                    epin_val[i, side] = col[0]
                    edge_side[i, side] = True
                    break
        both_edges[i] = float(edge_side[i, 0] and edge_side[i, 1])

    def t(a, dtype=DTYPE):
        return tensor(a, device, dtype)

    return MovingIntersections(
        pairA=t(pairA, INDEX_DTYPE), pairB=t(pairB, INDEX_DTYPE),
        n_pts=t(n_pts, INDEX_DTYPE), mask=t(mask),
        end_dir=t(end_dir, INDEX_DTYPE), end_val=t(end_val), xi0=t(xi0),
        both_edges=t(both_edges), epin_dir=t(epin_dir, INDEX_DTYPE),
        epin_val=t(epin_val))


# ------------------------------------------------------------ plain version
def _side_points(ss, p, q, pair, cp, xi_side):
    """S(xi) (I, N, 3) of one side from the plain rows (autograd in xi
    and cp)."""
    I, N = xi_side.shape[:2]
    ip = pair[:, None].expand(I, N).reshape(-1)
    conn, R = _rows_plain(ss, p, q, ip, xi_side.reshape(-1, 2))
    c = cp[ip.long()[:, None], conn.long()]
    return torch.einsum("ml,mlk->mk", R[0], c).reshape(I, N, 3)


def _residual_plain(ss: SurfSet, p, q, mi: MovingIntersections, cp, x):
    """_residual_one of the reference, batched over intersections:
    (I, 4N)."""
    I, N = mi.n_int, mi.n_max
    xi = x.reshape(I, N, 2, 2)
    xiA, xiB = xi[:, :, 0, :], xi[:, :, 1, :]
    ptsA = _side_points(ss, p, q, mi.pairA, cp, xiA)
    ptsB = _side_points(ss, p, q, mi.pairB, cp, xiB)
    k = torch.arange(N, device=x.device)
    real = mi.mask > 0.5
    ii = torch.arange(I, device=x.device)
    last = mi.n_pts.long() - 1

    coin = ptsA - ptsB
    tan = torch.roll(ptsA, -1, 1) - torch.roll(ptsA, 1, 1)
    tan = torch.cat([(ptsA[:, 1] - ptsA[:, 0])[:, None], tan[:, 1:]], 1)
    tan_last = ptsA[ii, last] - ptsA[ii, (last - 1).clamp(min=0)]
    tan = torch.where((k[None, :] >= last[:, None])[..., None],
                      tan_last[:, None, :], tan)
    that = tan / (torch.linalg.norm(tan, dim=-1, keepdim=True) + 1e-300)
    ed = mi.epin_dir.long()
    coin_edge = torch.stack([
        xiA.gather(2, ed[:, 0, None, None].expand(I, N, 1))[..., 0]
        - mi.epin_val[:, 0, None],
        xiB.gather(2, ed[:, 1, None, None].expand(I, N, 1))[..., 0]
        - mi.epin_val[:, 1, None],
        (coin * that).sum(-1)], -1)
    coin = torch.where((mi.both_edges > 0.5)[:, None, None], coin_edge, coin)
    xi0 = mi.xi0
    pin1 = torch.stack([xi[..., 0, 0] - xi0[..., 0, 0],
                        xi[..., 0, 1] - xi0[..., 0, 1],
                        xi[..., 1, 0] - xi0[..., 1, 0]], -1)
    b1 = torch.where(real[..., None], coin, pin1).reshape(I, 3 * N)

    seg = ((ptsA[:, 1:] - ptsA[:, :-1]) ** 2).sum(-1)
    sp = seg[:, 1:] - seg[:, :-1]
    pin2 = xi[:, 2:, 1, 1] - xi0[:, 2:, 1, 1]
    b2 = torch.where(real[:, 2:], sp, pin2)

    edir = mi.end_dir.long()
    b3 = torch.stack([xiA[ii, 0, edir[:, 0]] - mi.end_val[:, 0],
                      xiA[ii, last, edir[:, 1]] - mi.end_val[:, 1]], -1)
    return torch.cat([b1, b2, b3], -1)


def _res_jac_plain(ss, p, q, mi, cp, x, jac):
    r = _residual_plain(ss, p, q, mi, cp, x)
    if not jac:
        return r, None
    I = x.shape[0]
    Jf = torch.autograd.functional.jacobian(
        lambda xx: _residual_plain(ss, p, q, mi, cp, xx), x, vectorize=True)
    ii = torch.arange(I, device=x.device)
    return r, Jf[ii, :, ii, :]


def _res_jvp_plain(ss, p, q, mi, cp, x, tcp):
    """Plain version of K7 mode 4: torch.func.jvp of the residual in
    cp."""
    return torch.func.jvp(lambda c: _residual_plain(ss, p, q, mi, c, x),
                          (cp,), (tcp,))[1]


def _res_vjp_plain(ss, p, q, mi, cp, x, lam):
    with torch.enable_grad():
        cpv = cp.detach().requires_grad_(True)
        r = _residual_plain(ss, p, q, mi, cpv, x.detach())
        return torch.autograd.grad(r, cpv, grad_outputs=-lam)[0]


def _step(res_jac, ss, p, q, mi, cp, x):
    """One full Newton step on `res_jac` (the plain version, or K7 mode 0)
    and batched f64 `torch.linalg.solve`: (x + dx, norms (I, 2) = |r(x)|,
    |r(x + dx)| per intersection)."""
    r, J = res_jac(ss, p, q, mi, cp, x, True)
    x_new = x + torch.linalg.solve(J, -r[..., None])[..., 0]
    r_new, _ = res_jac(ss, p, q, mi, cp, x_new, False)
    return x_new, torch.stack([torch.linalg.norm(r, dim=-1),
                               torch.linalg.norm(r_new, dim=-1)], -1)


def _adjoint(res_jac, res_vjp, ss, p, q, mi, cp, x, g):
    """dR/dx^T lam = g by batched f64 `torch.linalg.solve`, then
    dcp = -lam^T dR/dcp, on `res_jac`, `res_vjp` (the plain versions, or
    K7 modes 0 and 1)."""
    _, J = res_jac(ss, p, q, mi, cp, x, True)
    lam = torch.linalg.solve(J.transpose(-1, -2), g[..., None])[..., 0]
    return res_vjp(ss, p, q, mi, cp, x, lam.contiguous())


def _step_plain(ss, p, q, mi, cp, x):
    """Plain version of K7 mode 2."""
    return _step(_res_jac_plain, ss, p, q, mi, cp, x)


def _adjoint_plain(ss, p, q, mi, cp, x, g):
    """Plain version of K7 mode 3."""
    return _adjoint(_res_jac_plain, _res_vjp_plain, ss, p, q, mi, cp, x, g)


# ------------------------------------------------------------ K7 wrappers
_MI_INT = ("pairA", "pairB", "n_pts")
# the longest seam K7's modes 2 and 3 hold: csrc/c2x_res_jac.cu's
# FUSED_N_MAX, where static_asserts hold it to the block's shared memory
FUSED_N_MAX = 39


def fused_route(N: int) -> bool:
    """Whether K7's fused step and adjoint (modes 2, 3) hold a seam of N
    points (N <= FUSED_N_MAX: the 4N x (4N + 1) augmented system and the
    rest fit one block's shared memory). Longer seams take the composed
    route: mode 0, batched `torch.linalg.solve`, mode 0 or mode 1. A choice
    by size, made before any launch."""
    return N <= FUSED_N_MAX


def _check_inputs(ss, mi, cp, x, vec=None):
    I, N = mi.n_int, mi.n_max
    dev = x.device
    for name in _MI_INT:
        _cuda.check(getattr(mi, name), name, INDEX_DTYPE, (I,), dev)
    _cuda.check(mi.end_dir, "end_dir", INDEX_DTYPE, (I, 2), dev)
    _cuda.check(mi.epin_dir, "epin_dir", INDEX_DTYPE, (I, 2), dev)
    _cuda.check(mi.end_val, "end_val", DTYPE, (I, 2), dev)
    _cuda.check(mi.epin_val, "epin_val", DTYPE, (I, 2), dev)
    _cuda.check(mi.both_edges, "both_edges", DTYPE, (I,), dev)
    _cuda.check(mi.xi0, "xi0", DTYPE, (I, N, 2, 2), dev)
    _cuda.check(mi.mask, "mask", DTYPE, (I, N), dev)
    _cuda.check(cp, "cp", DTYPE, (ss.w.shape[0], ss.w.shape[1], 3), dev)
    _cuda.check(x, "x", DTYPE, (I, 4 * N), dev)
    if vec is not None:
        _cuda.check(vec, "lam/g", DTYPE, (I, 4 * N), dev)
    return I, N


def _launch(mode, counter, ss, p, q, mi, cp, x, vec=None, res=None, J=None,
            xnew=None, norms=None, part=None, dcp=None):
    P = _cuda.ptr
    _cuda.launch(counter, "gf_c2x_res_jac", mode, *_surf_set_args(ss),
                 P(mi.pairA), P(mi.pairB), P(mi.n_pts), P(mi.end_dir),
                 P(mi.end_val), P(mi.xi0), P(mi.both_edges), P(mi.epin_dir),
                 P(mi.epin_val), P(cp), P(x), P(vec), P(res), P(J), P(xnew),
                 P(norms), P(part), P(dcp), *_surf_set_dims(ss, p, q),
                 cp.shape[0], mi.n_int, mi.n_max)


def _partial(mi, cp):
    """Per-intersection dcp partials (I, 2, C, 3) of modes 1 and 3."""
    return torch.empty(mi.n_int, 2, cp.shape[1], 3, dtype=DTYPE,
                       device=cp.device)


def c2x_res_jac(ss: SurfSet, p: int, q: int, mi: MovingIntersections, cp,
                x, jac: bool = True):
    """K7 mode 0: the residual (I, 4N) and, with `jac`, the dense Jacobian
    dR/dx (I, 4N, 4N) (else None); the kernel writes every entry."""
    I, N = _check_inputs(ss, mi, cp, x)
    if not _cuda.on_cuda(x):
        return _res_jac_plain(ss, p, q, mi, cp, x, jac)
    res = torch.empty(I, 4 * N, dtype=DTYPE, device=x.device)
    J = torch.empty(I, 4 * N, 4 * N, dtype=DTYPE, device=x.device) \
        if jac else None
    _launch(0, "c2x_res_jac/res_jac", ss, p, q, mi, cp, x, res=res, J=J)
    return res, J


def c2x_res_vjp(ss: SurfSet, p: int, q: int, mi: MovingIntersections, cp,
                x, lam):
    """K7 mode 1: -lam^T dR/dcp (P, C, 3), summed in a fixed order."""
    _check_inputs(ss, mi, cp, x, lam)
    if not _cuda.on_cuda(x):
        return _res_vjp_plain(ss, p, q, mi, cp, x, lam)
    dcp = torch.empty_like(cp)
    _launch(1, "c2x_res_jac/adjoint", ss, p, q, mi, cp, x, vec=lam,
            part=_partial(mi, cp), dcp=dcp)
    return dcp


def c2x_res_jvp(ss: SurfSet, p: int, q: int, mi: MovingIntersections, cp,
                x, tcp):
    """K7 mode 4: dR/dcp . tcp (I, 4N) at x for a tangent tcp (P, C, 3),
    for the rows of mode 0 (not linear in cp: the edge rows' unit chord
    and the spacing rows' squared lengths); every entry written."""
    I, N = _check_inputs(ss, mi, cp, x)
    _cuda.check(tcp, "tcp", DTYPE, tuple(cp.shape), x.device)
    if not _cuda.on_cuda(x):
        return _res_jvp_plain(ss, p, q, mi, cp, x, tcp)
    res = torch.empty(I, 4 * N, dtype=DTYPE, device=x.device)
    _launch(4, "c2x_res_jac/cp_fwd", ss, p, q, mi, cp, x, vec=tcp, res=res)
    return res


def c2x_step(ss: SurfSet, p: int, q: int, mi: MovingIntersections, cp, x):
    """K7 mode 2, one fused full Newton step: (x + dx (I, 4N), norms (I,
    2)) with dR/dx dx = -R(x) and norms[:, 0] = |R(x)|, norms[:, 1] =
    |R(x + dx)| per intersection. Only for seams of the fused route."""
    I, N = _check_inputs(ss, mi, cp, x)
    if not _cuda.on_cuda(x):
        return _step_plain(ss, p, q, mi, cp, x)
    if not fused_route(N):
        raise ValueError(f"K7's fused step holds seams of up to "
                         f"{FUSED_N_MAX} points, not {N}: take the composed "
                         f"route")
    x_new = torch.empty_like(x)
    norms = torch.empty(I, 2, dtype=DTYPE, device=x.device)
    _launch(2, "c2x_res_jac/step", ss, p, q, mi, cp, x, xnew=x_new,
            norms=norms)
    return x_new, norms


def c2x_solve_adjoint(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                      cp, x, g):
    """K7 mode 3, the fused implicit-function backward: dR/dx^T lam = g,
    then -lam^T dR/dcp (P, C, 3), the same bit for bit from launch to
    launch. Only for seams of the fused route."""
    _, N = _check_inputs(ss, mi, cp, x, g)
    if not _cuda.on_cuda(x):
        return _adjoint_plain(ss, p, q, mi, cp, x, g)
    if not fused_route(N):
        raise ValueError(f"K7's fused adjoint holds seams of up to "
                         f"{FUSED_N_MAX} points, not {N}: take the composed "
                         f"route")
    dcp = torch.empty_like(cp)
    _launch(3, "c2x_res_jac/solve_adjoint", ss, p, q, mi, cp, x, vec=g,
            part=_partial(mi, cp), dcp=dcp)
    return dcp


def _step_composed(ss, p, q, mi, cp, x):
    """The step of seams past the fused route: mode 0, the batched solve,
    mode 0 at x + dx."""
    return _step(c2x_res_jac, ss, p, q, mi, cp, x)


def _adjoint_composed(ss, p, q, mi, cp, x, g):
    """The adjoint of seams past the fused route: mode 0, the transposed
    batched solve, mode 1."""
    return _adjoint(c2x_res_jac, c2x_res_vjp, ss, p, q, mi, cp, x, g)


# ------------------------------------------------------------ solves
def _rnorm(r):
    """Max per-intersection residual norm (the reference's convergence
    measure: an aggregate norm can hide one badly converged seam)."""
    return float(torch.linalg.norm(r, dim=-1).max())


def c2x_newton(ss, p, q, mi, cp, x0, rtol=1e-12, max_it=20):
    """Batched Newton over intersections (the reference's host loop,
    `_c2x_newton_host`): a full step (K7 mode 2, or the composed route past
    its size) with one readback of the two max per-intersection norms; the
    step is accepted on sufficient decrease, otherwise a backtracking step
    on mode 0 and `torch.linalg.solve` is taken. Returns (x, iterations,
    residual norm)."""
    step = c2x_step if fused_route(mi.n_max) else _step_composed
    x = x0
    for it in range(max_it):
        x_new, norms = step(ss, p, q, mi, cp, x)
        # one readback; the max in Python: a CPU torch op right after the
        # optimizer's NumPy work can wait ~10-30 ms on the CPU thread pool
        rows = norms.tolist()
        rn, rn_new = max(r[0] for r in rows), max(r[1] for r in rows)
        if rn <= rtol:
            return x, it, rn
        if rn_new <= (1 - 1e-4) * rn:
            x = x_new
            if rn_new <= rtol:
                return x, it + 1, rn_new
            continue
        # the full step did not contract (a cold or pathological state):
        # backtrack on the batched residual norm
        r, J = c2x_res_jac(ss, p, q, mi, cp, x)
        dx = torch.linalg.solve(J, -r[..., None])[..., 0]
        alpha = 1.0
        for _ in range(20):
            rt, _ = c2x_res_jac(ss, p, q, mi, cp, x + alpha * dx, jac=False)
            if _rnorm(rt) <= (1 - 1e-4 * alpha) * rn:
                break
            alpha *= 0.5
        x = x + alpha * dx
    r, _ = c2x_res_jac(ss, p, q, mi, cp, x, jac=False)
    return x, max_it, _rnorm(r)


def c2x_adjoint(ss, p, q, mi, cp, x, g):
    """Implicit-function backward: dR/dx^T lam = g, dcp = -lam^T dR/dcp
    (the reference's `_c2x_adjoint_direct`): K7 mode 3, or the composed
    route past its size."""
    if fused_route(mi.n_max):
        return c2x_solve_adjoint(ss, p, q, mi, cp, x, g)
    return _adjoint_composed(ss, p, q, mi, cp, x, g)


class _SolveXi(torch.autograd.Function):

    @staticmethod
    def forward(ctx, c2x, cp, x0):
        cp = cp.detach()
        x, its, _ = c2x_newton(c2x.ss, c2x.p, c2x.q, c2x.mi, cp,
                                x0.detach().clone(), rtol=c2x.rtol,
                                max_it=c2x.max_it)
        c2x.last_its = its
        ctx.c2x = c2x
        ctx.save_for_backward(cp, x)
        return x

    @staticmethod
    def backward(ctx, g):
        cp, x = ctx.saved_tensors
        c2x = ctx.c2x
        dcp = c2x_adjoint(c2x.ss, c2x.p, c2x.q, c2x.mi, cp, x,
                          g.contiguous())
        return None, dcp, None


class CPIGA2Xi:
    """Differentiable xi(cp): batched Newton forward, implicit-function
    adjoint backward (a `torch.autograd.Function`)."""

    def __init__(self, surfs, specs, n_pts_list=None, rtol=1e-12,
                 max_it=20, device=None):
        self.device = as_device(device)
        self.surfs = surfs
        self.ss, (self.p, self.q) = make_surf_set(surfs, device=self.device)
        if n_pts_list is None:
            n_pts_list = [max(int(s.n_mortar_el) + 1, 3) for s in specs]
        self.mi = build_moving_intersections(specs, n_pts_list,
                                             device=self.device)
        self.rtol = rtol
        self.max_it = max_it
        self.last_its = None   # Newton iterations of the last solve

    @property
    def route(self):
        """The xi solve's route, by the seams' size: "fused" (K7 modes 2
        and 3) or "composed" (mode 0, the batched solve, mode 0 or 1)."""
        return "fused" if fused_route(self.mi.n_max) else "composed"

    @property
    def xi0_flat(self):
        I, N = self.mi.n_int, self.mi.n_max
        return self.mi.xi0.reshape(I, 4 * N)

    def solve(self, cp, x0=None):
        """Differentiable xi(cp): (I, 4N) flattened coordinates."""
        x0 = self.xi0_flat if x0 is None else x0
        return _SolveXi.apply(self, cp, x0)

    def residual_norm(self, cp, x):
        r, _ = c2x_res_jac(self.ss, self.p, self.q, self.mi, cp, x,
                           jac=False)
        return _rnorm(r)


# ------------------------------------------------------------ xi constraints
def _host(mi: MovingIntersections):
    """The host copies that the xi constraint functions read."""
    xi0 = mi.xi0.cpu().numpy()
    return xi0, mi.n_pts.cpu().numpy(), xi0.shape[0], xi0.shape[1]


def xi_edge_constraints(mi: MovingIntersections, tol: float = 1e-9):
    """Edge-type xi constraints (the reference's IntXiEdgeComp: xi_dof -
    val = 0 with a constant 0/1 Jacobian).

    For every intersection whose initial curve runs along a constant
    parametric coordinate of side A or B at 0 or 1, the flat dof indices
    (into the (I, N, 2, 2)-raveled xi vector) and target values pinning
    that coordinate for all real points. Host NumPy on `mi`'s copies."""
    xi0, n_pts, I, N = _host(mi)
    dofs, vals = [], []
    for i in range(I):
        n = int(n_pts[i])
        for side in (0, 1):
            for c in (0, 1):
                col = xi0[i, :n, side, c]
                if np.all(np.abs(col - col[0]) < tol) and \
                        (abs(col[0]) < tol or abs(col[0] - 1) < tol):
                    for k in range(n):
                        dofs.append(((i * N + k) * 2 + side) * 2 + c)
                        vals.append(float(col[0]))
    return np.asarray(dofs, dtype=np.int64), np.asarray(vals)


def xi_interior_dofs(mi: MovingIntersections, tol: float = 1e-9):
    """Flat dofs of the xi vector free to move strictly inside (0, 1): the
    support of in-domain bound constraints (the reference's XiConsComp).

    Excludes (a) padded points beyond each intersection's n_pts, (b) the
    edge-pinned columns of `xi_edge_constraints`, (c) the end-pinned
    coordinates (end_dir at the first and last point), and (d) side-B
    endpoint coordinates on the 0/1 boundary at an end whose side-A pin
    (`end_val`) is itself at 0/1: there the seam ends on patch A's edge and
    coincidence holds the side-B coordinate on its own edge. A coordinate
    that merely starts at 0/1 without that force stays in the set. Host
    NumPy on `mi`'s copies."""
    xi0, n_pts, I, N = _host(mi)
    end_dir = mi.end_dir.cpu().numpy()
    end_val = mi.end_val.cpu().numpy()
    edge_dofs = set(xi_edge_constraints(mi, tol=tol)[0].tolist())

    def boundary_end(i, k, n):
        # which end (0/1) this point is, or None if interior; the end
        # counts only if its side-A pin value is on the domain boundary
        end = 0 if k == 0 else (1 if k == n - 1 else None)
        if end is None:
            return None
        ev = float(end_val[i, end])
        return end if (abs(ev) < tol or abs(ev - 1.0) < tol) else None

    out = []
    for i in range(I):
        n = int(n_pts[i])
        for k in range(n):
            for side in (0, 1):
                for c in (0, 1):
                    dof = ((i * N + k) * 2 + side) * 2 + c
                    if dof in edge_dofs:
                        continue
                    if side == 0 and (
                            (k == 0 and c == int(end_dir[i, 0]))
                            or (k == n - 1 and c == int(end_dir[i, 1]))):
                        continue
                    v = float(xi0[i, k, side, c])
                    if (side == 1
                            and boundary_end(i, k, n) is not None
                            and (abs(v) < tol or abs(v - 1.0) < tol)):
                        continue
                    out.append(dof)
    return np.asarray(out, dtype=np.int64)
