"""St. Venant-Kirchhoff Kirchhoff-Love shell energy, batched over patches.

Port of goldfish_tpu/physics/kl_shell.py (value, residual, element
Hessians and the residual's design VJP). The strain energy is

    W = sum_qp psi(X, z, h) J_ref w,
    psi = h/2 eps:H:eps + h^3/24 kappa:H:kappa,

with eps = (a - A)/2, kappa = B - b in curvilinear components. At a
quadrature point the density depends on the geometry and the
displacement only through their 15-component jets
(d/du, d/dv, d2/du2, d2/dudv, d2/dv2) x 3, so every derivative the solver
needs is a per-qp derivative in the jet, mapped to control points by the
basis rows:

- `shell_value_grad`: per-element energy, r_shell = dW/dd, dW/dh;
- `shell_hessians`: the per-qp 15x15 jet Hessian H_q (K = sum B^T H_q B);
- `shell_adjoint`: -d/d(cp, h) of lambda^T r_shell;
- `shell_geom_grad`: dW/dcp, the energy's direct control-point gradient
  (shape optimization);
- `shell_design_jvp`: d r_shell along a design tangent (tcp, th), the
  forward product of the implicit operations' `apply_linear_fwd`.

Each of the five runs the CUDA kernel K1 `shell_qp`
(csrc/shell_qp.cu: hand-written reverse sweeps of the density) on CUDA
tensors and its plain PyTorch version (torch.func on `shell_density`) on
CPU tensors.

The von Mises stress at the qps (`qp_stress_vm`, the stress constraint's
field) is K9 `vm_stress_qp` (csrc/vm_stress_qp.cu) on CUDA tensors: mode 0
the value, mode 1 its VJP in (d, cp, h) (a hand-written reverse sweep a
qp, per-element partials, then each node's sum over the stack's
`node_incidence` in a fixed order), mode 2 every qp's own Jacobian row
(the same sweep with a cotangent of 1, the field's dense Jacobian);
`stress_density` with autograd or torch.func on CPU tensors.
"""

from __future__ import annotations

import weakref

import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE
from goldfish_tpu_torch.geometry.patch_stack import PatchStack

__all__ = ["gather", "shell_density", "shell_density_increments",
           "shell_value_grad", "shell_hessians",
           "shell_adjoint", "shell_geom_grad", "shell_design_jvp",
           "internal_energy", "element_hessians",
           "stress_density", "vm_stress_value", "vm_stress_vjp",
           "vm_stress_rows",
           "qp_stress_vm", "volume", "external_work_dead_load",
           "dead_load_force"]

NJ = 15  # displacement / geometry jet size


def gather(coef, conn):
    """coef: (P, C, k), conn: (P, E, L) -> (P, E, L, k)."""
    p = torch.arange(coef.shape[0], device=coef.device)[:, None, None]
    return coef[p, conn.long()]


def _jet_tables(stack: PatchStack):
    return (stack.R10, stack.R01, stack.R20, stack.R11, stack.R02)


def jets(stack: PatchStack, coef):
    """(P, C, 3) field -> (P, E, Q, 15) jets at every qp."""
    ce = gather(coef, stack.conn)
    return torch.cat([torch.einsum("peql,pelk->peqk", R, ce)
                      for R in _jet_tables(stack)], dim=-1)


def h_at_qps(stack: PatchStack, h):
    """(P, C) thickness coefficients -> (P, E, Q)."""
    return torch.einsum("peql,pel->peq", stack.R00, gather(h[..., None],
                                                           stack.conn)[..., 0])


def _scatter_jets(stack: PatchStack, gz, C):
    """B^T g: (P, E, Q, 15) jet cotangents -> (P, C, 3)."""
    P = gz.shape[0]
    contrib = sum(torch.einsum("peql,peqk->pelk", R, gz[..., 3 * j:3 * j + 3])
                  for j, R in enumerate(_jet_tables(stack)))
    return _index_add_nodes(stack.conn, contrib, P, C)


def _scatter_h(stack: PatchStack, gh, C):
    """R00^T g: (P, E, Q) -> (P, C)."""
    contrib = torch.einsum("peql,peq->pel", stack.R00, gh)
    return _index_add_nodes(stack.conn, contrib[..., None], gh.shape[0],
                            C)[..., 0]


def _index_add_nodes(conn, contrib, P, C):
    node = (torch.arange(P, device=conn.device)[:, None, None] * C
            + conn.long()).reshape(-1)
    k = contrib.shape[-1]
    out = torch.zeros(P * C, k, dtype=contrib.dtype, device=contrib.device)
    out.index_add_(0, node, contrib.reshape(-1, k))
    return out.reshape(P, C, k)


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _quad_form(A, s, c, nu):
    """SVK quadratic form E/(1-nu^2)[nu tr^2 + (1-nu) Aup s Aup : s] with
    symmetric 2x2 tensors stored as (11, 12, 22)."""
    tr = A[0] * s[0] + 2.0 * (A[1] * s[1]) + A[2] * s[2]
    m11 = A[0] * s[0] + A[1] * s[1]
    m12 = A[0] * s[1] + A[1] * s[2]
    m21 = A[1] * s[0] + A[2] * s[1]
    m22 = A[1] * s[1] + A[2] * s[2]
    full = ((m11 * A[0] + m12 * A[1]) * s[0]
            + ((m11 * A[1] + m12 * A[2]) + (m21 * A[0] + m22 * A[1])) * s[1]
            + (m21 * A[1] + m22 * A[2]) * s[2])
    return c * (nu * (tr * tr) + (1.0 - nu) * full)


def shell_density(X, z, h, E, nu, wq):
    """psi * J_ref * w per qp. X, z: (..., 15) geometry / displacement
    jets; h, E, nu, wq: (...). The plain version of K1's density (the
    kernel sweeps the same formula back by hand: csrc/shell_qp.cu,
    `shell_sweep`)."""
    A1, A2 = X[..., 0:3], X[..., 3:6]
    A3 = _cross(A1, A2)
    J = torch.sqrt(_dot(A3, A3))
    A3 = A3 / J[..., None]
    a = (_dot(A1, A1), _dot(A1, A2), _dot(A2, A2))
    b = (_dot(X[..., 6:9], A3), _dot(X[..., 9:12], A3),
         _dot(X[..., 12:15], A3))
    x = X + z
    a3 = _cross(x[..., 0:3], x[..., 3:6])
    a3 = a3 / torch.sqrt(_dot(a3, a3))[..., None]
    ac = (_dot(x[..., 0:3], x[..., 0:3]), _dot(x[..., 0:3], x[..., 3:6]),
          _dot(x[..., 3:6], x[..., 3:6]))
    bc = (_dot(x[..., 6:9], a3), _dot(x[..., 9:12], a3),
          _dot(x[..., 12:15], a3))
    eps = tuple(0.5 * (ac[i] - a[i]) for i in range(3))
    kap = tuple(b[i] - bc[i] for i in range(3))
    det = a[0] * a[2] - a[1] * a[1]
    Aup = (a[2] / det, -a[1] / det, a[0] / det)
    c = E / (1.0 - nu * nu)
    psi = (0.5 * h) * _quad_form(Aup, eps, c, nu) \
        + ((h * h * h) / 24.0) * _quad_form(Aup, kap, c, nu)
    return psi * J * wq


def shell_density_increments(X, z, h, E, nu, wq):
    """`shell_density` with the strains formed from the displacement's
    increments, free of the cancellation in a - A and b - bc when |z| <<
    |X|: eps = (X_u.z_u + z_u.z_u/2, (X_u.z_v + z_u.X_v + z_u.z_v)/2, X_v.z_v
    + z_v.z_v/2) and kap = -(X_s.(a3 - A3) + z_s.a3), a3 - A3 formed from
    n - n0 = X_u x z_v + z_u x X_v + z_u x z_v. The same density in exact
    arithmetic; near a linear-regime state it is the yardstick of the
    rounding that every f64 evaluation of the plain form carries (ROADMAP
    C6)."""
    A1, A2 = X[..., 0:3], X[..., 3:6]
    z1, z2 = z[..., 0:3], z[..., 3:6]
    n0 = _cross(A1, A2)
    J = torch.sqrt(_dot(n0, n0))
    a = (_dot(A1, A1), _dot(A1, A2), _dot(A2, A2))
    eps = (_dot(A1, z1) + 0.5 * _dot(z1, z1),
           0.5 * (_dot(A1, z2) + _dot(z1, A2) + _dot(z1, z2)),
           _dot(A2, z2) + 0.5 * _dot(z2, z2))
    dn = _cross(A1, z2) + _cross(z1, A2) + _cross(z1, z2)
    n = n0 + dn
    ln = torch.sqrt(_dot(n, n))
    a3 = n / ln[..., None]
    # a3 - A3 = dn/|n| + n0 (|n0| - |n|)/(|n| |n0|), |n0| - |n| = -(2 n0.dn
    # + dn.dn)/(|n0| + |n|)
    da3 = dn / ln[..., None] - n0 * ((2.0 * _dot(n0, dn) + _dot(dn, dn))
                                     / (ln * J * (J + ln)))[..., None]
    kap = tuple(-(_dot(X[..., 6 + 3 * i:9 + 3 * i], da3)
                  + _dot(z[..., 6 + 3 * i:9 + 3 * i], a3)) for i in range(3))
    det = a[0] * a[2] - a[1] * a[1]
    Aup = (a[2] / det, -a[1] / det, a[0] / det)
    c = E / (1.0 - nu * nu)
    psi = (0.5 * h) * _quad_form(Aup, eps, c, nu) \
        + ((h * h * h) / 24.0) * _quad_form(Aup, kap, c, nu)
    return psi * J * wq


def _qp_params(stack, E, nu):
    shp = stack.wq.shape
    return (E[:, None, None].expand(shp), nu[:, None, None].expand(shp),
            stack.wq)


# ------------------------------------------------------------ plain versions
def _value_grad_plain(stack, d, cp, h, E, nu, density=shell_density):
    X, z, hq = jets(stack, cp), jets(stack, d), h_at_qps(stack, h)
    Eq, nuq, wq = _qp_params(stack, E, nu)
    vals, vjp = torch.func.vjp(
        lambda zz, hh: density(X, zz, hh, Eq, nuq, wq), z, hq)
    gz, gh = vjp(torch.ones_like(vals))
    C = d.shape[1]
    return vals.sum(-1), _scatter_jets(stack, gz, C), _scatter_h(stack, gh, C)


def _hessians_plain(stack, d, cp, h, E, nu):
    X, z, hq = jets(stack, cp), jets(stack, d), h_at_qps(stack, h)
    Eq, nuq, wq = _qp_params(stack, E, nu)
    shp = hq.shape
    # reverse over reverse: in eager PyTorch ~4x faster than hessian's
    # forward over reverse, the same values to rounding
    H = torch.func.vmap(torch.func.jacrev(
        torch.func.grad(shell_density, argnums=1), argnums=1))(
        X.reshape(-1, NJ), z.reshape(-1, NJ), hq.reshape(-1),
        Eq.reshape(-1), nuq.reshape(-1), wq.reshape(-1))
    return H.reshape(shp + (NJ, NJ))


def _adjoint_plain(stack, d, cp, h, E, nu, lam):
    X, z, hq = jets(stack, cp), jets(stack, d), h_at_qps(stack, h)
    lz = jets(stack, lam)
    Eq, nuq, wq = _qp_params(stack, E, nu)

    def lam_dot_grad(XX, hh):
        gz = torch.func.grad(
            lambda zz: shell_density(XX, zz, hh, Eq, nuq, wq).sum())(z)
        return (gz * lz).sum()

    gX, gh = torch.func.grad(lam_dot_grad, argnums=(0, 1))(X, hq)
    C = d.shape[1]
    return -_scatter_jets(stack, gX, C), -_scatter_h(stack, gh, C)


def _geom_grad_plain(stack, d, cp, h, E, nu):
    X, z, hq = jets(stack, cp), jets(stack, d), h_at_qps(stack, h)
    Eq, nuq, wq = _qp_params(stack, E, nu)
    gX = torch.func.grad(
        lambda XX: shell_density(XX, z, hq, Eq, nuq, wq).sum())(X)
    return _scatter_jets(stack, gX, d.shape[1])


def _design_jvp_plain(stack, d, cp, h, E, nu, tcp, th):
    return torch.func.jvp(
        lambda c, hh: _value_grad_plain(stack, d, c, hh, E, nu)[1],
        (cp, h), (tcp, th))[1]


# ------------------------------------------------------------ K1 wrappers
def _check_inputs(stack, d, cp, h, E, nu, lam=None, th=None):
    P, Ne, Q, L = stack.R00.shape
    C = d.shape[1]
    dev = d.device
    for name in ("R00", "R10", "R01", "R20", "R11", "R02"):
        _cuda.check(getattr(stack, name), name, DTYPE, (P, Ne, Q, L), dev)
    _cuda.check(stack.conn, "conn", INDEX_DTYPE, (P, Ne, L), dev)
    _cuda.check(stack.wq, "wq", DTYPE, (P, Ne, Q), dev)
    _cuda.check(d, "d", DTYPE, (P, C, 3), dev)
    _cuda.check(cp, "cp", DTYPE, (P, C, 3), dev)
    _cuda.check(h, "h", DTYPE, (P, C), dev)
    _cuda.check(E, "E", DTYPE, (P,), dev)
    _cuda.check(nu, "nu", DTYPE, (P,), dev)
    if lam is not None:
        _cuda.check(lam, "lam", DTYPE, (P, C, 3), dev)
    if th is not None:
        _cuda.check(th, "th", DTYPE, (P, C), dev)
    return P, Ne, Q, L, C


def _launch(mode, counter, stack, d, cp, h, E, nu, lam, out_w, out_f, out_h,
            dims, th=None):
    p = _cuda.ptr
    _cuda.launch(counter, "gf_shell_qp", mode,
                 p(stack.R00), p(stack.R10), p(stack.R01), p(stack.R20),
                 p(stack.R11), p(stack.R02), p(stack.conn), p(stack.wq),
                 p(d), p(cp), p(h), p(E), p(nu), p(lam), p(th),
                 p(out_w), p(out_f), p(out_h), *dims)


def shell_value_grad(stack: PatchStack, d, cp, h, E, nu):
    """K1 mode (a): (W_e (P, E) per-element energy, r_shell (P, C, 3) =
    dW/dd, dW/dh (P, C)). Sum W_e with torch.sum for a deterministic W."""
    dims = _check_inputs(stack, d, cp, h, E, nu)
    if not _cuda.on_cuda(d):
        return _value_grad_plain(stack, d, cp, h, E, nu)
    P, Ne, Q, L, C = dims
    W = torch.empty(P, Ne, dtype=DTYPE, device=d.device)
    r = torch.zeros(P, C, 3, dtype=DTYPE, device=d.device)
    dh = torch.zeros(P, C, dtype=DTYPE, device=d.device)
    _launch(0, "shell_qp/value_grad", stack, d, cp, h, E, nu, None, W, r, dh,
            dims)
    return W, r, dh


def shell_hessians(stack: PatchStack, d, cp, h, E, nu):
    """K1 mode (b): per-qp jet Hessians H_q (P, E, Q, 15, 15)."""
    dims = _check_inputs(stack, d, cp, h, E, nu)
    if not _cuda.on_cuda(d):
        return _hessians_plain(stack, d, cp, h, E, nu)
    P, Ne, Q, L, C = dims
    H = torch.empty(P, Ne, Q, NJ, NJ, dtype=DTYPE, device=d.device)
    _launch(1, "shell_qp/hess", stack, d, cp, h, E, nu, None, None, H, None,
            dims)
    return H


def shell_adjoint(stack: PatchStack, d, cp, h, E, nu, lam):
    """K1 mode (c): (dcp (P, C, 3), dh (P, C)) = -d/d(cp, h) of
    lam^T r_shell (lam unmasked; the caller masks)."""
    dims = _check_inputs(stack, d, cp, h, E, nu, lam)
    if not _cuda.on_cuda(d):
        return _adjoint_plain(stack, d, cp, h, E, nu, lam)
    P, Ne, Q, L, C = dims
    dcp = torch.zeros(P, C, 3, dtype=DTYPE, device=d.device)
    dh = torch.zeros(P, C, dtype=DTYPE, device=d.device)
    _launch(2, "shell_qp/adjoint", stack, d, cp, h, E, nu, lam, None, dcp,
            dh, dims)
    return dcp, dh


def shell_geom_grad(stack: PatchStack, d, cp, h, E, nu):
    """K1 mode (d): dW/dcp (P, C, 3) at fixed d and h."""
    dims = _check_inputs(stack, d, cp, h, E, nu)
    if not _cuda.on_cuda(d):
        return _geom_grad_plain(stack, d, cp, h, E, nu)
    dcp = torch.zeros_like(d)
    _launch(3, "shell_qp/geom_grad", stack, d, cp, h, E, nu, None, None, dcp,
            None, dims)
    return dcp


def shell_design_jvp(stack: PatchStack, d, cp, h, E, nu, tcp, th):
    """K1 mode (e): d/de r_shell(d; cp + e tcp, h + e th) (P, C, 3) at
    fixed d (tcp, th unmasked; the caller masks). The plain version is
    torch.func.jvp of mode (a)'s plain r in (cp, h)."""
    dims = _check_inputs(stack, d, cp, h, E, nu, tcp, th)
    if not _cuda.on_cuda(d):
        return _design_jvp_plain(stack, d, cp, h, E, nu, tcp, th)
    dr = torch.zeros_like(d)
    _launch(4, "shell_qp/design_fwd", stack, d, cp, h, E, nu, tcp, None, dr,
            None, dims, th=th)
    return dr


# ------------------------------------------------------------ public API
class _InternalEnergy(torch.autograd.Function):
    """W(d, cp, h) with dW/dd and dW/dh from K1 mode (a) and dW/dcp from
    K1 mode (d)."""

    @staticmethod
    def forward(ctx, d, cp, h, stack, E, nu):
        d, cp, h = d.detach(), cp.detach(), h.detach()
        W, r, dh = shell_value_grad(stack, d, cp, h, E, nu)
        ctx.save_for_backward(r, dh, d, cp, h)
        ctx.stack, ctx.E, ctx.nu = stack, E, nu
        return W.sum()

    @staticmethod
    def backward(ctx, g):
        r, dh, d, cp, h = ctx.saved_tensors
        gcp = None
        if ctx.needs_input_grad[1]:
            gcp = g * shell_geom_grad(ctx.stack, d, cp, h, ctx.E, ctx.nu)
        return g * r, gcp, g * dh, None, None, None


class _InternalEnergySharded(torch.autograd.Function):
    """W of a patch-sharded system: each rank's patches by K1 mode (a),
    summed by one all-reduce, so every rank holds the same W. The backward
    takes W's cotangent as it is: it is replicated already, and summing it
    again over the ranks (as torch.distributed.nn.functional.all_reduce's
    backward does) would multiply dW by the world size. Each rank's
    gradient covers its own patches' rows; one all-reduce of (dW/dd,
    dW/dh[, dW/dcp]) joins them into the replicated gradient."""

    @staticmethod
    def forward(ctx, d, cp, h, stack, E, nu, shard):
        dl, cpl, hl = (shard.local(t.detach()) for t in (d, cp, h))
        El, nul = shard.local(E), shard.local(nu)
        W, r, dh = shell_value_grad(stack, dl, cpl, hl, El, nul)
        ctx.save_for_backward(r, dh, dl, cpl, hl)
        ctx.stack, ctx.E, ctx.nu, ctx.shard = stack, El, nul, shard
        return shard.mesh.sum(W.sum())

    @staticmethod
    def backward(ctx, g):
        r, dh, dl, cpl, hl = ctx.saved_tensors
        sh = ctx.shard
        parts = [sh.place(g * r), sh.place(g * dh)]
        if ctx.needs_input_grad[1]:
            parts.append(sh.place(g * shell_geom_grad(
                ctx.stack, dl, cpl, hl, ctx.E, ctx.nu)))
        out = sh.mesh.sum(*parts)
        gcp = out[2] if ctx.needs_input_grad[1] else None
        return out[0], gcp, out[1], None, None, None, None


def internal_energy(stack: PatchStack, d, cp, h_coef, E, nu, shard=None):
    """Total SVK KL-shell strain energy (scalar), differentiable in d and
    h by torch autograd. d, cp: (P, C, 3); h_coef: (P, C); E, nu: (P,).
    With `shard` (a patch-sharded system's `SystemData.shard`; `stack` is
    then the rank's block) every rank returns the whole W."""
    if shard is not None:
        return _InternalEnergySharded.apply(d, cp, h_coef, stack, E, nu,
                                            shard)
    return _InternalEnergy.apply(d, cp, h_coef, stack, E, nu)


def _blocks(H, Rs):
    """sum_q B^T H_q B per element: H (P, E, Q, 3nj, 3nj), Rs (P, E, Q, nj,
    L) -> (P, E, 3L, 3L)."""
    P, Ne, Q, nj, L = Rs.shape
    H = H.reshape(P, Ne, Q, nj, 3, nj, 3)
    tmp = torch.einsum("peqjxky,peqkm->peqjxmy", H, Rs)
    Ke = torch.einsum("peqjxmy,peqjl->pelxmy", tmp, Rs)
    return Ke.reshape(P, Ne, 3 * L, 3 * L)


def element_hessians(stack: PatchStack, d, cp, h_coef, E, nu,
                     pressure=None):
    """Exact per-element POTENTIAL Hessian blocks (P, E, 3L, 3L) = sum_q
    B^T H_q B (for tests and diagnostics; the solver assembles from H_q
    directly). With `pressure` (P,), the follower pressure's load stiffness
    -d2W_p/dd2 is included: the JAX package's 18-jet blocks are K1's 15-jet
    term over (R10, R01, R20, R11, R02) plus K8's 9-jet term over (R00,
    R10, R01)."""
    Ke = _blocks(shell_hessians(stack, d, cp, h_coef, E, nu),
                 torch.stack(_jet_tables(stack), dim=-2))
    if pressure is not None:
        from goldfish_tpu_torch.physics import loads

        Ke = Ke + _blocks(
            loads.pressure_hessians(stack, d, cp, pressure),
            torch.stack(loads._pressure_tables(stack), dim=-2))
    return Ke


# ------------------------------------------------------------ stress (K9)
ZETA = {"top": 0.5, "mid": 0.0, "bottom": -0.5}


def stress_density(X, z, h, E, nu, zfrac):
    """Von Mises stress per qp at the fiber zfrac * h (zfrac = 1/2 top, 0
    mid, -1/2 bottom) from the geometry / displacement jets X, z (..., 15)
    and the thickness h (...): plane-stress SVK in the local Cartesian
    frame (e1 along A1, e2 by Gram-Schmidt). The plain version of K9 (the
    same formula as csrc/vm_stress_qp.cu:vm_stress). sqrt(max(v, 0)) has no
    derivative at v = 0; there the pullback is zero, as in K9."""
    A1, A2 = X[..., 0:3], X[..., 3:6]
    A3 = _cross(A1, A2)
    A3 = A3 / torch.sqrt(_dot(A3, A3))[..., None]
    a = (_dot(A1, A1), _dot(A1, A2), _dot(A2, A2))
    b = (_dot(X[..., 6:9], A3), _dot(X[..., 9:12], A3),
         _dot(X[..., 12:15], A3))
    x = X + z
    a3 = _cross(x[..., 0:3], x[..., 3:6])
    a3 = a3 / torch.sqrt(_dot(a3, a3))[..., None]
    ac = (_dot(x[..., 0:3], x[..., 0:3]), _dot(x[..., 0:3], x[..., 3:6]),
          _dot(x[..., 3:6], x[..., 3:6]))
    bc = (_dot(x[..., 6:9], a3), _dot(x[..., 9:12], a3),
          _dot(x[..., 12:15], a3))
    zh = zfrac * h
    s = tuple(0.5 * (ac[i] - a[i]) + zh * (b[i] - bc[i]) for i in range(3))
    det = a[0] * a[2] - a[1] * a[1]
    Au = (a[2] / det, -a[1] / det, a[0] / det)
    c = E / (1.0 - nu * nu)
    tr = Au[0] * s[0] + Au[1] * s[1] + Au[1] * s[1] + Au[2] * s[2]
    m11 = Au[0] * s[0] + Au[1] * s[1]
    m12 = Au[0] * s[1] + Au[1] * s[2]
    m21 = Au[1] * s[0] + Au[2] * s[1]
    m22 = Au[1] * s[1] + Au[2] * s[2]
    S11 = c * (nu * tr * Au[0] + (1.0 - nu) * (m11 * Au[0] + m12 * Au[1]))
    S12 = c * (nu * tr * Au[1] + (1.0 - nu) * (m11 * Au[1] + m12 * Au[2]))
    S21 = c * (nu * tr * Au[1] + (1.0 - nu) * (m21 * Au[0] + m22 * Au[1]))
    S22 = c * (nu * tr * Au[2] + (1.0 - nu) * (m21 * Au[1] + m22 * Au[2]))
    e1 = A1 / torch.sqrt(_dot(A1, A1))[..., None]
    e2 = A2 - _dot(A2, e1)[..., None] * e1
    e2 = e2 / torch.sqrt(_dot(e2, e2))[..., None]
    T11, T12 = _dot(A1, e1), _dot(A1, e2)
    T21, T22 = _dot(A2, e1), _dot(A2, e2)
    s11 = (S11 * T11 + S21 * T21) * T11 + (S12 * T11 + S22 * T21) * T21
    s22 = (S11 * T12 + S21 * T22) * T12 + (S12 * T12 + S22 * T22) * T22
    s12 = (S11 * T11 + S21 * T21) * T12 + (S12 * T11 + S22 * T21) * T22
    v = s11 * s11 + s22 * s22 - s11 * s22 + 3.0 * (s12 * s12)
    pos = v > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, v, 1.0)), 0.0)


def _stress_plain(stack, d, cp, h, E, nu, zeta):
    Eq, nuq, _ = _qp_params(stack, E, nu)
    return stress_density(jets(stack, cp), jets(stack, d), h_at_qps(stack, h),
                          Eq, nuq, zeta)


def _stress_rows_plain(stack, d, cp, h, E, nu, zeta):
    """Every qp's own Jacobian row B^T dsigma/d(z, X, h): (P, E, Q, L, 7)
    as (d xyz, cp xyz, h) a local node (torch.func.jacrev of
    `stress_density`, vmapped over the qps)."""
    X, z, hq = jets(stack, cp), jets(stack, d), h_at_qps(stack, h)
    Eq, nuq, _ = _qp_params(stack, E, nu)
    P, Ne, Q = hq.shape
    jac = torch.func.vmap(torch.func.jacrev(
        lambda X, z, h, E, nu: stress_density(X, z, h, E, nu, zeta),
        argnums=(0, 1, 2)))
    gX, gz, gh = jac(X.reshape(-1, NJ), z.reshape(-1, NJ), hq.reshape(-1),
                     Eq.reshape(-1), nuq.reshape(-1))
    Rj = torch.stack(_jet_tables(stack), dim=3)  # (P, E, Q, 5, L)

    def rows(g):
        return torch.einsum("peqjl,peqjc->peqlc", Rj,
                            g.reshape(P, Ne, Q, 5, 3))

    return torch.cat([rows(gz), rows(gX),
                      stack.R00[..., None] * gh.reshape(P, Ne, Q, 1, 1)],
                     dim=-1)


def _stress_vjp_plain(stack, d, cp, h, E, nu, zeta, gbar):
    with torch.enable_grad():
        args = tuple(t.detach().requires_grad_(True) for t in (d, cp, h))
        s = _stress_plain(stack, *args, E, nu, zeta)
        return torch.autograd.grad(s, args, gbar)


# (id(conn), C) -> the incidence CSR of a stack, kept while its conn lives
_INCIDENCE: dict = {}


def node_incidence(conn, C: int):
    """(ptr (P C + 1,), idx (P E L,)) int32 of a stack's conn (P, E, L)
    over C control points a patch: the (element, local) pairs of every
    node p C + c, flat element e = p E + ei, pair e L + l, in ascending
    order (node n's pairs are idx[ptr[n]:ptr[n + 1]]). K9's VJP sums each
    node's per-element partials in this order, so its gradient is the same
    bits on every launch. Built once per conn tensor, on its device."""
    P, Ne, L = conn.shape
    key = (id(conn), C)
    hit = _INCIDENCE.get(key)
    if hit is None:
        node = (conn.long() + C * torch.arange(
            P, device=conn.device)[:, None, None]).reshape(-1)
        idx = torch.sort(node, stable=True).indices
        ptr = torch.zeros(P * C + 1, dtype=torch.long, device=conn.device)
        ptr[1:] = torch.cumsum(torch.bincount(node, minlength=P * C), 0)
        hit = (ptr.to(INDEX_DTYPE).contiguous(),
               idx.to(INDEX_DTYPE).contiguous())
        _INCIDENCE[key] = hit
        weakref.finalize(conn, _INCIDENCE.pop, key, None)
    return hit


def _check_stress(stack, d, cp, h, E, nu, gbar=None):
    dims = _check_inputs(stack, d, cp, h, E, nu)
    if gbar is not None:
        _cuda.check(gbar, "gbar", DTYPE, stack.wq.shape, d.device)
    return dims


def _launch_stress(mode, counter, stack, d, cp, h, E, nu, zeta, gbar, out_s,
                   out_dd, out_dcp, out_dh, dims, rows=None):
    p = _cuda.ptr
    ptr = idx = part = None
    if mode == 1:
        P, Ne, _, L, C = dims
        ptr, idx = node_incidence(stack.conn, C)
        part = torch.empty(P, Ne, L, 7, dtype=DTYPE, device=d.device)
    elif mode == 2:
        part = rows
    _cuda.launch(counter, "gf_vm_stress_qp", mode,
                 p(stack.R00), p(stack.R10), p(stack.R01), p(stack.R20),
                 p(stack.R11), p(stack.R02), p(stack.conn), p(d), p(cp), p(h),
                 p(E), p(nu), p(gbar), p(ptr), p(idx), p(part), p(out_s),
                 p(out_dd), p(out_dcp), p(out_dh), float(zeta), *dims)


def vm_stress_value(stack: PatchStack, d, cp, h, E, nu, zeta):
    """K9 mode 0: von Mises stress (P, E, Q) at the fiber zeta * h."""
    dims = _check_stress(stack, d, cp, h, E, nu)
    if not _cuda.on_cuda(d):
        return _stress_plain(stack, d, cp, h, E, nu, zeta)
    P, Ne, Q, _, _ = dims
    s = torch.empty(P, Ne, Q, dtype=DTYPE, device=d.device)
    _launch_stress(0, "vm_stress_qp/value", stack, d, cp, h, E, nu, zeta,
                   None, s, None, None, None, dims)
    return s


def vm_stress_vjp(stack: PatchStack, d, cp, h, E, nu, zeta, gbar):
    """K9 mode 1: gbar . dsigma/d(d, cp, h) -> ((P, C, 3), (P, C, 3),
    (P, C)) for the cotangent gbar (P, E, Q)."""
    dims = _check_stress(stack, d, cp, h, E, nu, gbar)
    if not _cuda.on_cuda(d):
        return _stress_vjp_plain(stack, d, cp, h, E, nu, zeta, gbar)
    dd = torch.empty_like(d)
    dcp = torch.empty_like(cp)
    dh = torch.empty_like(h)
    _launch_stress(1, "vm_stress_qp/vjp", stack, d, cp, h, E, nu, zeta, gbar,
                   None, dd, dcp, dh, dims)
    return dd, dcp, dh


def vm_stress_rows(stack: PatchStack, d, cp, h, E, nu, zeta):
    """K9 mode 2: every qp's own row of dsigma/d(d, cp, h), (P, E, Q, L, 7)
    as (d xyz, cp xyz, h) a local node (the local node's coefficient is
    conn[p, e, l]). Row (p, e, q) summed against a cotangent gbar over the
    qps and scattered through conn is mode 1's VJP; each entry is written
    once, so the rows are the same bits on every launch."""
    dims = _check_stress(stack, d, cp, h, E, nu)
    if not _cuda.on_cuda(d):
        return _stress_rows_plain(stack, d, cp, h, E, nu, zeta)
    P, Ne, Q, L, _ = dims
    rows = torch.empty(P, Ne, Q, L, 7, dtype=DTYPE, device=d.device)
    _launch_stress(2, "vm_stress_qp/rows", stack, d, cp, h, E, nu, zeta,
                   None, None, None, None, None, dims, rows=rows)
    return rows


class _VMStress(torch.autograd.Function):
    """sigma_vM (P, E, Q) from K9 mode 0, its VJP in (d, cp, h) from K9
    mode 1."""

    @staticmethod
    def forward(ctx, d, cp, h, stack, E, nu, zeta):
        d, cp, h = d.detach(), cp.detach(), h.detach()
        ctx.save_for_backward(d, cp, h)
        ctx.stack, ctx.E, ctx.nu, ctx.zeta = stack, E, nu, zeta
        return vm_stress_value(stack, d, cp, h, E, nu, zeta)

    @staticmethod
    def backward(ctx, g):
        d, cp, h = ctx.saved_tensors
        dd, dcp, dh = vm_stress_vjp(ctx.stack, d, cp, h, ctx.E, ctx.nu,
                                    ctx.zeta, g.contiguous())
        return dd, dcp, dh, None, None, None, None


def qp_stress_vm(stack: PatchStack, d, cp, h_coef, E, nu, through="top"):
    """Von Mises stress (P, E, Q) at every qp through `through` ('top' z =
    +h/2, 'mid', 'bottom' -h/2), differentiable in d, cp and h by autograd
    (K9 on CUDA tensors, `stress_density` on CPU tensors)."""
    return _VMStress.apply(d, cp, h_coef, stack, E, nu, ZETA[through])


def volume(stack: PatchStack, cp, h_coef):
    """Material volume sum int h dA (0-dim), differentiable in cp and h by
    autograd (plain torch)."""
    return (h_at_qps(stack, h_coef) * _ref_area(stack, cp)).sum()


def _ref_area(stack: PatchStack, cp):
    ce = gather(cp, stack.conn)
    Xu = torch.einsum("peql,pelk->peqk", stack.R10, ce)
    Xv = torch.einsum("peql,pelk->peqk", stack.R01, ce)
    A3 = _cross(Xu, Xv)
    return torch.sqrt(_dot(A3, A3)) * stack.wq


def external_work_dead_load(stack: PatchStack, d, cp, f_areal):
    """W_ext = sum_patches int f . u dA_ref (dead areal load, f: (P, 3))."""
    u = torch.einsum("peql,pelk->peqk", stack.R00, gather(d, stack.conn))
    fu = torch.einsum("pk,peqk->peq", f_areal, u)
    return (fu * _ref_area(stack, cp)).sum()


def dead_load_force(stack: PatchStack, cp, f_areal):
    """dW_ext/dd (P, C, 3): constant in d (the dead load is linear)."""
    w = torch.einsum("peql,peq->pel", stack.R00, _ref_area(stack, cp))
    contrib = w[..., None] * f_areal[:, None, None, :]
    return _index_add_nodes(stack.conn, contrib, cp.shape[0], cp.shape[1])
