"""The non-matching multi-patch shell system: energy, residual, tangent.

Port of goldfish_tpu/solver/system.py. One object owns the stacked patch
data, interface data, boundary conditions and the loads, and exposes

    total_potential(d, cp, h)     -> Pi
    residual(d, cp, h)            -> (P, C, 3)   [= dPi/dd, BC-masked]
    tangent_matvec(d, cp, h, v)   -> K(d) v      [BC-masked both sides]
    assemble_K(d, cp, h)          -> (N, N) dense BC-reduced tangent

The tangent is never differentiated numerically: the shell, penalty and
follower-pressure kernels (K1, K2, K8) give per-qp jet Hessians H_q of
three groups (elements over 5 jets, interface qps over 6, elements over
the pressure's 3 jets), and

- `jet_assemble` (kernel K3, csrc/jet_assemble.cu) scatters
  sum_q B_q^T H_q B_q into dense K,
- `jet_matvec` (kernel K4, csrc/jet_matvec.cu) applies the same sum to a
  vector without assembling K.

Both run their CUDA kernel on CUDA tensors and their plain PyTorch
version (einsum + index_add_) on CPU tensors.

Shell-shell contact (`SystemData.contact`) adds its pair potential to Pi,
its force to r, and its stiffness to K and K v through kernel K12
(physics/contact.py): the qp positions and weights at d are the fourth
entry of the jet Hessians.

A patch-sharded system (`SystemData.shard`, parallel/sharding.py) holds
one rank's patch block and interface block. Every operator here then runs
its kernels on that part, with the element dof maps offset by lo*C*3, and
sums its global-shaped result over the ranks with one all-reduce: Pi and r,
the residual's VJP and JVP, K (the dense (N, N) tangent itself is summed,
so K3's f64 atomics never make two ranks' K differ) and K v. Terms that the
split does not divide (point and edge loads, contact) are evaluated on rank
0 only; the dead, follower-pressure and field loads follow the patches.
Each operator is written once: the whole system is the one-rank case of
the split (`_part`), in the order of the unsharded sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE, as_device, tensor
from goldfish_tpu_torch.geometry.nurbs import NURBS
from goldfish_tpu_torch.geometry.trim import support_weights
from goldfish_tpu_torch.geometry.patch_stack import (
    PatchStack,
    build_patch_stack,
    side_dofs,
    stack_control_points,
)
from goldfish_tpu_torch.ops.bspline import rational_basis_2d
from goldfish_tpu_torch.physics import contact as contact_, coupling, \
    kl_shell
from goldfish_tpu_torch.physics.coupling import InterfaceSpec, InterfaceStack
from goldfish_tpu_torch.physics.loads import (
    EdgeLoads,
    PointLoads,
    areal_field_force,
    areal_field_work,
    build_edge_loads,
    build_point_loads,
    edge_load_force,
    edge_load_work,
    external_work_and_force,
    pressure_adjoint,
    pressure_design_jvp,
    pressure_hessians,
)

__all__ = ["SystemData", "NonMatchingSystem", "JetTables", "JetHessians",
           "jet_tables", "interface_tables", "scale_loads",
           "jet_hessians", "jet_runs", "jet_assemble", "jet_matvec",
           "assemble_K_from",
           "tangent_matvec_from", "potential_and_residual", "residual_vjp",
           "residual_vjp_field", "residual_jvp",
           "total_potential", "residual", "tangent_matvec", "assemble_K",
           "element_global_dofs"]


class SystemData(NamedTuple):
    """Problem tensors (the same fields as the JAX package's SystemData):
    the dead, point, edge, follower-pressure and areal field loads, and
    shell-shell contact."""

    stack: PatchStack
    ifs: InterfaceStack | None
    free: torch.Tensor       # (P, C, 3) 1.0 = free dof
    E: torch.Tensor          # (P,)
    nu: torch.Tensor         # (P,)
    f_areal: torch.Tensor | None   # (P, 3) dead load or None
    point_loads: PointLoads | None = None
    pressure: torch.Tensor | None = None   # (P,) follower pressure or None
    edge_loads: EdgeLoads | None = None
    f_field: torch.Tensor | None = None   # (P, C, 3) field load or None
    contact: contact_.ContactPairs | None = None
    # parallel.sharding.PatchShard of a rank's part of a patch-sharded
    # system (`shard_system`), or None: the whole system in one process
    shard: object = None


def scale_loads(data: SystemData, s):
    """Every external load scaled by s (load stepping, continuation and the
    arc-length load factor); contact and the tangent's structure unchanged.
    Each load is linear in its scale, the follower pressure's too."""
    return data._replace(
        f_areal=None if data.f_areal is None else s * data.f_areal,
        pressure=None if data.pressure is None else s * data.pressure,
        f_field=None if data.f_field is None else s * data.f_field,
        point_loads=None if data.point_loads is None
        else data.point_loads._replace(F=s * data.point_loads.F),
        edge_loads=None if data.edge_loads is None
        else data.edge_loads._replace(F=s * data.edge_loads.F))


# ------------------------------------------------------------ patch split
class _Whole:
    """The whole system as the one-rank case of a patch split, with the
    interface of parallel.sharding.PatchShard that the operators read:
    `local` and `place` are the identity, the rank-0 terms are on, `sum`
    is the identity, and contact runs on the whole stack."""

    __slots__ = ("contact", "contact_stack")
    rank0 = True
    patch_ids = None
    contact_ids = None

    def __init__(self, data: SystemData):
        self.contact, self.contact_stack = data.contact, data.stack

    @staticmethod
    def local(t):
        return t

    @staticmethod
    def place(t):
        return t

    @staticmethod
    def sum(*ts):
        return ts[0] if len(ts) == 1 else ts

    @staticmethod
    def contact_rows(*ts):
        return ts

    @staticmethod
    def add_contact(r, rc):
        return r + rc


def _part(data: SystemData):
    """The part of the system this process evaluates: the rank's
    `PatchShard` of a patch-sharded system, else the whole (`_Whole`).
    Every operator below is written once against it; on the whole system
    it keeps the order of the unsharded sums, bit for bit."""
    return _Whole(data) if data.shard is None else data.shard


def agree(data: SystemData, where, *values):
    """On a patch-sharded system with the mesh's guard on: raise unless the
    values that a host decision reads have the same bits on every rank (a
    decision on a rank-local value parts the ranks, and the next
    collective hangs). A no-op otherwise (also where no system is given)."""
    shard = getattr(data, "shard", None)
    if shard is not None:
        shard.mesh.check_agree(where, *values)


# ------------------------------------------------------------ energy
def potential_and_residual(data: SystemData, d, cp, h):
    """(Pi, r): the potential (summed deterministically from per-element
    and per-interface energies) and the BC-masked residual dPi/dd, from
    one K1, one K2, (with a follower pressure) one K8 and (with contact)
    one K12 launch. Sharded: the rank's part, then one all-reduce of
    (Pi, r)."""
    pt = _part(data)
    W, r, _ = kl_shell.shell_value_grad(
        data.stack, pt.local(d), pt.local(cp), pt.local(h), pt.local(data.E),
        pt.local(data.nu))
    Pi = W.sum()
    r = pt.place(r)
    if data.ifs is not None:
        Wi, ri, _ = coupling.penalty_value_grad(data.ifs, d, cp, h, data.E)
        Pi = Pi + Wi.sum()
        r = r + ri
    if pt.contact is not None:
        Wc, rc = contact_.contact_value_force(pt.contact, pt.contact_stack,
                                              *pt.contact_rows(d, cp))
        Pi = Pi + Wc
        r = pt.add_contact(r, rc)
    W_ext, f_ext = external_work_and_force(
        data.stack, d, cp, data.f_areal, data.point_loads, data.pressure,
        data.edge_loads, data.f_field, part=pt)
    Pi, r = pt.sum(Pi - W_ext, r - f_ext)
    return Pi, r * data.free


def total_potential(data: SystemData, d, cp, h):
    """Pi = W_int + W_penalty + W_contact - W_ext."""
    return potential_and_residual(data, d, cp, h)[0]


def residual(data: SystemData, d, cp, h):
    """R = dPi/dd with fixed/padding dofs masked to zero."""
    return potential_and_residual(data, d, cp, h)[1]


def _residual_vjp_parts(data: SystemData, d, cp, h, lam):
    """This process's (dcp, dh) of `residual_vjp`, global-shaped, not yet
    summed over the ranks (the whole of it on a whole system)."""
    pt = _part(data)
    st = data.stack
    lam = lam * data.free
    dl, cpl, laml = pt.local(d), pt.local(cp), pt.local(lam)
    dcp, dh = kl_shell.shell_adjoint(st, dl, cpl, pt.local(h),
                                     pt.local(data.E), pt.local(data.nu),
                                     laml)
    dcp, dh = pt.place(dcp), pt.place(dh)
    if data.ifs is not None:
        dcp_i, dh_i = coupling.penalty_adjoint(data.ifs, d, cp, h, data.E,
                                               lam)
        dcp = dcp + dcp_i
        dh = dh + dh_i
    if data.pressure is not None:
        dcp = dcp + pt.place(pressure_adjoint(st, dl, cpl,
                                              pt.local(data.pressure), laml))
    if pt.contact is not None:
        dcp = pt.add_contact(dcp, contact_.contact_adjoint(
            pt.contact, pt.contact_stack, *pt.contact_rows(d, cp, lam)))
    edge = data.edge_loads if pt.rank0 else None
    if (data.f_areal is not None or edge is not None
            or data.f_field is not None):
        # the dead, edge and field loads are linear in d, so lam . dW_ext/dd
        # = W_ext(lam); its cp-gradient by autograd
        with torch.enable_grad():
            cpv = cp.detach().requires_grad_(True)
            cpvl = pt.local(cpv)
            w = torch.zeros((), dtype=cp.dtype, device=cp.device)
            if data.f_areal is not None:
                w = w + kl_shell.external_work_dead_load(
                    st, laml, cpvl, pt.local(data.f_areal))
            if edge is not None:
                w = w + edge_load_work(edge, lam, cpv)
            if data.f_field is not None:
                w = w + areal_field_work(st, laml, cpvl,
                                         pt.local(data.f_field))
            dcp = dcp + torch.autograd.grad(w, cpv)[0]
    return dcp, dh


def residual_vjp(data: SystemData, d, cp, h, lam):
    """(dcp, dh) = -lam^T dR/d(cp, h): the adjoint's design gradient (K1,
    K2 and K8 in adjoint mode, K12's hvp for contact, plus the dead, edge
    and field loads' cp-dependence). The loads and contact do not depend on
    h. Sharded: one all-reduce of (dcp, dh)."""
    return _part(data).sum(*_residual_vjp_parts(data, d, cp, h, lam))


def _residual_jvp_parts(data: SystemData, d, cp, h, tcp, th):
    """This process's masked dR/dcp tcp + dR/dh th of `residual_jvp`,
    global-shaped, not yet summed over the ranks (masking by free, 0 or 1,
    commutes with that sum exactly)."""
    pt = _part(data)
    st = data.stack
    dl, cpl, tcpl = pt.local(d), pt.local(cp), pt.local(tcp)
    out = pt.place(kl_shell.shell_design_jvp(
        st, dl, cpl, pt.local(h), pt.local(data.E), pt.local(data.nu), tcpl,
        pt.local(th)))
    if data.ifs is not None:
        out = out + coupling.penalty_design_jvp(data.ifs, d, cp, h, data.E,
                                                tcp, th)
    if data.pressure is not None:
        out = out + pt.place(pressure_design_jvp(
            st, dl, cpl, pt.local(data.pressure), tcpl))
    # tcp is replicated: every rank reads the same value here, and on a
    # sharded system only rank 0 holds contact (no collective depends on it)
    if pt.contact is not None and bool(torch.any(tcp != 0)):
        out = pt.add_contact(out, contact_.contact_design_jvp(
            pt.contact, pt.contact_stack, *pt.contact_rows(d, cp, tcp)))
    edge = data.edge_loads if pt.rank0 else None
    if (data.f_areal is not None or edge is not None
            or data.f_field is not None):
        def f_ext(c):
            cl = pt.local(c)
            f = torch.zeros_like(c)
            if data.f_areal is not None:
                f = f + pt.place(kl_shell.dead_load_force(
                    st, cl, pt.local(data.f_areal)))
            if edge is not None:
                f = f + edge_load_force(edge, c)
            if data.f_field is not None:
                f = f + pt.place(areal_field_force(st, cl,
                                                   pt.local(data.f_field)))
            return f

        out = out - torch.func.jvp(f_ext, (cp,), (tcp,))[1]
    return out * data.free


def residual_jvp(data: SystemData, d, cp, h, tcp, th):
    """free * (dR/dcp tcp + dR/dh th): the forward design product, with
    `residual_vjp`'s composition: K1 and K2 in their design-tangent modes,
    the follower pressure by K8 mode (c) at lambda = tcp (its cp-Jacobian
    is symmetric, `loads.pressure_design_jvp`), the dead, edge and field
    loads' cp-dependence by torch.func.jvp, and contact's where tcp is
    nonzero (K12 mode 3, `contact.contact_design_jvp`). tcp and th are
    unmasked (a clamped dof still
    moves the geometry); only the output is masked. The loads and contact
    do not depend on h. Sharded: one all-reduce."""
    return _part(data).sum(_residual_jvp_parts(data, d, cp, h, tcp, th))


def residual_vjp_field(data: SystemData, d, cp, h, lam):
    """(dcp, dh, df) = -lam^T dR/d(cp, h, f_field): `residual_vjp` and the
    field load's pullback. R carries -dW_f/dd, so -lam^T dR/df = dW_f(lam)/df
    (the field load is bilinear in d and f; the sign of the reference's
    vjp(-lam)). Sharded: one all-reduce of (dcp, dh, df)."""
    pt = _part(data)
    dcp, dh = _residual_vjp_parts(data, d, cp, h, lam)
    df = pt.place(areal_field_force(data.stack, pt.local(cp),
                                    pt.local(lam * data.free)))
    return pt.sum(dcp, dh, df)


# ------------------------------------------------------------ dof maps
def element_global_dofs(stack: PatchStack, patch_ids=None):
    """Global dof index of each element-local dof: (P, E, 3L) int32.
    `patch_ids` (P,) numbers the stack's patches (default 0..P-1; a rank's
    block of a sharded system passes lo..hi-1)."""
    P, E, L = stack.conn.shape
    C = stack.max_cp
    if patch_ids is None:
        patch_ids = torch.arange(P, dtype=INDEX_DTYPE,
                                 device=stack.conn.device)
    p_ids = patch_ids.to(INDEX_DTYPE)[:, None, None]
    base = (p_ids * C + stack.conn) * 3
    gi = base[..., None] + torch.arange(3, dtype=INDEX_DTYPE,
                                        device=base.device)
    return gi.reshape(P, E, 3 * L)


def _interface_global_dofs(ifs: InterfaceStack, C: int):
    """Global dofs of each interface qp's stacked [A; B] locals:
    (I, N, 6L) int32."""
    L = ifs.connA.shape[-1]

    def side(conn, pair):
        base = (pair[:, None, None] * C + conn) * 3
        gi = base[..., None] + torch.arange(3, dtype=INDEX_DTYPE,
                                            device=base.device)
        return gi.reshape(conn.shape[0], conn.shape[1], 3 * L)

    return torch.cat([side(ifs.connA, ifs.pairA),
                      side(ifs.connB, ifs.pairB)], dim=-1)


class JetTables(NamedTuple):
    """Static tables of the jet assembly/matvec kernels. A "group" is an
    element (nq = Q qps, 5 jets over L locals), an interface qp (nq = 1,
    6 jets over the 2L stacked locals) or, with a follower pressure, an
    element of the pressure group (nq = Q, 3 jets over L locals, the
    element dofs gi_e). With contact, R_c are the R00 rows of the one-jet
    group that carries K12's own-side sums (nq = Q, 1 jet over L locals,
    their element dofs gi_c). Of a patch-sharded system the tables are the
    rank's: its elements (dofs offset by lo*C*3), its interfaces, and on
    rank 0 the contact patches' copy (R_c, gi_c); `shard` is then set and
    K and K v are summed over the ranks."""

    R_e: torch.Tensor             # (P*E, Q, 5, L)
    gi_e: torch.Tensor            # (P*E, 3L) int32
    R_i: torch.Tensor | None      # (I*N, 1, 6, 2L)
    gi_i: torch.Tensor | None     # (I*N, 6L) int32
    free: torch.Tensor            # (P*C*3,)
    R_p: torch.Tensor | None = None   # (P*E, Q, 3, L)
    R_c: torch.Tensor | None = None   # (Pc*E, Q, 1, L)
    contact: contact_.ContactPairs | None = None
    gi_c: torch.Tensor | None = None  # (Pc*E, 3L) int32, R_c's dofs
    shard: object = None


def interface_tables(ifs: InterfaceStack, C: int):
    """(R_i (I*N, 1, 6, 2L), gi_i (I*N, 6L) int32): the interface groups
    of the jet assembly/matvec kernels."""
    I_, N, Li = ifs.RA00.shape
    R_i = coupling.interface_rows(ifs).reshape(I_ * N, 1, 6, 2 * Li)
    gi_i = _interface_global_dofs(ifs, C).reshape(I_ * N, 6 * Li)
    return R_i.contiguous(), gi_i.contiguous()


def jet_tables(data: SystemData) -> JetTables:
    pt = _part(data)
    stack = data.stack
    P, Ne, Q, L = stack.R00.shape
    R_e = torch.stack(kl_shell._jet_tables(stack), dim=-2)
    gi_e = element_global_dofs(stack, pt.patch_ids)
    R_i = gi_i = R_p = R_c = gi_c = None
    if data.ifs is not None:
        R_i, gi_i = interface_tables(data.ifs, stack.max_cp)
    if data.pressure is not None:
        R_p = torch.stack((stack.R00, stack.R10, stack.R01), dim=-2).reshape(
            P * Ne, Q, 3, L).contiguous()
    if pt.contact is not None:
        cst = pt.contact_stack
        R_c = cst.R00.reshape(-1, Q, 1, L).contiguous()
        gi_c = element_global_dofs(cst, pt.contact_ids).reshape(
            -1, 3 * L).contiguous()
    return JetTables(
        R_e=R_e.reshape(P * Ne, Q, 5, L).contiguous(),
        gi_e=gi_e.reshape(P * Ne, 3 * L).contiguous(),
        R_i=R_i, gi_i=gi_i, free=data.free.reshape(-1).contiguous(),
        R_p=R_p, R_c=R_c, contact=pt.contact, gi_c=gi_c, shard=data.shard)


class JetHessians(NamedTuple):
    """The tangent's pieces at one state: per-group jet Hessians and, with
    contact, the qp positions and weights K12 works on and its cull's list
    of element pairs at them (shared by the assembly and every K_c v)."""

    H_e: torch.Tensor                 # (P*E, Q, 15, 15)
    H_i: torch.Tensor | None          # (I*N, 1, 18, 18)
    H_p: torch.Tensor | None          # (P*E, Q, 9, 9)
    contact_xw: tuple | None = None   # ((P, E*Q, 3), (P, E*Q))
    contact_cells: contact_.ContactCells | None = None


def jet_hessians(data: SystemData, d, cp, h):
    """The tangent's pieces at state d (`JetHessians`): jet Hessians from
    K1, K2 and K8 mode (b); with contact the qp positions and weights and
    K12's list of element pairs that may touch at them. Sharded: the
    rank's elements and interfaces, and on rank 0 the contact patches'."""
    pt = _part(data)
    stack = data.stack
    P, Ne, Q, _ = stack.R00.shape
    dl, cpl = pt.local(d), pt.local(cp)
    H_e = kl_shell.shell_hessians(stack, dl, cpl, pt.local(h),
                                  pt.local(data.E), pt.local(data.nu))
    H_i = H_p = None
    if data.ifs is not None:
        H_i = coupling.penalty_hessians(data.ifs, d, cp, h, data.E)
        H_i = H_i.reshape(-1, 1, coupling.NZ, coupling.NZ)
    if data.pressure is not None:
        H_p = pressure_hessians(stack, dl, cpl,
                                pt.local(data.pressure)).reshape(
            P * Ne, Q, 9, 9)
    xw = cells = None
    if pt.contact is not None:
        xw = tuple(t.contiguous() for t in contact_.contact_qps(
            pt.contact_stack, *pt.contact_rows(d, cp)))
        cells = contact_.contact_cells(pt.contact, *xw, q=Q)
    return JetHessians(H_e.reshape(P * Ne, Q, kl_shell.NJ, kl_shell.NJ),
                       H_i, H_p, xw, cells)


# ------------------------------------------------------------ K3 / K4
def _check_jet_args(H, R, gi, free, *vecs):
    G, nq, nj, nloc = R.shape
    dev = H.device
    nz = 3 * nj
    _cuda.check(H, "H", DTYPE, (G, nq, nz, nz), dev)
    _cuda.check(R, "R", DTYPE, (G, nq, nj, nloc), dev)
    _cuda.check(gi, "gi", INDEX_DTYPE, (G, 3 * nloc), dev)
    _cuda.check(free, "free", DTYPE, None, dev)
    if free.dim() != 1:
        raise ValueError("free: must be flat (N,)")
    for name, t, shape in vecs:
        _cuda.check(t, name, DTYPE, shape, dev)
    return G, nq, nj, nloc


def _assemble_plain(K, H, R, gi, free):
    G, nq, nj, nloc = R.shape
    Hr = H.reshape(G, nq, nj, 3, nj, 3)
    tmp = torch.einsum("gqjxky,gqkm->gqjxmy", Hr, R)
    Kg = torch.einsum("gqjxmy,gqjl->glxmy", tmp, R).reshape(
        G, 3 * nloc, 3 * nloc)
    gl = gi.long()
    m = free[gl]
    Kg = Kg * m[:, :, None] * m[:, None, :]
    K.index_put_((gl[:, :, None].expand_as(Kg), gl[:, None, :].expand_as(Kg)),
                 Kg, accumulate=True)


# jet counts K3 is compiled for: contact own-side sums, pressure, shell,
# interface
ASSEMBLE_JETS = (1, 3, 5, 6)


def jet_runs(gi):
    """(starts, lengths) int64 of the runs of consecutive groups with the
    same dof map, which K3 sums before it adds them to K (the kernel finds
    them itself; the tests and chip_smoke.py count them here)."""
    G = gi.shape[0]
    head = torch.ones(G, dtype=torch.bool, device=gi.device)
    head[1:] = (gi[1:] != gi[:-1]).any(1)
    starts = head.nonzero()[:, 0]
    ends = torch.cat([starts[1:], starts.new_tensor([G])])
    return starts, ends - starts


def jet_assemble(K, H, R, gi, free):
    """K3: K[gi_a, gi_b] += sum_q B_q^T H_q B_q for every group, over free
    dofs only (in place). K: (N, N); H: (G, nq, 3nj, 3nj); R: (G, nq, nj,
    nloc); gi: (G, 3 nloc) int32; free: (N,). On the card consecutive
    groups with the same row of gi (`jet_runs`) are summed first and
    added once."""
    N = free.shape[0]
    G, nq, nj, nloc = _check_jet_args(H, R, gi, free, ("K", K, (N, N)))
    if not _cuda.on_cuda(H):
        _assemble_plain(K, H, R, gi, free)
        return K
    if nj not in ASSEMBLE_JETS:
        raise ValueError(f"jet_assemble: {nj} jets; K3 is built for "
                         f"{ASSEMBLE_JETS}")
    p = _cuda.ptr
    _cuda.launch("jet_assemble", "gf_jet_assemble", p(H), p(R), p(gi),
                 p(free), p(K), G, nq, nj, nloc, N)
    return K


def _matvec_plain(y, H, R, gi, free, v):
    G, nq, nj, nloc = R.shape
    gl = gi.long()
    vm = (v * free)[gl].reshape(G, nloc, 3)
    z = torch.einsum("gqjl,glx->gqjx", R, vm).reshape(G, nq, 3 * nj)
    w = torch.einsum("gqab,gqb->gqa", H, z).reshape(G, nq, nj, 3)
    contrib = torch.einsum("gqjl,gqjx->glx", R, w).reshape(G, 3 * nloc)
    y.index_add_(0, gl.reshape(-1), (contrib * free[gl]).reshape(-1))


def jet_matvec(y, H, R, gi, free, v):
    """K4: y += free * sum_q B_q^T H_q B_q (free * v) for every group (in
    place). y, v, free: (N,); H, R, gi as for `jet_assemble`."""
    N = free.shape[0]
    G, nq, nj, nloc = _check_jet_args(H, R, gi, free, ("v", v, (N,)),
                                      ("y", y, (N,)))
    if not _cuda.on_cuda(H):
        _matvec_plain(y, H, R, gi, free, v)
        return y
    p = _cuda.ptr
    _cuda.launch("jet_matvec", "gf_jet_matvec", p(H), p(R), p(gi), p(free),
                 p(v), p(y), G, nq, nj, nloc)
    return y


def assemble_K_from(tables: JetTables, Hs):
    """Dense BC-reduced tangent from `Hs` (jet_hessians)."""
    H_e, H_i, H_p, xw, cells = Hs
    free = tables.free
    N = free.shape[0]
    K = torch.zeros(N, N, dtype=DTYPE, device=free.device)
    jet_assemble(K, H_e, tables.R_e, tables.gi_e, free)
    if H_i is not None:
        jet_assemble(K, H_i, tables.R_i, tables.gi_i, free)
    if H_p is not None:
        jet_assemble(K, H_p, tables.R_p, tables.gi_e, free)
    if xw is not None:
        contact_.contact_assemble(K, tables.contact, *xw, tables.R_c,
                                  tables.gi_c, free, cells=cells)
    if tables.shard is not None:
        # the dense K summed over the ranks in place (N^2 f64; the
        # alternative, gathering the jet Hessians and assembling the whole
        # K on every rank, would let K3's atomics give each rank other bits)
        tables.shard.sum(K)
    K.diagonal().add_(1.0 - free)
    return K


def _contact_matvec(y, tables: JetTables, xw, vf, cells=None):
    """y += free * K_c (free * v): v to the qps on the R00 rows, K12's hvp
    (on the list `cells` of these x, w when given), back by R00^T."""
    G, Q, _, L = tables.R_c.shape
    free = tables.free
    gl = tables.gi_c.long()
    R = tables.R_c[:, :, 0]
    vq = torch.einsum("gql,glk->gqk", R, (vf * free)[gl].reshape(G, L, 3))
    x, w = xw
    Y, _ = contact_.contact_hvp(tables.contact, x, w,
                                vq.reshape(x.shape).contiguous(), cells=cells)
    contrib = torch.einsum("gql,gqk->glk", R, Y.reshape(G, Q, 3))
    y.index_add_(0, gl.reshape(-1), (contrib.reshape(G, 3 * L)
                                     * free[gl]).reshape(-1))


def tangent_matvec_from(tables: JetTables, Hs, v):
    """K(d) v from `Hs` at d, masked both sides; v: (P, C, 3)."""
    H_e, H_i, H_p, xw, cells = Hs
    free = tables.free
    vf = v.reshape(-1).contiguous()
    y = torch.zeros_like(vf)
    jet_matvec(y, H_e, tables.R_e, tables.gi_e, free, vf)
    if H_i is not None:
        jet_matvec(y, H_i, tables.R_i, tables.gi_i, free, vf)
    if H_p is not None:
        jet_matvec(y, H_p, tables.R_p, tables.gi_e, free, vf)
    if xw is not None:
        _contact_matvec(y, tables, xw, vf, cells)
    if tables.shard is not None:
        y = tables.shard.sum(y)
    return y.reshape(v.shape)


def tangent_matvec(data: SystemData, d, cp, h, v):
    """Matrix-free K(d) v (exact; BC-masked both sides)."""
    return tangent_matvec_from(jet_tables(data),
                               jet_hessians(data, d, cp, h), v)


def assemble_K(data: SystemData, d, cp, h):
    """Dense BC-reduced tangent stiffness (N, N), N = P*C*3."""
    return assemble_K_from(jet_tables(data), jet_hessians(data, d, cp, h))


# ------------------------------------------------------------ facade
class NonMatchingSystem:
    """Host-side facade: build once from NURBS surfaces on `device`."""

    def __init__(self, surfs: list[NURBS], E, nu, h_th,
                 specs: list[InterfaceSpec] | None = None,
                 penalty_coefficient: float = 1.0e3, device=None,
                 trims=None, trim_subdiv: int = 3):
        self.device = as_device(device)
        self.surfs = surfs
        self.num_splines = len(surfs)
        self.stack, self.metas = build_patch_stack(
            surfs, device=self.device, trims=trims, trim_subdiv=trim_subdiv)
        self.specs = specs or []
        self.penalty_coefficient = penalty_coefficient
        self.ifs = coupling.build_interfaces(
            surfs, self.specs, penalty_coefficient, device=self.device)

        P, C = self.stack.n_patches, self.stack.max_cp
        self.E = tensor(np.broadcast_to(np.asarray(E, dtype=np.float64),
                                        (P,)), self.device)
        self.nu = tensor(np.broadcast_to(np.asarray(nu, dtype=np.float64),
                                         (P,)), self.device)
        h_arr = np.zeros((P, C))
        h_in = np.asarray(h_th, dtype=np.float64)
        for i, m in enumerate(self.metas):
            h_arr[i, : m.n_cp] = h_in if h_in.ndim == 0 else h_in[i]
        self.h_init = tensor(h_arr, self.device)
        self.cp = stack_control_points(self.metas, device=self.device)
        self._free = np.array(
            self.stack.cp_mask.cpu().numpy()[..., None] * np.ones(3),
            dtype=np.float64)
        if trims is not None:
            # a CP whose entire basis support was trimmed away has an
            # exactly-zero stiffness row: pin it or the tangent is
            # singular. Relative threshold: clipping roundoff can leave
            # eps-mass supports that are numerically as singular.
            w = support_weights(self.stack)
            self._free *= (w > 1e-12 * w.max())[..., None]
        self.f_areal = None
        self.point_load_entries = []
        self.edge_load_entries = []
        self.pressure = None
        self.f_field = None
        self.contact = None
        self._data = None

    def add_zero_dofs(self, patch: int, cp_indices, fields=(0, 1, 2)):
        """Pin listed CP coefficients of `patch` to zero."""
        for f in fields:
            self._free[patch, np.asarray(cp_indices, dtype=np.int64), f] = 0.0
        self._data = None

    def add_side_bc(self, patch: int, direction: int, side: int,
                    n_layers: int = 1, fields=(0, 1, 2)):
        """Clamp a parametric side (tIGAr getSideDofs/addZeroDofs)."""
        m = self.metas[patch]
        dofs = side_dofs(m.n_u, m.n_v, direction, side, n_layers)
        self.add_zero_dofs(patch, dofs, fields)

    def set_dead_load(self, f_per_patch):
        f = np.asarray(f_per_patch, dtype=np.float64)
        if f.ndim == 1:
            f = np.tile(f, (self.num_splines, 1))
        self.f_areal = tensor(f, self.device)
        self._data = None

    def add_point_load(self, patch: int, xi, force):
        """Dead point load `force` (3,) at parametric point `xi` (2,)."""
        self.point_load_entries.append((patch, np.asarray(xi),
                                        np.asarray(force)))
        self._data = None

    def add_edge_load(self, patch: int, direction: int, side: int, force):
        """Dead line load `force` (3,) per unit length on a whole parametric
        edge (the tIGAr side convention of `add_side_bc`)."""
        self.edge_load_entries.append(
            (patch, direction, side, np.asarray(force)))
        self._data = None

    def set_areal_field(self, f_coef):
        """Distributed dead load as a (P, C, 3) CP coefficient field (the
        aero-coupling input; `implicit.build_field_solve_fn` takes it as a
        differentiable argument instead)."""
        self.f_field = torch.as_tensor(f_coef, dtype=DTYPE).to(
            self.device).contiguous()
        self._data = None

    def set_contact(self, pairs, k_pen, r_max):
        """Enable shell-shell contact between patch pairs (the reference's
        ShellContactContext hook; physics/contact.py)."""
        self.contact = contact_.build_contact(pairs, k_pen, r_max,
                                              device=self.device)
        self._data = None

    def set_pressure(self, p_per_patch):
        """Uniform follower (normal) pressure per patch (scalar or (P,))."""
        self.pressure = tensor(np.broadcast_to(
            np.asarray(p_per_patch, dtype=np.float64),
            (self.num_splines,)), self.device)
        self._data = None

    @property
    def data(self) -> SystemData:
        if self._data is None:
            max_loc = self.stack.conn.shape[-1]
            self._data = SystemData(
                stack=self.stack, ifs=self.ifs,
                free=tensor(self._free, self.device),
                E=self.E, nu=self.nu, f_areal=self.f_areal,
                point_loads=build_point_loads(
                    self.surfs, self.point_load_entries, max_loc=max_loc,
                    device=self.device),
                pressure=self.pressure,
                edge_loads=build_edge_loads(
                    self.surfs, self.edge_load_entries, max_loc=max_loc,
                    device=self.device),
                f_field=self.f_field, contact=self.contact)
        return self._data

    def zero_displacement(self):
        return torch.zeros_like(self.cp)

    # -------------------------------------------------- solves
    def solve_nonlinear(self, cp=None, h=None, d0=None, rtol=1e-10,
                        atol=0.0, max_it=30, verbose=False):
        """Damped-Newton solve for displacements on a persistent factor
        (`implicit.newton_solve_host`)."""
        from goldfish_tpu_torch.solver.devicechol import (
            PersistentDeviceFactor,
        )
        from goldfish_tpu_torch.solver.implicit import newton_solve_host

        cp = self.cp if cp is None else cp
        h = self.h_init if h is None else h
        d = self.zero_displacement() if d0 is None else d0
        d, it, rn = newton_solve_host(self.data,
                                      PersistentDeviceFactor(self.data), cp,
                                      h, d, rtol=rtol, atol=atol,
                                      max_it=max_it)
        if verbose:
            print(f"  newton: {int(it)} its, |r| = {float(rn):.3e}")
        return d

    # -------------------------------------------------- objectives
    def internal_energy(self, d, cp=None, h=None):
        cp = self.cp if cp is None else cp
        h = self.h_init if h is None else h
        return kl_shell.internal_energy(self.stack, d, cp, h, self.E, self.nu)

    def volume(self, cp=None, h=None):
        cp = self.cp if cp is None else cp
        h = self.h_init if h is None else h
        return kl_shell.volume(self.stack, cp, h)

    def evaluate_displacement(self, d, patch: int, xi):
        """u(xi) (3,) numpy on one patch (host helper for QoI checks)."""
        s = self.surfs[patch]
        p, q = s.degree
        conn, tab = rational_basis_2d(
            s.knots[0], s.knots[1], p, q, s.weights,
            np.asarray(xi, dtype=np.float64)[None, :], nd=0)
        dloc = d[patch].detach().cpu().numpy()[conn[0]]
        return tab[(0, 0)][0] @ dloc
