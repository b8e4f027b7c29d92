"""Non-matching system with moving intersections (shape optimization).

Port of goldfish_tpu/solver/system_mi.py. The chain is

    xi = CPIGA2Xi.solve(cp)           [torch.autograd.Function, K7]
    d  = solve_mi(cp, h, xi, d0)      [torch.autograd.Function]
    J  = objective(d, cp, h)

and `J.backward()` composes the two implicit-function adjoints. At a given
xi the moving-intersection system is a fixed-intersection one whose
interface rows K5 evaluates at xi (`data_at`), so its energy, residual,
tangent, jet Hessians and (cp, h) adjoint are the fixed-intersection
kernels' (K1-K4); the xi cotangent of the residual is K6 (mode 0), its xi
tangent K6's mode 1 (`residual_jvp_mi`).

`PersistentDeviceFactorMI` shares the policy of devicechol.
PersistentDeviceFactor (subclass over the state (cp, h, xi, d)) and adds
the Woodbury seam correction: a one-design-step xi motion leaves the
element blocks ~1e-3-stale (benign for IR) but changes the seam rows enough
that the IR iteration matrix has spectral radius O(0.3-1) along the Newton
step, which would force a refactorization every warm solve. The
preconditioner P = K_ref + U^T dK_m U, with U selecting the seam dof
subspace (M dofs) and dK_m the current-minus-reference interface stiffness
on it, is applied by Woodbury:

    P^-1 r = s - V (U s),   s = K_ref^-1 r,   V = W C^-1 dK_m,
    W = K_ref^-1 U^T (one multi-RHS substitution per factorization, K13),
    C = I + dK_m U W   (solved directly in f64 per design step),

with dK_m assembled by K3 through a map from global dofs to seam slots
(one padding slot with a zero `free` entry takes every other dof). The
reference's f32 capacitance inverse with Newton-Schulz polish and its
one-hot einsum assembly exist for the TPU and do not cross.

On a patch-sharded system (`SystemData.shard`) each rank takes its block of
the seams (`split_block` of the seam count), builds only their rows at xi
(K5 on its seams), and the operators sum over the ranks as in
solver/system.py: the xi cotangent and tangent products (K6) with one
all-reduce together with the (cp, h) parts. The Woodbury subspace U is the
union of all ranks' seam dofs and the seam stiffness on it is summed over
the ranks, so the capacitance solve stays whole and replicated. The CP ->
xi solve (K5, K7) is design-side and small; it runs replicated.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from goldfish_tpu_torch.config import DTYPE, INDEX_DTYPE
from goldfish_tpu_torch.geometry.cpiga2xi import CPIGA2Xi
from goldfish_tpu_torch.opt.warmstart import SecantWarmStart
from goldfish_tpu_torch.physics import coupling
from goldfish_tpu_torch.physics.coupling_mi import (
    build_mi_coupling,
    interface_stack_mi,
    penalty_xi_jvp,
    penalty_xi_vjp,
)
from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
from goldfish_tpu_torch.solver.implicit import damped_newton
from goldfish_tpu_torch.solver.system import (
    NonMatchingSystem,
    SystemData,
    _part,
    _residual_jvp_parts,
    _residual_vjp_parts,
    assemble_K,
    assemble_K_from,
    interface_tables,
    jet_assemble,
    jet_hessians,
    potential_and_residual,
    tangent_matvec_from,
)

__all__ = ["MINonMatchingSystem", "data_at", "total_potential_mi",
           "residual_mi", "residual_jvp_mi", "assemble_K_mi", "PersistentDeviceFactorMI",
           "newton_solve_mi_host", "adjoint_lambda_mi", "adjoint_solve_mi",
           "build_solve_fn_mi"]


def _rank_seams(data: SystemData, mi, co, xi, *rows):
    """(a, b, mi, co, xi, *rows) of this process's seams: all of them, as
    they are, on a whole system; on a sharded one the rank's block [a, b)
    (`split_block`), with the same rows of the (I, ...) tensors `rows`, or
    None when the block is empty."""
    if data.shard is None:
        return (0, mi.n_int, mi, co, xi) + rows
    a, b = data.shard.block(mi.n_int)
    if a == b:
        return None
    return (a, b, type(mi)(*(t[a:b] for t in mi)),
            type(co)(*(t[a:b] for t in co))) + tuple(
        t.reshape(mi.n_int, -1)[a:b].contiguous() for t in (xi,) + rows)


def data_at(data: SystemData, mi, co, ss, p, q, xi) -> SystemData:
    """The fixed-intersection SystemData of the MI system at xi (I, 4N):
    its interface stack has K5's rows at xi. The loads (the areal field
    load too) and contact ride along unchanged: contact pairs the shell
    qps of whole patches, which xi does not move, so the reference's
    total_potential_mi / assemble_K_mi with contact and the field load
    (system_mi.py:44-110) are the fixed-intersection ones at these rows.
    Of a patch-sharded system the stack holds the rank's seams only (None
    when it has none): the seams are taken before the rows are built, so
    that K5 runs on the rank's seams alone (each seam's rows and tangents
    depend on its own points only)."""
    seams = _rank_seams(data, mi, co, xi)
    if seams is None:
        return data._replace(ifs=None)
    _, _, mi, co, xi = seams
    return data._replace(ifs=interface_stack_mi(ss, p, q, mi, co, xi))


def total_potential_mi(data, mi, co, ss, p, q, d, cp, h, xi):
    """Pi = W_int + W_penalty(xi) + W_contact - W_ext."""
    return potential_and_residual(data_at(data, mi, co, ss, p, q, xi), d,
                                  cp, h)[0]


def residual_mi(data, mi, co, ss, p, q, d, cp, h, xi):
    """R = dPi/dd at xi, BC-masked."""
    return potential_and_residual(data_at(data, mi, co, ss, p, q, xi), d,
                                  cp, h)[1]


def assemble_K_mi(data, mi, co, ss, p, q, d, cp, h, xi):
    """Dense BC-reduced tangent at xi: element blocks + moving-interface
    blocks, both through K3, and with contact K12 mode 2's blocks."""
    return assemble_K(data_at(data, mi, co, ss, p, q, xi), d, cp, h)


def _res_vjp_mi(data, mi, co, ss, p, q, d, cp, h, xi, lam):
    """(dcp, dh, dxi) = -lam^T dR/d(cp, h, xi): K1/K2 adjoint mode on the
    rows at xi (with contact `contact_adjoint`, K12's hvp; with the field
    load its cp-dependence), and K6 for xi (neither enters it). Sharded:
    each rank's parts, then one all-reduce of (dcp, dh, dxi)."""
    dcp, dh = _residual_vjp_parts(data_at(data, mi, co, ss, p, q, xi), d,
                                  cp, h, lam)
    seams = _rank_seams(data, mi, co, xi)
    if seams is None:
        dxi = torch.zeros(mi.n_int, xi.shape[-1], dtype=DTYPE,
                          device=xi.device)
    else:
        a, b, mi_l, co_l, xi_l = seams
        dxi = penalty_xi_vjp(ss, p, q, mi_l, co_l, xi_l, d, cp, h, data.E,
                             (lam * data.free).contiguous())
        if (a, b) != (0, mi.n_int):
            dxi = torch.cat([dxi.new_zeros((a,) + dxi.shape[1:]), dxi,
                             dxi.new_zeros((mi.n_int - b,) + dxi.shape[1:])])
    return _part(data).sum(dcp, dh, dxi)


def residual_jvp_mi(data, mi, co, ss, p, q, d, cp, h, xi, tcp=None, th=None,
                    txi=None):
    """free * (dR/dcp tcp + dR/dh th + dR/dxi txi) at xi, the forward
    design product: `residual_jvp` (K1 and K2 design modes, K8, with
    contact K12 mode 3 where tcp != 0) on the rows at xi, and K6's mode 1
    for xi. A tangent that is None is zero (its part
    is skipped; tcp and th go together). Sharded: one all-reduce."""
    out = torch.zeros_like(d)
    if tcp is not None or th is not None:
        out = out + _residual_jvp_parts(
            data_at(data, mi, co, ss, p, q, xi), d, cp, h,
            torch.zeros_like(cp) if tcp is None else tcp,
            torch.zeros_like(h) if th is None else th)
    if txi is not None:
        seams = _rank_seams(data, mi, co, xi, txi)
        if seams is not None:
            _, _, mi_l, co_l, xi_l, txi_l = seams
            out = out + penalty_xi_jvp(ss, p, q, mi_l, co_l, xi_l, d, cp, h,
                                       data.E, txi_l) * data.free
    return _part(data).sum(out)


# ------------------------------------------------------------ factor
class PersistentDeviceFactorMI(PersistentDeviceFactor):
    """The MI tangent's persistent f64 factor with the Woodbury seam
    correction; state (cp, h, xi, d).

    The MI path never refreshes on moderate drift (the correction rides
    xi staleness), so a factor pinned at a bad state would survive the
    warm loop; solve entries (`newton_solve_mi_host`, `adjoint_solve_mi`)
    refresh it when the measured contraction exceeds `rho_refresh` (0.2:
    healthy post-step factors measure 0.15-0.18, the pinned-bad population
    0.26 and up, system_mi.py:453-475 of the reference). A contact block
    made stale by the contact set's change fails the same certificates.

    With contact the factor is an LU (`kind="lu"`), as the reference's
    direct MI Newton solves: the pair potential's transverse stiffness
    (phi'/r < 0) leaves the tangent indefinite at Newton iterates that
    press into the stop, where a Cholesky factor fails (ROADMAP C20)."""

    rho_refresh = 0.2

    def __init__(self, data: SystemData, mi, co, ss, p, q):
        # data.ifs is None: element tables only
        super().__init__(data, kind="cholesky" if data.contact is None
                         else "lu")
        self.args = (data, mi, co, ss)
        self.p, self.q = p, q
        self._at_key = None
        self._at_val = None
        # Woodbury seam state
        self._M = None        # seam subspace size
        self._urows = None    # (M,) global dofs of the subspace
        self._slot = None     # (N,) global dof -> seam slot (M = none)
        self._free_m = None   # (M + 1,) 1, 0 on the padding slot
        self._W = None        # K_ref^-1 U^T (N, M)
        self._G = None        # U W (M, M)
        self._Km_ref = None   # interface stiffness on U at factor time
        self._V = None        # applied correction (N, M); None = zero
        self._prep_key = None

    # ------------------------------------------------------------ problem
    def _at(self, xi):
        """(SystemData at xi, JetTables at xi), cached on the identity of
        xi (a strong reference, so a new tensor never aliases it)."""
        if self._at_key is not xi:
            data, mi, co, ss = self.args
            dx = data_at(data, mi, co, ss, self.p, self.q, xi)
            R_i = gi_i = None
            if dx.ifs is not None:   # None: a sharded rank without seams
                R_i, gi_i = interface_tables(dx.ifs, data.stack.max_cp)
            self._at_key = xi
            self._at_val = (dx, self.tables._replace(R_i=R_i, gi_i=gi_i))
        return self._at_val

    def _assemble(self, s):
        cp, h, xi, d = s
        dx, tab = self._at(xi)
        return assemble_K_from(tab, jet_hessians(dx, d, cp, h))

    def _operator(self, s):
        cp, h, xi, d = s
        dx, tab = self._at(xi)
        Hs = jet_hessians(dx, d, cp, h)
        return lambda v: tangent_matvec_from(tab, Hs, v)

    @staticmethod
    def _drift(s, ref):
        """The fixed-intersection drift, and xi's own relative drift: the
        tangent depends on xi, so a xi-only design step must register."""
        (cp, h, xi, d), (cp0, h0, xi0, d0) = s, ref
        drift = PersistentDeviceFactor._drift((cp, h, d), (cp0, h0, d0))
        dxi = torch.linalg.norm(xi - xi0) / (torch.linalg.norm(xi0) + 1e-300)
        return torch.maximum(drift, dxi)

    def _rho_entry_refresh(self, s):
        """The MI solve entries refresh explicitly (see the class
        docstring); the policy's per-solve refresh is off."""

    def _subst(self, b):
        s = self._fac_solve(b.reshape(-1, 1))[:, 0]
        if self._V is not None:
            s = s - self._V @ s[self._urows]
        return s.reshape(b.shape)

    # ------------------------------------------------------------ Woodbury
    def _interface_hessians(self, s):
        cp, h, xi, d = s
        dx, tab = self._at(xi)
        if dx.ifs is None:
            return None, tab
        H = coupling.penalty_hessians(dx.ifs, d, cp, h, self.data.E)
        return H.reshape(-1, 1, coupling.NZ, coupling.NZ), tab

    def _compact_K(self, H_i, tab, assemble=jet_assemble):
        """Interface stiffness restricted to the seam subspace (M, M): K3
        (`assemble`) with the global dofs mapped to seam slots."""
        M = self._M
        K = torch.zeros(M + 1, M + 1, dtype=DTYPE, device=self._slot.device)
        if H_i is not None:
            g = self._slot[tab.gi_i.long()].to(INDEX_DTYPE).contiguous()
            assemble(K, H_i, tab.R_i, g, self._free_m)
        if self.data.shard is not None:
            # the ranks' seams summed: the capacitance system stays whole
            self.data.shard.sum(K)
        return K[:M, :M]

    def _after_factor(self, s):
        """Rebuild the Woodbury reference at the fresh factor's state: the
        seam dof subspace (dilated by one CP index in each parametric
        direction, so that single-span knot crossings of seam points stay
        inside U), the K_ref^-1 basis, zero correction."""
        data, mi, co, ss = self.args
        H_i, tab = self._interface_hessians(s)
        free = data.free.reshape(-1)
        # U is the union of every rank's seam dofs (one all-reduce of a dof
        # mask on a sharded system), the same on all ranks
        mask = torch.zeros_like(free)
        if tab.gi_i is not None:
            mask[tab.gi_i.long().reshape(-1)] = 1.0
        ur = torch.nonzero(_part(data).sum(mask)).reshape(-1).cpu().numpy()
        Cc = int(data.stack.max_cp)
        nv = ss.n_v.cpu().numpy()
        base, comp = ur // 3, ur % 3
        p_, c_ = base // Cc, base % Cc
        nvp = nv[p_]
        cand = [ur]
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                if du == 0 and dv == 0:
                    continue
                cn = c_ + du * nvp + dv
                ok = (cn >= 0) & (cn < Cc)
                cand.append(((p_ * Cc + cn) * 3 + comp)[ok])
        ur = np.unique(np.concatenate(cand))
        ur = ur[free.cpu().numpy()[ur] > 0.5]
        dev = free.device
        M = len(ur)
        self._M = M
        self._urows = torch.as_tensor(ur, device=dev)
        self._slot = torch.full((free.shape[0],), M, dtype=torch.int64,
                                device=dev)
        self._slot[self._urows] = torch.arange(M, device=dev)
        self._free_m = torch.ones(M + 1, dtype=DTYPE, device=dev)
        self._free_m[M] = 0.0
        U_T = torch.zeros(free.shape[0], M, dtype=DTYPE, device=dev)
        U_T[self._urows, torch.arange(M, device=dev)] = 1.0
        self._W = self._fac_solve(U_T)
        self._G = self._W[self._urows]
        self._Km_ref = self._compact_K(H_i, tab)
        self._V = None
        self._prep_key = None

    def prepare(self, cp, h, xi, d):
        """Per-design-step Woodbury update: make the preconditioner track
        the current seam position. Cached on the identity of (cp, xi) (a
        stale V only degrades the preconditioner; certificates still
        guarantee accuracy). Returns False when a seam point's support left
        the dilated subspace and the factor was rebuilt at this state
        instead (a "conn-escape")."""
        key = (cp, xi)
        if self._ref is None or (self._prep_key is not None
                                 and cp is self._prep_key[0]
                                 and xi is self._prep_key[1]):
            return True
        s = (cp, h, xi, d)
        H_i, tab = self._interface_hessians(s)
        free = self.data.free.reshape(-1)
        in_u = True
        if tab.gi_i is not None:
            gi = tab.gi_i.long()
            in_u = bool(((self._slot[gi] < self._M)
                         | (free[gi] <= 0.5)).all())
        if self.data.shard is not None:
            # each rank sees its own seams: the refactor is decided on all
            # ranks' flags together, or the ranks would part here
            in_u = self.data.shard.mesh.all_true(in_u)
        if not in_u:
            self._ensure(s, force=True, why="conn-escape")
            self._prep_key = key
            return False
        dKm = self._compact_K(H_i, tab) - self._Km_ref
        Cm = torch.eye(self._M, dtype=DTYPE, device=dKm.device) \
            + dKm @ self._G
        # solve_ex: a failed (NaN) base factor gives a NaN correction and a
        # non-finite certificate, as on every other solve against it
        self._V = self._W @ torch.linalg.solve_ex(Cm, dKm)[0]
        self._prep_key = key
        return True

    # ------------------------------------------------------------ API
    def ensure(self, cp, h, xi, d, force=False, stale_tol=None, why=""):
        return self._ensure((cp, h, xi, d), force, why, stale_tol)

    def drift_scalar(self, cp, h, xi, d):
        return self._drift_now((cp, h, xi, d))

    def dir_ir(self, cp, h, xi, d, r, tol=None):
        """One IR-exact direction for -r sized from the measured
        contraction: (delta, ratio, slope, rho_last, n); book it with
        `finish_ir(n, ratio, rho_last, tol, ...)`."""
        tol = self._DIR_TOL if tol is None else tol
        n = self._n_for(tol, self.rho_est)
        delta, ratio, slope, rho_last = self._ir_dir((cp, h, xi, d), r, n)
        return delta, ratio, slope, rho_last, n

    def newton_direction(self, cp, h, xi, d, r, tol=None):
        return self._newton_direction((cp, h, xi, d), r, tol)

    def ir_solve(self, cp, h, xi, d, b, x0=None):
        """One adjoint-grade IR solve of K x = b sized from the measured
        contraction, seeded from x0 when given: (x, ratio, n, rho_last);
        `finish_ir` books the certificate."""
        return self._solve_once((cp, h, xi, d), b, x0)

    def exact_solve(self, cp, h, xi, d, b, x0=None):
        return self._exact_solve((cp, h, xi, d), b, x0)


# ------------------------------------------------------------ Newton
def newton_solve_mi_host(data, mi, co, ss, p, q, cp, h, xi, d0,
                         rtol=1e-10, atol=1e-14, max_it=30, device_fac=None,
                         shared=None):
    """Damped Newton (`implicit.damped_newton`) on the MI system at fixed
    xi, on one persistent factor with the Woodbury seam correction.
    Returns (d, its, |r|).

    Directions are IR-exact (the moving-seam terms make substitution-only
    directions from a design-stale factor frequently non-descent). The
    entry refactors only when no factor exists, the drift is gross (0.2),
    or the factor is measured-mediocre (rho_est > rho_refresh) and has
    drifted; otherwise it refreshes the seam correction at xi. `shared`
    caches the load-scale |r(0)| across the solves of a warm loop."""
    fac = device_fac or PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    drift_ = fac.drift_scalar(cp, h, xi, d0)
    drift = None if drift_ is None else float(drift_)
    if drift is None:
        fac.ensure(cp, h, xi, d0, stale_tol=0.2, why="mi-entry")
    elif drift > 0.2:
        fac.ensure(cp, h, xi, d0, force=True, why="mi-entry")
    elif fac.rho_est > fac.rho_refresh and drift > fac.stale_tol:
        fac.ensure(cp, h, xi, d0, force=True, why="mi-entry-rho")
    fac.prepare(cp, h, xi, d0)

    def direction(d, r, slow):
        # inexact-Newton forcing 1e-3; the self-validating direction loop
        # re-sizes the sweeps or refactors when the certificate fails
        delta, ratio, slope, rho_last, n = fac.dir_ir(cp, h, xi, d, r)
        if fac.finish_ir(n, ratio, float(rho_last), tol=fac._DIR_TOL,
                         tag="dir-pipe"):
            return delta, float(slope)
        return fac.newton_direction(cp, h, xi, d, r)

    return damped_newton(
        data_at(data, mi, co, ss, p, q, xi), cp, h, d0, direction,
        lambda d: fac.ensure(cp, h, xi, d, force=True, why="stall"),
        rtol=rtol, atol=atol, max_it=max_it, shared=shared)


# ------------------------------------------------------------ adjoint
def adjoint_lambda_mi(data, mi, co, ss, p, q, d, cp, h, xi, g,
                      device_fac=None, lam_ws=None):
    """K(d) lam = g on the free dofs (lam masked) on the persistent MI
    factor, by certificate-gated IR.

    Plain and sequential: refresh the seam correction; one IR solve seeded
    from `lam_ws` (a SecantWarmStart over (cp, h, xi, g)) when it has a
    prediction; on a certificate miss, refactor when the factor is grossly
    stale or measured-mediocre, else top the near-answer up with a seeded
    `exact_solve`."""
    fac = device_fac or PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    b = g * data.free
    key = x0 = None
    if lam_ws is not None:
        key = torch.cat([cp.reshape(-1), h.reshape(-1), xi.reshape(-1),
                         g.reshape(-1)])
        x0 = lam_ws.predict(key, None)
    lam = None
    if fac._ref is not None:
        drift = float(fac.drift_scalar(cp, h, xi, d))
        fac.prepare(cp, h, xi, d)
        x, ratio, n, rho_last = fac.ir_solve(cp, h, xi, d, b, x0)
        ratio = float(ratio)
        if fac.finish_ir(n, ratio, float(rho_last),
                         tag="exact-x0-pipe" if x0 is not None
                         else "exact-pipe"):
            lam = x * data.free
        elif drift > 0.2 or (fac.rho_est > fac.rho_refresh
                             and drift > fac.stale_tol):
            fac.ensure(cp, h, xi, d, force=True, why="mi-adjoint")
            fac.prepare(cp, h, xi, d)
        elif math.isfinite(ratio):
            lam = fac.exact_solve(cp, h, xi, d, b, x0=x) * data.free
    else:
        fac.ensure(cp, h, xi, d, why="mi-adjoint")
        fac.prepare(cp, h, xi, d)
    if lam is None:
        lam = fac.exact_solve(cp, h, xi, d, b) * data.free
    if lam_ws is not None:
        lam_ws.update(key, lam)
    return lam


def adjoint_solve_mi(data, mi, co, ss, p, q, d, cp, h, xi, g,
                     device_fac=None, lam_ws=None):
    """MI adjoint on the persistent factor: lam = `adjoint_lambda_mi`, then
    (dcp, dh, dxi) = -lam^T dR/d(cp, h, xi)."""
    lam = adjoint_lambda_mi(data, mi, co, ss, p, q, d, cp, h, xi, g,
                            device_fac=device_fac, lam_ws=lam_ws)
    return _res_vjp_mi(data, mi, co, ss, p, q, d, cp, h, xi, lam)


# ------------------------------------------------------------ solve fn
class _SolverMI:
    """State shared by the forward and backward of one MI solve function:
    the persistent factor, the adjoint's secant seed, the Newton floor
    hint and the cached |r(0)|."""

    def __init__(self, data, mi, co, ss, p, q, rtol, atol, max_it):
        self.args = (data, mi, co, ss, p, q)
        self.rtol, self.atol, self.max_it = rtol, atol, max_it
        self.factor = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
        self.lam_ws = SecantWarmStart()
        self.floor_hint = atol
        self.shared = {}
        self.last_its = None

    def solve(self, cp, h, xi, d0):
        """Newton solve from d0 on the persistent factor
        (`newton_solve_mi_host`) with the floor hint; returns d."""
        d, its, rn = newton_solve_mi_host(
            *self.args, cp, h, xi, d0, rtol=self.rtol,
            atol=max(self.atol, self.floor_hint), max_it=self.max_it,
            device_fac=self.factor, shared=self.shared)
        self.last_its = its
        if its < self.max_it and rn <= 1e-2 * self.shared["r_ref"]:
            # converged or floored in the Newton basin
            self.floor_hint = max(self.atol, 1.5 * rn)
        return d


class _ImplicitSolveMI(torch.autograd.Function):

    @staticmethod
    def forward(ctx, solver: _SolverMI, cp, h, xi, d0):
        cp, h, xi = cp.detach(), h.detach(), xi.detach()
        d = solver.solve(cp, h, xi, d0.detach())
        ctx.solver = solver
        # the very (cp, xi) objects of the forward: the factor's Woodbury
        # update is cached on their identity, so the adjoint reuses it
        ctx.state = (d.detach(), cp, h, xi)
        return d

    @staticmethod
    def backward(ctx, g):
        d, cp, h, xi = ctx.state
        s = ctx.solver
        dcp, dh, dxi = adjoint_solve_mi(*s.args, d, cp, h, xi, g,
                                        device_fac=s.factor,
                                        lam_ws=s.lam_ws)
        return None, dcp, dh, dxi, None


def build_solve_fn_mi(data, mi, co, ss, p, q, rtol=1e-10, atol=1e-14,
                      max_it=30):
    """Differentiable `solve(cp, h, xi, d0) -> d`; its backward delivers
    dR/dcp, dR/dh and dR/dxi cotangents through the adjoint. The persistent
    factor is `solve.device_factor`."""
    solver = _SolverMI(data, mi, co, ss, p, q, rtol, atol, max_it)

    def solve(cp, h, xi, d0):
        return _ImplicitSolveMI.apply(solver, cp, h, xi, d0)

    solve.device_factor = solver.factor
    solve.solver = solver
    return solve


# ------------------------------------------------------------ facade
class MINonMatchingSystem(NonMatchingSystem):
    """Shape optimization with intersections that move with the design
    (reference: NonMatchingOpt.create_diff_intersections + CPIGA2Xi +
    DispMintImOperation)."""

    def __init__(self, surfs, E, nu, h_th, specs, n_pts_list=None,
                 penalty_coefficient: float = 1.0e3, device=None):
        super().__init__(surfs, E, nu, h_th, specs=None,
                         penalty_coefficient=penalty_coefficient,
                         device=device)
        self.c2x = CPIGA2Xi(surfs, specs, n_pts_list=n_pts_list,
                            device=self.device)
        self.mi = self.c2x.mi
        self.ss = self.c2x.ss
        self.pdeg, self.qdeg = self.c2x.p, self.c2x.q
        self.co = build_mi_coupling(surfs, self.mi, penalty_coefficient,
                                    device=self.device)

    @property
    def mi_args(self):
        """(data, mi, co, ss, p, q): the leading arguments of the MI
        functions of this module."""
        return (self.data, self.mi, self.co, self.ss, self.pdeg, self.qdeg)

    def build_forward(self, rtol=1e-10, max_it=30):
        """`forward(cp, h, d0, xi0=None) -> (d, xi)`, differentiable in cp
        and h. Passing the previous iteration's xi as `xi0` warm-starts the
        CP -> xi Newton solve. `forward.solve_d` is the displacement solve
        (its persistent factor is `forward.solve_d.device_factor`)."""
        solve_d = build_solve_fn_mi(*self.mi_args, rtol=rtol, max_it=max_it)
        c2x = self.c2x

        def forward(cp, h, d0, xi0=None):
            xi = c2x.solve(cp, xi0)
            return solve_d(cp, h, xi, d0), xi

        forward.solve_d = solve_d
        return forward

    def solve_nonlinear(self, cp=None, h=None, d0=None, rtol=1e-10,
                        atol=0.0, max_it=30, verbose=False):
        """The coupled MI equilibrium at cp: xi = c2x.solve(cp), then the
        MI Newton solve at xi (`newton_solve_mi_host`) on a fresh
        persistent factor with the Woodbury seam correction. Returns d.
        (The base class's solve knows no moving seam: its data carries no
        interface terms.)"""
        cp = self.cp if cp is None else cp
        h = self.h_init if h is None else h
        d = self.zero_displacement() if d0 is None else d0
        xi = self.c2x.solve(cp).detach()
        d, it, rn = newton_solve_mi_host(
            *self.mi_args, cp, h, xi, d, rtol=rtol, atol=atol, max_it=max_it,
            device_fac=PersistentDeviceFactorMI(*self.mi_args))
        if verbose:
            print(f"  newton(mi): {int(it)} its, |r| = {float(rn):.3e}")
        return d
