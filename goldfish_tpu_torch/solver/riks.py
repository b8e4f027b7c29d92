"""Crisfield arc-length (Riks) continuation for limit-point paths.

Port of goldfish_tpu/solver/riks.py. Traces the equilibrium path
R(d, lam) = r_int(d) - lam f_ext = 0 through limit points (snap-through,
snap-back), where load-controlled Newton jumps or diverges. The load
factor lam joins the unknowns and the cylindrical arc constraint

    |d - d_n|^2 + psi^2 (lam - lam_n)^2 |q|^2 = dl^2

replaces the load ramp; each corrector solves the bordered system with two
tangent solves (K \\ R and K \\ q, Crisfield 1981) and takes the quadratic
root that keeps moving along the path. Loads follow `scale_loads`, so
every load type takes part.

On the card, per tangent: the dense K at lam by K1/K2/K8 mode (b) and K3,
then one f64 LU (`torch.linalg.lu_factor_ex`, getrf) and one `lu_solve`
with both right-hand sides. LU, not Cholesky: past the limit point K is
indefinite. q = -dR/dlam is the external force at unit load scale: every
port load is linear in its scale (the follower pressure's K8 force too),
so it equals the reference's jvp through `scale_loads` without AD.

A host loop: the arc-length solve prepares or probes a state, it is not
the optimizer's hot loop.
"""

from __future__ import annotations

import torch

from goldfish_tpu_torch.physics.loads import external_work_and_force
from goldfish_tpu_torch.solver.system import (
    SystemData,
    assemble_K,
    potential_and_residual,
    scale_loads,
)

__all__ = ["riks_solve"]


def _R_q(data: SystemData, cp, h, d, lam):
    """The residual at load factor lam and q = -dR/dlam, both masked."""
    R = potential_and_residual(scale_loads(data, lam), d, cp, h)[1]
    one = scale_loads(data, 1.0)
    _, f = external_work_and_force(data.stack, d, cp, one.f_areal,
                                   one.point_loads, one.pressure,
                                   one.edge_loads, one.f_field)
    return R, f * data.free


def _tangent_solves(data: SystemData, cp, h, d, lam, R, q, stats=None):
    """One factorization, two solves: dd_r = -K \\ R, dd_q = K \\ q."""
    K = assemble_K(scale_loads(data, lam), d, cp, h)
    free = data.free
    rhs = torch.stack([(-R * free).reshape(-1), (q * free).reshape(-1)], 1)
    LU, piv, _ = torch.linalg.lu_factor_ex(K)
    del K
    sol = torch.linalg.lu_solve(LU, piv, rhs)
    if stats is not None:
        stats["n_lu"] = stats.get("n_lu", 0) + 1
    return (sol[:, 0].reshape(d.shape) * free,
            sol[:, 1].reshape(d.shape) * free)


def _arc_root(Dd, Dlam, dd_r, dd_q, q2, dl, psi):
    """delta-lam from the cylindrical constraint: the root of
    a x^2 + b x + c closest to continuing along the current increment
    (None when the arc is too small for this correction)."""
    t = Dd + dd_r
    qq, tq, tt, ddt, ddq = torch.stack([
        torch.sum(dd_q * dd_q), torch.sum(t * dd_q), torch.sum(t * t),
        torch.sum(Dd * t), torch.sum(Dd * dd_q)]).tolist()
    a = qq + psi**2 * q2
    b = 2.0 * (tq + psi**2 * Dlam * q2)
    c = tt + psi**2 * Dlam**2 * q2 - dl**2
    disc = b * b - 4.0 * a * c
    if disc < 0.0 or a <= 0.0:
        return None
    s = disc ** 0.5
    x1 = (-b + s) / (2.0 * a)
    x2 = (-b - s) / (2.0 * a)

    # continue forward: the larger alignment of the new increment with the
    # old one (Crisfield's angle criterion)
    def align(x):
        return ddt + x * ddq + psi**2 * q2 * Dlam * (Dlam + x)

    return x1 if align(x1) >= align(x2) else x2


def riks_solve(data: SystemData, cp, h, d0, lam0=0.0, lam_target=1.0,
               dlam0=0.1, rtol=1e-8, max_it=20, max_steps=200, psi=1.0,
               dl_max=None, verbose=False, stats=None):
    """Trace the equilibrium path from (d0, lam0) toward lam_target.

    Returns (d, lam, path), path a list of (lam, |d|_2) per converged
    point; (d, lam) is the last converged state: lam == lam_target when
    the path reaches it (a closing load-controlled Newton on a fresh LU
    factor polishes it there), else the furthest traced point. `stats`,
    when given, gets the LU count (`n_lu`), the steps taken (`steps`), the
    corrector iterations per converged step (`its`) and the polish's Newton
    iterations (`polish_its`)."""
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.implicit import newton_solve_host

    stats = {} if stats is None else stats
    stats.setdefault("n_lu", 0)
    free = data.free
    d = d0
    lam = float(lam0)

    R, q = _R_q(data, cp, h, d, lam)
    q2, nq = torch.stack([torch.sum(q * q), torch.linalg.norm(q)]).tolist()
    r_ref = max(nq, 1e-300)

    # initial increment: the load-controlled predictor of size dlam0
    dd_r, dd_q = _tangent_solves(data, cp, h, d, lam, R, q, stats)
    dl = max(float(torch.linalg.norm(dlam0 * dd_q)), 1e-12)
    Dd_prev = dlam0 * dd_q
    Dlam_prev = dlam0

    path = [(lam, float(torch.linalg.norm(d)))]
    its = stats.setdefault("its", [])

    for step in range(max_steps):
        stats["steps"] = step + 1
        # ---- predictor along the previous increment
        R, q = _R_q(data, cp, h, d, lam)
        dd_r, dd_q = _tangent_solves(data, cp, h, d, lam, R, q, stats)
        q2, nq, dirn = torch.stack([
            torch.sum(q * q), torch.linalg.norm(dd_q),
            torch.sum(Dd_prev * dd_q)]).tolist()
        Dlam = dl / (nq ** 2 + psi**2 * q2) ** 0.5
        # direction: continue the way the path was going
        if dirn + psi**2 * Dlam_prev * q2 < 0:
            Dlam = -Dlam
        Dd = Dlam * dd_q
        d_trial = d + Dd
        lam_trial = lam + Dlam

        # ---- corrector
        ok = False
        for it in range(max_it):
            R, q = _R_q(data, cp, h, d_trial, lam_trial)
            rn, q2 = torch.stack([torch.linalg.norm(R * free),
                                  torch.sum(q * q)]).tolist()
            if rn <= rtol * r_ref:
                ok = True
                break
            dd_r, dd_q = _tangent_solves(data, cp, h, d_trial, lam_trial, R,
                                         q, stats)
            dlam_c = _arc_root(Dd, Dlam, dd_r, dd_q, q2, dl, psi)
            if dlam_c is None:
                break
            Dd = Dd + dd_r + dlam_c * dd_q
            Dlam = Dlam + dlam_c
            d_trial = d + Dd
            lam_trial = lam + Dlam

        if not ok:
            dl *= 0.5
            if dl < 1e-14:
                break
            continue

        d, lam = d_trial, lam_trial
        Dd_prev, Dlam_prev = Dd, Dlam
        nd = float(torch.linalg.norm(d))
        path.append((lam, nd))
        its.append(it)
        if verbose:
            print(f"  riks step {step}: lam={lam:+.5f} |d|={nd:.4e} "
                  f"its={it} dl={dl:.3e}", flush=True)

        # adaptive arc: about 5 corrector iterations per step
        dl *= min(2.0, max(0.5, (5.0 / max(it, 1)) ** 0.5))
        if dl_max is not None:
            dl = min(dl, dl_max)

        if lam >= lam_target:
            # polish at exactly lam_target with load-controlled Newton
            data_t = scale_loads(data, lam_target)
            fac = PersistentDeviceFactor(data_t, kind="lu")
            d, pit, _ = newton_solve_host(data_t, fac, cp, h, d, rtol=rtol)
            stats["n_lu"] += fac.n_factor
            stats["polish_its"] = pit
            lam = float(lam_target)
            path.append((lam, float(torch.linalg.norm(d))))
            break

    return d, lam, path
