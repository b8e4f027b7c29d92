"""The port's matrix-free path (solver/krylov.py) against the JAX package.

Model: the small box wing `boxwing.build(n_sections=2, num_el=2, p=2)` (11
patches, 24 interfaces, C = 20, N = 660 padded dofs), the same host arrays
in both packages. The Newton state is the port's dense-route solution.

- K10's plain version (pair and patch blocks) against the principal
  submatrices of the JAX package's dense assemble_K;
- the pair-Schwarz sweep and the patch-block apply against the JAX
  package's applies and against the same sweep in f64 on its dense K;
- GMRES-IR with each preconditioner: the dense LU on the box wing, the
  pair-Schwarz sweep on the JAX package's own Krylov test model (the
  3-patch plate), the patch blocks on a single-patch plate, where block
  Jacobi is exact. On the box wing the pair-Schwarz and patch-block
  preconditioners do not converge, in either package (ROADMAP Queue C);
- Newton-Krylov against the JAX package's dense Newton solve, d compared
  physically (tests/test_krylov.py:54-56);
- dW_int/dh_ffd through `build_solve_fn_krylov` against the JAX package's
  dense implicit-function gradient. The JAX package's own matrix-free
  solve is not the oracle: on the box wing its GMRES stops on a
  preconditioned residual of the wrong scale and its Newton ends far from
  the solution (scripts/torch_port_krylov_convergence.py).
"""

import numpy as np
import pytest
import torch

from _torch_port_common import rel

BW_SMALL = dict(n_sections=2, num_el=2, p=2)


@pytest.fixture(scope="module")
def jax_bw():
    from goldfish_tpu.models import boxwing

    s = boxwing.build(**BW_SMALL)
    s.data
    return s


@pytest.fixture(scope="module")
def port_bw():
    from goldfish_tpu_torch.models import boxwing

    return boxwing.build(**BW_SMALL, device="cpu")


@pytest.fixture(scope="module")
def newton_state(port_bw):
    """The port's dense-route Newton solution at the start design."""
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor
    from goldfish_tpu_torch.solver.implicit import newton_solve_host

    s = port_bw
    d, _, _ = newton_solve_host(s.data, PersistentDeviceFactor(s.data), s.cp,
                                s.h_init, s.zero_displacement(), rtol=1e-10)
    return d


@pytest.fixture(scope="module")
def jax_K(jax_bw, newton_state):
    import jax.numpy as jnp

    from goldfish_tpu.solver.implicit import _jit_assemble_K

    s = jax_bw
    return np.asarray(_jit_assemble_K(s.data, s.cp, s.h_init,
                                      jnp.asarray(newton_state.numpy())))


@pytest.mark.parametrize("which", ["pairs", "patches"])
def test_pair_assemble_plain_matches_dense_K(port_bw, newton_state, jax_K,
                                             which):
    """A pair block is K's principal submatrix on the dofs of its two
    patches (only one interface links any two patches of the box wing); a
    patch block is K's diagonal block."""
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver import krylov
    from goldfish_tpu_torch.solver.system import jet_hessians

    s = port_bw
    P, n = s.stack.n_patches, 3 * s.stack.max_cp
    ps = krylov.PairSchwarz(s.data)
    Hs = jet_hessians(s.data, newton_state, s.cp, s.h_init)
    _cuda.reset_launch_counts()
    if which == "pairs":
        blocks = krylov.assemble_blocks(ps.blocks, ps.tables, Hs)
        dofs = [np.r_[ps.pairA[i] * n + np.arange(n),
                      ps.pairB[i] * n + np.arange(n)] for i in ps.order]
    else:
        blocks = krylov.assemble_blocks(krylov._block_tables(s.data),
                                        ps.tables, Hs)
        dofs = [p * n + np.arange(n) for p in range(P)]
    assert all(v == 0 for v in _cuda.launch_counts.values())
    assert blocks.shape == (len(dofs), len(dofs[0]), len(dofs[0]))
    scale = np.abs(jax_K).max()
    for blk, idx in zip(blocks.numpy(), dofs):
        ref = jax_K[np.ix_(idx, idx)]
        assert np.abs(blk - ref).max() <= 1e-12 * scale


def test_pair_schwarz_structure_matches_jax(jax_bw, port_bw):
    """The host structure crosses as it is: count, isolated patches, the
    extra self-quadrant lists and the greedy edge colouring."""
    from goldfish_tpu.solver.krylov import PairSchwarz as JaxPS
    from goldfish_tpu_torch.solver.krylov import PairSchwarz

    j, p = JaxPS(jax_bw.data), PairSchwarz(port_bw.data)
    assert np.array_equal(j.count, p.count)
    assert np.array_equal(j.iso, p.iso)
    assert j.extra == p.extra
    assert [c.tolist() for c in j.colors] == [c.tolist() for c in p.colors]


@pytest.mark.parametrize("which", ["pairs", "patches"])
def test_precond_apply_matches_jax(jax_bw, port_bw, newton_state, jax_K,
                                   which):
    """The pair-Schwarz sweep (colour order, equilibration, gathers, the
    tangent product between colours) and the patch-block apply, on one
    seeded vector at the Newton state: against the JAX package's own
    apply, whose f32 LU bounds the agreement (1.7e-5 for the sweep, 1.1e-7
    for the patch blocks on this model), and to 1e-10 against the same
    sweep in f64 on the JAX package's dense K and colouring."""
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.solver import krylov as jk
    from goldfish_tpu_torch.solver import krylov
    from goldfish_tpu_torch.solver.system import tangent_matvec

    j, s, d = jax_bw, port_bw, newton_state
    dj = jnp.asarray(d.numpy())
    P, n = s.stack.n_patches, 3 * s.stack.max_cp
    r = np.random.default_rng(3).normal(size=tuple(d.shape)) \
        * s.data.free.numpy()
    rf = r.reshape(-1)

    def eq_solve(idx, b):
        B = jax_K[np.ix_(idx, idx)]
        sc = 1.0 / np.sqrt(np.abs(np.diag(B)))
        return sc * np.linalg.solve(B * sc[:, None] * sc[None, :], sc * b)

    if which == "pairs":
        jps = jk.PairSchwarz(j.data)
        Kj = jnp.asarray(jax_K)
        # jitted: the JAX assemble and sweep run ~5x slower op by op
        z_jax = jax.jit(lambda d_, r_: jps.apply(
            jps.assemble(j.data, d_, j.cp, j.h_init), r_,
            lambda v: (Kj @ v.reshape(-1)).reshape(v.shape)))(
            dj, jnp.asarray(r))
        ps = krylov.PairSchwarz(s.data)
        z = ps.apply(ps.assemble(s.data, d, s.cp, s.h_init),
                     torch.from_numpy(r),
                     lambda v: tangent_matvec(s.data, d, s.cp, s.h_init, v))
        z64 = np.zeros_like(rf)
        for col in jps.colors:
            rc = rf - jax_K @ z64
            for i in col:
                idx = np.r_[jps.pairA[i] * n + np.arange(n),
                            jps.pairB[i] * n + np.arange(n)]
                z64[idx] += eq_solve(idx, rc[idx])
        tol_jax = 1e-4
    else:
        z_jax = jax.jit(lambda d_, r_: jk._apply_precond(
            jk.patch_block_precond(j.data, d_, j.cp, j.h_init), r_))(
            dj, jnp.asarray(r))
        z = krylov._apply_precond(krylov.patch_block_precond(
            s.data, d, s.cp, s.h_init), torch.from_numpy(r))
        z64 = np.concatenate([eq_solve(p * n + np.arange(n),
                                       rf[p * n:(p + 1) * n])
                              for p in range(P)])
        tol_jax = 1e-6
    assert rel(z, np.asarray(z_jax)) <= tol_jax
    assert rel(z.reshape(-1), z64) <= 1e-10


def test_pair_schwarz_isolated_patch():
    """A patch that no interface touches gets its own block, K's diagonal
    block there, solved exactly by the sweep (the small wing with the
    interfaces of patch 3 left out and its root edge clamped)."""
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.solver import krylov
    from goldfish_tpu_torch.solver.system import (
        NonMatchingSystem,
        assemble_K,
        tangent_matvec,
    )

    w = wing.build(n_chord=2, n_span=2, num_el=3, p=3, device="cpu")
    s = NonMatchingSystem(w.surfs, wing.E, wing.NU, wing.H_TH,
                          specs=[sp for sp in w.specs if 3 not in sp.pair],
                          device="cpu")
    for k in (0, 1, 3):
        s.add_side_bc(k, direction=1, side=0, n_layers=2)
    s.set_dead_load([0.0, 0.0, wing.LIFT])
    d = s.zero_displacement()
    ps = krylov.PairSchwarz(s.data)
    assert ps.iso.tolist() == [3]
    fac = ps.assemble(s.data, d, s.cp, s.h_init)
    r = torch.from_numpy(np.random.default_rng(2).normal(
        size=tuple(d.shape))) * s.data.free
    z = ps.apply(fac, r, lambda v: tangent_matvec(s.data, d, s.cp, s.h_init,
                                                  v))
    n = 3 * s.stack.max_cp
    K = assemble_K(s.data, d, s.cp, s.h_init)[3 * n:4 * n, 3 * n:4 * n]
    z3 = torch.linalg.solve(K, r[3].reshape(-1))
    assert rel(z[3].reshape(-1), z3.numpy()) <= 1e-8


def _plate(num_patches):
    from goldfish_tpu_torch.models import plate

    return plate.build(num_el=3, p=2, num_patches=num_patches, device="cpu")


@pytest.mark.parametrize("precond", ["full", "pair_schwarz", "patch_block"])
def test_gmres_solve_reaches_dense_solution(port_bw, newton_state, precond):
    from goldfish_tpu_torch.solver import krylov
    from goldfish_tpu_torch.solver.system import assemble_K, tangent_matvec

    if precond == "full":
        s, d = port_bw, newton_state
    else:
        s = _plate(3 if precond == "pair_schwarz" else 1)
        d = s.zero_displacement()
    data, cp, h = s.data, s.cp, s.h_init
    rng = np.random.default_rng(1)
    x_true = torch.from_numpy(rng.normal(size=tuple(d.shape))) * data.free
    b = tangent_matvec(data, d, cp, h, x_true)
    if precond == "full":
        pre = krylov.full_precond(data, d, cp, h)
    elif precond == "pair_schwarz":
        ps = krylov.PairSchwarz(data)
        pre = (ps, ps.assemble(data, d, cp, h))
    else:
        pre = krylov.patch_block_precond(data, d, cp, h)
    x, cycles = krylov.gmres_solve(data, d, cp, h, b, pre, rtol=1e-12,
                                   restart=32, maxiter=20)
    assert cycles >= 1
    res = tangent_matvec(data, d, cp, h, x) - b
    assert float(torch.linalg.norm(res) / torch.linalg.norm(b)) <= 1e-10
    K = assemble_K(data, d, cp, h)
    x_dense = torch.linalg.solve(K, b.reshape(-1)).reshape(b.shape)
    assert rel(x, x_dense.numpy()) <= 1e-6


def test_newton_krylov_matches_jax_dense_newton(jax_bw, port_bw):
    import jax.numpy as jnp

    from goldfish_tpu.solver.implicit import newton_solve
    from goldfish_tpu_torch.solver import krylov

    s = port_bw
    log = []
    d, it, rn = krylov.newton_krylov_solve(
        s.data, s.cp, s.h_init, s.zero_displacement(), rtol=1e-9,
        cg_rtol=1e-8, log=log)
    j = jax_bw
    d_ref, _, _ = newton_solve(j.data, j.cp, j.h_init,
                               jnp.zeros_like(j.cp), rtol=1e-11)
    assert 1 <= it <= 30 and np.isfinite(rn)
    assert all(len(e) == 4 for e in log)
    assert rel(d, np.asarray(d_ref)) <= 1e-6


def test_pair_schwarz_solve_fn_on_plate():
    """`build_solve_fn_krylov(precond="pair_schwarz")` where that
    preconditioner converges (the 3-patch plate): d and dW_int/dh against
    the port's dense implicit solve."""
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.implicit import build_solve_fn
    from goldfish_tpu_torch.solver.krylov import build_solve_fn_krylov

    s = _plate(3)
    out = {}
    for name, solve in (
            ("pair", build_solve_fn_krylov(s.data, rtol=1e-9, cg_rtol=1e-8,
                                           precond="pair_schwarz")),
            ("dense", build_solve_fn(s.data, rtol=1e-10))):
        h = s.h_init.clone().requires_grad_(True)
        d = solve(s.cp, h, s.zero_displacement())
        J = kl_shell.internal_energy(s.stack, d, s.cp, h, s.E, s.nu)
        J.backward()
        out[name] = (d.detach(), h.grad)
    assert rel(out["pair"][0], out["dense"][0].numpy()) <= 1e-6
    assert rel(out["pair"][1], out["dense"][1].numpy()) <= 1e-6


@pytest.mark.parametrize("const_th", [False, True])
def test_krylov_gradient_matches_jax_dense_gradient(jax_bw, port_bw,
                                                    const_th):
    import jax
    import jax.numpy as jnp

    from goldfish_tpu.design.pipeline import PatchConstantThickness as JPC
    from goldfish_tpu.design.pipeline import ThicknessFFD as JTF
    from goldfish_tpu.physics import kl_shell as jkl
    from goldfish_tpu.solver import linalg
    from goldfish_tpu.solver.implicit import build_solve_fn as jbuild
    from goldfish_tpu_torch.design.pipeline import (
        PatchConstantThickness,
        ThicknessFFD,
    )
    from goldfish_tpu_torch.physics import kl_shell
    from goldfish_tpu_torch.solver.krylov import build_solve_fn_krylov

    j, s = jax_bw, port_bw
    if const_th:
        jt, pt = JPC(j), PatchConstantThickness(s)
        x0 = pt.init_h(3e-3)
    else:
        kw = dict(num_els=(1, 6, 1), p=(1, 2, 1))
        jt, pt = JTF(j, **kw), ThicknessFFD(s, **kw)
        x0 = pt.init_h_ffd(3e-3)
    linalg.set_mode("direct")
    try:
        jsolve = jbuild(j.data, rtol=1e-10, max_it=30)

        def jobj(x):
            h = jt(x)
            d = jsolve(j.cp, h, jnp.zeros_like(j.cp))
            return jkl.internal_energy(j.stack, d, j.cp, h, j.E, j.nu)

        J_ref, g_ref = jax.value_and_grad(jobj)(jnp.asarray(x0))
    finally:
        linalg.set_mode(None)
    solve = build_solve_fn_krylov(s.data, rtol=1e-9, cg_rtol=1e-8,
                                  precond="full")
    x = torch.tensor(x0, requires_grad=True)
    h = pt(x)
    d = solve(s.cp, h, s.zero_displacement())
    J = kl_shell.internal_energy(s.stack, d, s.cp, h, s.E, s.nu)
    J.backward()
    J_ref = float(J_ref)
    assert abs(float(J.detach()) - J_ref) <= 1e-9 * abs(J_ref)
    assert rel(x.grad, np.asarray(g_ref)) <= 1e-6
    assert solve.solver.adjoint_cycles and solve.solver.last_its >= 1
