"""K14 chol_factor: the blocked f64 Cholesky factor
(goldfish_tpu_torch/csrc/chol_factor.cu, goldfish_tpu_torch/solver/
cholesky.py: `chol_factor`) against the JAX package's blocked factor
(goldfish_tpu/solver/tpu_cholesky.py:139 `blocked_cholesky_unrolled`, the
facade `DeviceCholesky`).

Inputs: the seeded SPD K of tests/test_torch_chol_subst.py (N = 300, ragged
against both the 64-row blocks and the 256-column panels; eigenvalues spread
over 1e8, rows and columns scaled by e^N(0, 1), which the Jacobi
equilibration takes out again).

- (a) the port's `chol_factor` of the equilibrated K (on the CPU its plain
  version, `cholesky_ex` and `diag_inverses_plain`) against
  `DeviceCholesky(nb=64).factor(K)` and against `blocked_cholesky_unrolled`
  at nb = 256, mb = 16 on the padded K_eq: the two packages factor with
  their own algorithms, so L agrees to `_tol` = 64 cond(K_eq) 2.2e-16,
  relative in norm; `invs` against the JAX panel inverses (nb = 64, and the
  64-row diagonal blocks of the nb = 256 panels' inverses), the same bar;
- (b) `info` at an SPD matrix with diagonal entry j made negative is j + 1
  (`cholesky_ex`'s meaning); `PersistentDeviceFactor` then fills the factor
  and its inverses with NaN and logs the failure;
- (c) the wrapper's argument checks raise;
- (d) `torch.linalg.cholesky_ex` occurs in the port only inside the plain
  version;
- (e) on the card (`gpu`, skipped here): at N = 65, 300, 700, 701 (odd: the
  update's single-entry copies) and 1100 (more than four 256-column
  panels) the kernel against `cholesky_ex`: a
  well-conditioned K (A A^T / N + I) within 1e-12, the seeded K's factor
  backward error ||K - L L^T||_F / ||K||_F <= 4x cholesky_ex's, the same
  bits over 3 launches with one count a launch, `info` equal at an
  indefinite K, the inverses within 4x `diag_inverses`' backward error, and
  K13's solves on K14's factor within K13's gates. Run it there with
  `python -m pytest tests/test_torch_chol_factor.py -m gpu --noconftest -q`.
"""

import ast
import os

import numpy as np
import pytest
import torch

from test_torch_chol_subst import _rel, _spd, _tol

N_SMALL = 300


def _equilibrated(K):
    """K_eq = D K D, D = diag(|K|)^-1/2, as solver/devicechol.py makes it,
    and dsc."""
    Kt = torch.tensor(K, dtype=torch.float64)
    dsc = torch.rsqrt(Kt.diagonal().abs() + 1e-300)
    Kt.mul_(dsc[:, None]).mul_(dsc[None, :])
    return Kt, dsc


@pytest.fixture(scope="module")
def problem():
    import jax.numpy as jnp

    from goldfish_tpu.solver.tpu_cholesky import DeviceCholesky

    K, _ = _spd(N_SMALL, 23)
    dc64 = DeviceCholesky(nb=64).factor(jnp.asarray(K))
    dc256 = DeviceCholesky(nb=256, mb=16, unrolled=True).factor(
        jnp.asarray(K))
    return dict(K=K, L64=np.asarray(dc64._L)[:N_SMALL, :N_SMALL],
                invs64=np.asarray(dc64._invs),
                L256=np.asarray(dc256._L)[:N_SMALL, :N_SMALL],
                invs256=np.asarray(dc256._invs))


def test_factor_matches_the_jax_blocked_cholesky(problem):
    from goldfish_tpu_torch.solver import cholesky

    K_eq, _ = _equilibrated(problem["K"])
    before = K_eq.clone()
    L, info, invs = cholesky.chol_factor(K_eq)
    tol = _tol(K_eq)
    assert tol < 1e-5
    assert int(info) == 0 and info.dtype == torch.int32 and info.dim() == 0
    assert L.stride() == (1, N_SMALL)          # as K13 reads it
    assert torch.equal(K_eq, before)           # the plain version keeps K
    assert float(L.triu(1).abs().max()) == 0.0
    assert _rel(L, problem["L64"]) <= tol
    assert _rel(L, problem["L256"]) <= tol
    assert float(torch.linalg.norm(K_eq - L @ L.T)
                 / torch.linalg.norm(K_eq)) <= 1e-14


def test_inverses_match_the_jax_panel_inverses(problem):
    from goldfish_tpu_torch.solver import cholesky

    K_eq, _ = _equilibrated(problem["K"])
    tol = _tol(K_eq)
    L, _, invs = cholesky.chol_factor(K_eq)
    nb = -(-N_SMALL // cholesky.NB)
    assert tuple(invs.shape) == (nb, cholesky.NB, cholesky.NB)
    assert torch.equal(invs, cholesky.diag_inverses_plain(L))
    X = invs.transpose(1, 2).numpy()           # block k: L_kk^-1
    assert _rel(X, problem["invs64"]) <= tol
    # the 64-row diagonal blocks of the 256-column panels' inverses
    per = cholesky.PW // cholesky.NB
    sub = np.stack([problem["invs256"][k // per][
        (k % per) * 64:(k % per + 1) * 64, (k % per) * 64:(k % per + 1) * 64]
        for k in range(nb)])
    assert _rel(X, sub) <= tol


@pytest.mark.parametrize("j", [0, 137, N_SMALL - 1])
def test_info_is_the_first_failing_column(j):
    from goldfish_tpu_torch.solver import cholesky

    K, _ = _spd(N_SMALL, 23)
    K[j, j] = -K[j, j]
    K_eq, _ = _equilibrated(K)
    _, info, _ = cholesky.chol_factor(K_eq)
    assert int(info) == j + 1


def test_failed_factor_fills_nan_and_logs():
    from goldfish_tpu_torch.models import wing
    from goldfish_tpu_torch.solver.devicechol import PersistentDeviceFactor

    s = wing.build(n_chord=2, n_span=2, num_el=2, p=2, device="cpu")
    free = np.flatnonzero(s.data.free.reshape(-1).numpy())
    j = int(free[len(free) // 2])

    class Flipped(PersistentDeviceFactor):
        def _assemble(self, st):
            K = super()._assemble(st)
            K[j, j] = -K[j, j]
            return K

    fac = Flipped(s.data)
    assert fac.ensure(s.cp, s.h_init, s.zero_displacement(), force=True)
    assert not fac.factor_ok
    assert fac.failed_info == [j + 1] and fac.n_factor_failed == 1
    assert fac.refactor_log[-1][0].endswith("/indefinite")
    assert bool(torch.isnan(fac._L).all()) and bool(torch.isnan(
        fac._invs).all())
    b = torch.ones(fac._L.shape[0], dtype=torch.float64)
    assert not bool(torch.isfinite(fac._subst(b)).any())


def _bad_calls():
    from goldfish_tpu_torch.solver import cholesky as ch

    K, _ = _equilibrated(_spd(70, 3)[0])
    return {
        "K float32": (lambda: ch.chol_factor(K.float()), TypeError),
        "K not square": (lambda: ch.chol_factor(K[:, :69].contiguous()),
                         ValueError),
        "K one-dimensional": (lambda: ch.chol_factor(K[0]), ValueError),
        "K empty": (lambda: ch.chol_factor(K[:0, :0]), ValueError),
        "K column-major": (lambda: ch.chol_factor(K.t()), ValueError),
        "K a list": (lambda: ch.chol_factor(K.tolist()), TypeError),
    }


@pytest.mark.parametrize("case", ["K float32", "K not square",
                                  "K one-dimensional", "K empty",
                                  "K column-major", "K a list"])
def test_argument_checks_raise(case):
    call, exc = _bad_calls()[case]
    with pytest.raises(exc):
        call()


def test_cholesky_ex_only_in_the_plain_version():
    import goldfish_tpu_torch

    root = os.path.dirname(goldfish_tpu_torch.__file__)
    uses, where = 0, set()
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            hit = lambda n: isinstance(n, ast.Attribute) \
                and n.attr in ("cholesky_ex", "cholesky")  # noqa: E731
            uses += sum(hit(n) for n in ast.walk(tree))
            where |= {(os.path.relpath(path, root), fn.name)
                      for fn in ast.walk(tree)
                      if isinstance(fn, ast.FunctionDef)
                      and any(hit(n) for n in ast.walk(fn))}
    assert uses == 1
    assert where == {(os.path.join("solver", "cholesky.py"),
                      "chol_factor_plain")}, where


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _fac_bwd(K, L):
    return float(torch.linalg.norm(K - L @ L.T) / torch.linalg.norm(K))


def _solve_bwd(K, X, B):
    return float(torch.linalg.norm(K @ X - B)
                 / (torch.linalg.norm(K) * torch.linalg.norm(X)))


@pytest.mark.gpu
@pytest.mark.parametrize("N", [65, 300, 700, 701, 1100])
def test_kernel_matches_cholesky_ex_on_the_card(cuda, N):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver import cholesky as ch

    rng = np.random.default_rng(N)
    A = rng.normal(size=(N, N)) / np.sqrt(N)
    for K_np, well in ((A @ A.T + np.eye(N), True), (_spd(N, N)[0], False)):
        K_eq, dsc = (t.to(cuda) for t in _equilibrated(K_np))
        Lx, info_x = torch.linalg.cholesky_ex(K_eq)
        n0 = _cuda.launch_counts["chol_factor"]
        runs = [ch.chol_factor(K_eq.clone()) for _ in range(3)]
        torch.cuda.synchronize()
        assert _cuda.launch_counts["chol_factor"] == n0 + 3
        L, info, invs = runs[0]
        assert all(torch.equal(L, r[0]) and torch.equal(invs, r[2])
                   and int(r[1]) == int(info) for r in runs[1:])
        assert L.stride() == (1, N) and int(info) == int(info_x) == 0
        assert float(L.triu(1).abs().max()) == 0.0
        if well:
            assert _rel(L.cpu(), Lx.cpu()) <= 1e-12
        assert _fac_bwd(K_eq, L) <= 4.0 * _fac_bwd(K_eq, Lx)
        # the inverses: as diag_inverses' of the same factor
        Z = ch.diag_inverses(L)
        nb = invs.shape[0]
        if nb > 1:
            blocks = torch.stack([L[k * 64:(k + 1) * 64, k * 64:(k + 1) * 64]
                                  for k in range(nb - 1)])
            eye = torch.eye(64, dtype=torch.float64, device=cuda)

            def inv_bwd(V):
                Vt = V[:nb - 1].transpose(1, 2)
                return float(torch.linalg.norm(blocks @ Vt - eye)
                             / (torch.linalg.norm(blocks)
                                * torch.linalg.norm(Vt)))

            assert inv_bwd(invs) <= 4.0 * inv_bwd(Z)
        # K13's solves on K14's factor, within K13's gates
        K = torch.tensor(K_np, device=cuda)
        for k in (1, 130):
            B = torch.tensor(rng.normal(size=(N, k)), device=cuda)
            X = ch.chol_solve(L, dsc, B, invs)
            P = ch.chol_solve_plain(L, dsc, B)
            if well:
                assert _rel(X.cpu(), P.cpu()) <= 1e-12
            assert _solve_bwd(K, X, B) <= 4.0 * _solve_bwd(K, P, B)


@pytest.mark.gpu
def test_info_and_checks_on_the_card(cuda):
    from goldfish_tpu_torch.solver import cholesky as ch

    K, _ = _spd(700, 5)
    for j in (0, 300, 699):
        Kj = K.copy()
        Kj[j, j] = -Kj[j, j]
        K_eq = _equilibrated(Kj)[0].to(cuda)
        _, info_x = torch.linalg.cholesky_ex(K_eq)
        _, info, _ = ch.chol_factor(K_eq)
        assert int(info) == int(info_x) == j + 1
    K_eq = _equilibrated(K)[0].to(cuda)
    with pytest.raises(ValueError):
        ch.chol_factor(K_eq.t())              # not row-major contiguous
    with pytest.raises(TypeError):
        ch.chol_factor(K_eq.float())
