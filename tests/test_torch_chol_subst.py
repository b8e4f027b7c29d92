"""K13 chol_subst: the substitution of the persistent Cholesky factor
(goldfish_tpu_torch/csrc/chol_subst.cu, goldfish_tpu_torch/solver/
cholesky.py) against the JAX package's blocked substitution
(goldfish_tpu/solver/tpu_cholesky.py:205 `_chol_substitute`, :235
`_chol_substitute_multi`).

Inputs: a numpy-seeded SPD K (N = 300, not a multiple of the 64-row blocks,
so both packages pad their last block) with eigenvalues spread over
`COND` = 1e8 and rows and columns scaled by e^N(0, 1), which the Jacobi
equilibration takes out again; b and an (N, M = 40) one-hot U^T as the
Woodbury basis takes it.

- (a) the port's `chol_solve` (on the CPU its plain version,
  `dsc * cholesky_solve(dsc * b, L)`) against
  `DeviceCholesky(nb=64).factor(K).solve(b)`: the two factor K with their
  own algorithms (the JAX package blocked, with Newton-Schulz-polished
  panel inverses), so x agrees to a multiple of cond(K_eq) eps:
  `_tol` = 64 cond(K_eq) 2.2e-16 relative in norm; the port's
  `diag_inverses` against the JAX panel inverses (the same bar) and as
  inverses of the port's own diagonal blocks (1e-12);
- (b) the Woodbury basis W = K^-1 U^T: `chol_solve` with M columns against
  `goldfish_tpu/solver/system_mi.py:_wb_basis` (`_chol_substitute_multi`
  on the JAX factor), the same bar;
- (c) the wrappers' argument checks raise (dtype, shape, the factor's
  column-major strides);
- (d) `torch.cholesky_solve` occurs in the port only inside the plain
  version;
- (e) on the card (`gpu`, skipped here): the kernels against their plain
  versions at a well-conditioned K (1e-12 relative) and at the seeded K
  above (the backward error of the equilibrated system <= 4x the plain
  version's), one column and M columns (also past one 128-column tile),
  the same bits over 3 launches, one count a launch. Run it there with
  `python -m pytest tests/test_torch_chol_subst.py -m gpu --noconftest -q`.
"""

import ast
import os

import numpy as np
import pytest
import torch

N_SMALL = 300
M_SMALL = 40
COND = 1e8


def _spd(N, seed, cond=COND):
    """A seeded SPD matrix: eigenvalues log-spaced over `cond`, random
    eigenvectors, rows and columns scaled by e^N(0, 1)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    K = (Q * np.logspace(0.0, -np.log10(cond), N)) @ Q.T
    s = np.exp(rng.normal(size=N))
    K = s[:, None] * (0.5 * (K + K.T)) * s[None, :]
    return K, rng


def _port_factor(K):
    """(L, dsc) as solver/devicechol.py makes them."""
    Kt = torch.tensor(K, dtype=torch.float64)
    dsc = torch.rsqrt(Kt.diagonal().abs() + 1e-300)
    Kt.mul_(dsc[:, None]).mul_(dsc[None, :])
    L, info = torch.linalg.cholesky_ex(Kt)
    assert int(info) == 0
    return L, dsc, Kt


def _tol(K_eq):
    return 64.0 * float(np.linalg.cond(K_eq.numpy())) * 2.2e-16


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def problem():
    import jax.numpy as jnp

    from goldfish_tpu.solver.tpu_cholesky import DeviceCholesky

    K, rng = _spd(N_SMALL, 22)
    b = rng.normal(size=N_SMALL)
    urows = np.sort(rng.choice(N_SMALL, size=M_SMALL, replace=False))
    dc = DeviceCholesky(nb=64).factor(jnp.asarray(K))
    return dict(K=K, b=b, urows=urows, dc=dc,
                x_jax=np.asarray(dc.solve(jnp.asarray(b))))


def test_solve_matches_the_jax_blocked_substitution(problem):
    from goldfish_tpu_torch.solver import cholesky

    L, dsc, K_eq = _port_factor(problem["K"])
    tol = _tol(K_eq)
    assert tol < 1e-5
    b = torch.tensor(problem["b"])
    x = cholesky.chol_solve(L, dsc, b.reshape(-1, 1),
                            cholesky.diag_inverses(L))[:, 0]
    assert _rel(x, problem["x_jax"]) <= tol
    # the port's own residual: the solve is exact to rounding
    r = torch.tensor(problem["K"]) @ x - b
    assert float(torch.linalg.norm(r) / torch.linalg.norm(b)) <= tol
    # the diagonal blocks' inverses: of the port's blocks, and the JAX
    # package's panel inverses (of its own factor)
    invs = cholesky.diag_inverses(L)
    nb = invs.shape[0]
    assert tuple(invs.shape) == (nb, cholesky.NB, cholesky.NB)
    assert nb == -(-N_SMALL // cholesky.NB)
    for k in range(nb):
        a, e = k * cholesky.NB, min(N_SMALL, (k + 1) * cholesky.NB)
        Z = invs[k].T[:e - a, :e - a]
        eye = torch.eye(e - a, dtype=torch.float64)
        assert float((L[a:e, a:e] @ Z - eye).abs().max()) <= 1e-12
    inv_jax = np.asarray(problem["dc"]._invs)
    assert _rel(invs.transpose(1, 2).numpy(), inv_jax) <= tol


def test_woodbury_basis_matches_the_jax_multi_substitution(problem):
    import jax.numpy as jnp

    from goldfish_tpu.solver.system_mi import _wb_basis
    from goldfish_tpu_torch.solver import cholesky

    dc = problem["dc"]
    urows = problem["urows"]
    Uoh = np.zeros((M_SMALL, N_SMALL))
    Uoh[np.arange(M_SMALL), urows] = 1.0
    W_jax, G_jax = _wb_basis(dc._L, dc._invs, dc._dscale, jnp.asarray(Uoh),
                             nb=dc.nb)
    L, dsc, K_eq = _port_factor(problem["K"])
    W = cholesky.chol_solve(L, dsc, torch.tensor(Uoh.T).contiguous(),
                            cholesky.diag_inverses(L))
    tol = _tol(K_eq)
    assert tuple(W.shape) == (N_SMALL, M_SMALL)
    assert _rel(W, np.asarray(W_jax)) <= tol
    assert _rel(W[urows], np.asarray(G_jax)) <= tol


def _bad_calls():
    L, dsc, _ = _port_factor(_spd(70, 3)[0])
    B = torch.ones(70, 1, dtype=torch.float64)
    from goldfish_tpu_torch.solver import cholesky as ch

    return {
        "L float32": (lambda: ch.chol_solve(L.float(), dsc, B), TypeError),
        "L not square": (lambda: ch.chol_solve(L[:, :69], dsc, B),
                         ValueError),
        "L row-major": (lambda: ch.chol_solve(L.contiguous(), dsc, B),
                        ValueError),
        "L row-major (inverses)": (lambda: ch.diag_inverses(L.contiguous()),
                                   ValueError),
        "B one-dimensional": (lambda: ch.chol_solve(L, dsc, B[:, 0]),
                              ValueError),
        "B rows": (lambda: ch.chol_solve(L, dsc, B[:69]), ValueError),
        "B float32": (lambda: ch.chol_solve(L, dsc, B.float()), TypeError),
        "dsc shape": (lambda: ch.chol_solve(L, dsc[:69], B), ValueError),
    }


@pytest.mark.parametrize("case", ["L float32", "L not square",
                                  "L row-major", "L row-major (inverses)",
                                  "B one-dimensional", "B rows",
                                  "B float32", "dsc shape"])
def test_argument_checks_raise(case):
    call, exc = _bad_calls()[case]
    with pytest.raises(exc):
        call()


def test_cholesky_solve_only_in_the_plain_version():
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
                and n.attr == "cholesky_solve"  # noqa: E731
            uses += sum(hit(n) for n in ast.walk(tree))
            where |= {(os.path.relpath(path, root), fn.name)
                      for fn in ast.walk(tree)
                      if isinstance(fn, ast.FunctionDef)
                      and any(hit(n) for n in ast.walk(fn))}
    assert uses == 1
    assert where == {(os.path.join("solver", "cholesky.py"),
                      "chol_solve_plain")}, where


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bwd(K, X, B):
    return float(torch.linalg.norm(K @ X - B)
                 / (torch.linalg.norm(K) * torch.linalg.norm(X)))


@pytest.mark.gpu
@pytest.mark.parametrize("N,M", [(65, 130), (700, 257)])
def test_kernels_match_plain_and_are_bitwise_on_the_card(cuda, N, M):
    from goldfish_tpu_torch import _cuda
    from goldfish_tpu_torch.solver import cholesky as ch

    rng = np.random.default_rng(N)
    A = rng.normal(size=(N, N)) / np.sqrt(N)
    for K_np, well in ((A @ A.T + np.eye(N), True), (_spd(N, N)[0], False)):
        L, dsc, K_eq = (t.to(cuda) for t in _port_factor(K_np))
        n0 = dict(_cuda.launch_counts)
        invs = ch.diag_inverses(L)
        assert _cuda.launch_counts["chol_subst/diag_inv"] == \
            n0["chol_subst/diag_inv"] + 1
        plain = ch.diag_inverses_plain(L)
        assert _rel(invs.cpu(), plain.cpu()) <= (1e-12 if well else 1e-6)
        K = torch.tensor(K_np, device=cuda)
        for k, counter in ((1, "chol_subst/vec"), (M, "chol_subst/multi")):
            B = torch.tensor(rng.normal(size=(N, k)), device=cuda)
            n0 = dict(_cuda.launch_counts)
            X = [ch.chol_solve(L, dsc, B, invs) for _ in range(3)]
            torch.cuda.synchronize()
            assert _cuda.launch_counts[counter] == n0[counter] + 3
            assert all(torch.equal(X[0], x) for x in X[1:])
            P = ch.chol_solve_plain(L, dsc, B)
            if well:
                assert _rel(X[0].cpu(), P.cpu()) <= 1e-12
            assert _bwd(K, X[0], B) <= 4.0 * _bwd(K, P, B)
    with pytest.raises(ValueError):
        ch.chol_solve(L, dsc, B)          # no inverses on the card
    with pytest.raises(ValueError):
        ch.chol_solve(L.contiguous(), dsc, B, invs)
