"""K14: the Cholesky factor, and K13: its substitution.

K14 (`chol_factor`) ports goldfish_tpu/solver/tpu_cholesky.py:139
`blocked_cholesky_unrolled` and :171 `blocked_cholesky` (the facade's
factor, :302-:314): the equilibrated tangent K_eq = L L^T, factored in place
by csrc/chol_factor.cu (counter `chol_factor`, one a factorization), with
the inverses of L's diagonal blocks as K13 reads them. On CPU tensors its
plain version: `torch.linalg.cholesky_ex` and `diag_inverses_plain`.

K13 ports goldfish_tpu/solver/tpu_cholesky.py:205 `_chol_substitute` (one
right-hand side) and :235 `_chol_substitute_multi` (M right-hand sides),
with the inverses of the diagonal panels they use (`invs`,
tpu_cholesky.py:177-200). For the equilibrated factor K_eq = L L^T of a
tangent K = D^-1 K_eq D^-1 (D = diag(dsc)),

    chol_solve(L, dsc, B, invs) = dsc * (L L^T)^-1 (dsc * B) = K^-1 B,

the two scalings folded into the kernel's sweeps. L is the factor
`chol_factor` (or `torch.linalg.cholesky_ex`) returns (column-major, strides
(1, N)), read in place and only below the diagonal; `chol_factor` returns
`invs` with it, and `diag_inverses(L)` computes them for any such L. On CUDA
tensors both launch csrc/chol_subst.cu (counters
`chol_subst/vec` for one column, `chol_subst/multi` for more,
`chol_subst/diag_inv`); on CPU tensors they run their plain versions:
`dsc * torch.cholesky_solve(dsc * B, L)` and batched triangular inverses.
"""

from __future__ import annotations

import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE

__all__ = ["NB", "CT", "PW", "chol_factor", "chol_solve", "diag_inverses",
           "chol_factor_plain", "chol_solve_plain", "diag_inverses_plain"]

NB = 64    # rows of a diagonal block (csrc/chol_blocks.cuh: NB)
CT = 128   # columns of a multi-RHS work item (csrc/chol_blocks.cuh: CT)
PW = 256   # columns of a factor panel (csrc/chol_factor.cu: PW)


def _n_blocks(N):
    return (N + NB - 1) // NB


def diag_inverses_plain(L):
    """(nblk, NB, NB): block k holds the inverse of L's k-th diagonal block
    (the last padded with the identity), transposed, i.e. the inverse
    column-major as the kernel stores it."""
    N = L.shape[0]
    nb = _n_blocks(N)
    blocks = torch.zeros(nb, NB, NB, dtype=L.dtype, device=L.device)
    for k in range(nb):
        a, e = k * NB, min(N, (k + 1) * NB)
        blocks[k, :e - a, :e - a] = L[a:e, a:e]
    blocks = blocks.tril()
    pad = torch.arange(N - (nb - 1) * NB, NB, device=L.device)
    blocks[-1, pad, pad] = 1.0
    eye = torch.eye(NB, dtype=L.dtype, device=L.device).expand(nb, NB, NB)
    inv = torch.linalg.solve_triangular(blocks, eye, upper=False)
    return inv.transpose(1, 2).contiguous()


def chol_solve_plain(L, dsc, B):
    """dsc * (L L^T)^-1 (dsc * B) for B (N, k) by `torch.cholesky_solve`."""
    d = dsc[:, None]
    return d * torch.cholesky_solve(d * B, L)


def chol_factor_plain(K):
    """(L, info, invs): `torch.linalg.cholesky_ex(K)` and the inverses of
    L's diagonal blocks (`diag_inverses_plain`); K is left as it was."""
    L, info = torch.linalg.cholesky_ex(K)
    return L, info, diag_inverses_plain(L)


def chol_factor(K):
    """K14: the Cholesky factor of the SPD matrix K (N, N), f64, row-major
    contiguous: (L, info, invs) with K = L L^T, `info` a 0-dim int32 tensor
    as `torch.linalg.cholesky_ex` gives it (0, or the order of the first
    leading minor that is not positive definite: the factor is then not
    usable) and `invs` the inverses of L's diagonal blocks as
    `diag_inverses(L)` lays them out (nblk, NB, NB).

    On a CUDA tensor the kernel factors K IN PLACE: K is consumed (no copy
    of its N^2 entries is made) and L is the view `K.t()`, column-major
    (strides (1, N)), its strict upper triangle zero, as `chol_solve` reads
    it. Only K's lower triangle is read. On a CPU tensor the plain version
    (K untouched)."""
    if not isinstance(K, torch.Tensor):
        raise TypeError(f"K: expected a tensor, got {type(K).__name__}")
    if K.dim() != 2 or K.shape[0] != K.shape[1] or K.shape[0] < 1:
        raise ValueError(f"K: a square matrix, got shape {tuple(K.shape)}")
    if K.dtype != DTYPE:
        raise TypeError(f"K: dtype {K.dtype}, expected {DTYPE}")
    if not K.is_contiguous():
        raise ValueError("K: must be row-major contiguous (the kernel "
                         "factors it in place)")
    if not _cuda.on_cuda(K):
        return chol_factor_plain(K)
    N, dev = K.shape[0], K.device
    nb = _n_blocks(N)
    invs = torch.empty(nb, NB, NB, dtype=DTYPE, device=dev)
    info = torch.empty((), dtype=torch.int32, device=dev)
    W = torch.empty(_cuda.library().gf_chol_factor_scratch(N), dtype=DTYPE,
                    device=dev)
    nflags = (N + PW - 1) // PW * (PW // NB + 1)
    flags = torch.empty(nflags, dtype=torch.int32, device=dev)
    p = _cuda.ptr
    _cuda.launch("chol_factor", "gf_chol_factor", p(K), p(invs), p(info),
                 p(W), W.numel(), p(flags), nflags, N, nb)
    return K.t(), info, invs


def _check_factor(L):
    """N of the factor L, or raise: an (N, N) f64 matrix laid out as
    `torch.linalg.cholesky_ex` returns it, column-major (strides (1, N)),
    which the kernels read in place."""
    if not isinstance(L, torch.Tensor):
        raise TypeError(f"L: expected a tensor, got {type(L).__name__}")
    if L.dim() != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"L: a square matrix, got shape {tuple(L.shape)}")
    if L.dtype != DTYPE:
        raise TypeError(f"L: dtype {L.dtype}, expected {DTYPE}")
    N = L.shape[0]
    if N > 1 and L.stride() != (1, N):
        raise ValueError(f"L: strides {L.stride()}, expected (1, {N}) "
                         f"(column-major, as torch.linalg.cholesky_ex "
                         f"returns it)")
    return N


def diag_inverses(L):
    """K13's factor-time part: the inverses of L's NB x NB diagonal blocks,
    (nblk, NB, NB), block k the inverse column-major (`diag_inverses_plain`
    on the CPU)."""
    N = _check_factor(L)
    if not _cuda.on_cuda(L):
        return diag_inverses_plain(L)
    nb = _n_blocks(N)
    invs = torch.empty(nb, NB, NB, dtype=DTYPE, device=L.device)
    _cuda.launch("chol_subst/diag_inv", "gf_chol_diag_inv", _cuda.ptr(L),
                 _cuda.ptr(invs), N, nb)
    return invs


def chol_solve(L, dsc, B, invs=None):
    """K^-1 B = dsc * (L L^T)^-1 (dsc * B) for B (N, k): K13 on CUDA
    tensors (`invs` from `chol_factor` or `diag_inverses(L)` required
    there), the plain version on CPU tensors."""
    N = _check_factor(L)
    dev = L.device
    if not isinstance(B, torch.Tensor) or B.dim() != 2:
        raise ValueError(f"B: an (N, k) matrix, got "
                         f"{getattr(B, 'shape', type(B).__name__)}")
    k = B.shape[1]
    _cuda.check(dsc, "dsc", DTYPE, (N,), dev)
    _cuda.check(B, "B", DTYPE, (N, k), dev)
    if not _cuda.on_cuda(L):
        return chol_solve_plain(L, dsc, B)
    nb = _n_blocks(N)
    if invs is None:
        raise ValueError("invs: required on CUDA (chol_factor's, or "
                         "diag_inverses(L))")
    _cuda.check(invs, "invs", DTYPE, (nb, NB, NB), dev)
    out = torch.empty(N, k, dtype=DTYPE, device=dev)
    if k == 0:
        return out
    p = _cuda.ptr
    if k == 1:
        yz = torch.empty(2 * N + 1, dtype=DTYPE, device=dev)   # y, z, ticket
        _cuda.launch("chol_subst/vec", "gf_chol_subst", p(L), p(invs),
                     p(dsc), p(B), p(yz), p(out), N, nb)
        return out
    nct = (k + CT - 1) // CT
    MP = nct * CT
    YZ = torch.empty(2, N, MP, dtype=DTYPE, device=dev)
    flags = torch.empty(2 * nb * nct + 1, dtype=torch.int32, device=dev)
    _cuda.launch("chol_subst/multi", "gf_chol_subst_multi", p(L), p(invs),
                 p(dsc), p(B), p(YZ[0]), p(YZ[1]), p(out), p(flags), N, k,
                 MP, nb, nct)
    return out
