"""K13: the substitution of the persistent Cholesky factor.

Port of goldfish_tpu/solver/tpu_cholesky.py:205 `_chol_substitute` (one
right-hand side) and :235 `_chol_substitute_multi` (M right-hand sides),
with the inverses of the diagonal panels they use (`invs`,
tpu_cholesky.py:177-200). For the equilibrated factor K_eq = L L^T of a
tangent K = D^-1 K_eq D^-1 (D = diag(dsc)),

    chol_solve(L, dsc, B, invs) = dsc * (L L^T)^-1 (dsc * B) = K^-1 B,

the two scalings folded into the kernel's sweeps. L is the factor
`torch.linalg.cholesky_ex` returns (column-major, strides (1, N)), read in
place and only below the diagonal; `diag_inverses(L)` computes `invs` once a
factorization. On CUDA tensors both launch csrc/chol_subst.cu (counters
`chol_subst/vec` for one column, `chol_subst/multi` for more,
`chol_subst/diag_inv`); on CPU tensors they run their plain versions:
`dsc * torch.cholesky_solve(dsc * B, L)` and batched triangular inverses.
"""

from __future__ import annotations

import torch

from goldfish_tpu_torch import _cuda
from goldfish_tpu_torch.config import DTYPE

__all__ = ["NB", "CT", "chol_solve", "diag_inverses", "chol_solve_plain",
           "diag_inverses_plain"]

NB = 64    # rows of a diagonal block (csrc/chol_subst.cu: NB)
CT = 128   # columns of a multi-RHS work item (csrc/chol_subst.cu: CT)


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
    tensors (`invs` from `diag_inverses(L)` required there), the plain
    version on CPU tensors."""
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
        raise ValueError("invs: required on CUDA (diag_inverses(L))")
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
