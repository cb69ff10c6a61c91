"""SVD family of the port (counterpart of ``raft_tpu/linalg/svd.py``; ref:
cpp/include/raft/linalg/svd.cuh:195,332 ``svd_qr`` (gesvd), ``svd_eig``
(eigendecomposition of the Gram matrix), ``svd_jacobi`` (gesvdj),
``svd_qr_transpose_right_vec``, ``svd_reconstruction`` and
``evaluate_svd_by_percentage``).

Singular values descend. ``svd_qr`` and ``svd_eig`` fix no sign: a
singular pair is defined up to one sign, which cuSOLVER, LAPACK and XLA
each choose their own way.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device
from raft_tpu_torch.linalg.eig import eig_jacobi


def _dense(res, *arrays):
    return float_operands(input_device(res, *arrays), *arrays)


def thin_svd(A):
    """(U, S, Vᵀ) of A by the QR-based SVD: cuSOLVER gesvd on the card, as
    the reference's ``svd_qr`` names it. On an H100 torch's default, gesvdj,
    left 1.7e-4 of σ_max on config 3's 100,000 × 1,000 (gesvd 4.8e-7;
    ``port_scripts/first_svd_check.py``)."""
    return torch.linalg.svd(A, full_matrices=False,
                            driver="gesvd" if A.is_cuda else None)


def svd_qr(res, A, gen_left_vec: bool = True, gen_right_vec: bool = True):
    """Thin SVD: (U, S, V) with V as columns (not Vᵀ); a factor not asked
    for is None. (ref: svd.cuh:195)"""
    u, s, vt = svd_qr_transpose_right_vec(res, A)
    return (u if gen_left_vec else None), s, (vt.T if gen_right_vec
                                              else None)


def svd_qr_transpose_right_vec(res, A):
    """(U, S, Vᵀ). (ref: svd.cuh ``svd_qr_transpose_right_vec``)"""
    A, = _dense(res, A)
    return thin_svd(A)


def _from_gram(A, w, v, gen_left_vec: bool, zero_null: bool):
    """(U, S, V) from the Gram matrix's ascending eigenpairs: S = √max(w,
    0) descending, U = A V / S where S > 0 (0 there with ``zero_null``)."""
    w, v = w.flip(0), v.flip(1)
    s = torch.sqrt(w.clamp_min(0.0))
    U = None
    if gen_left_vec:
        pos = s > 0
        U = (A @ v) / torch.where(pos, s, torch.ones_like(s))[None, :]
        if zero_null:
            U = torch.where(pos[None, :], U, torch.zeros_like(U))
    return U, s, v


def svd_eig(res, A, gen_left_vec: bool = True):
    """SVD through the eigendecomposition of AᵀA, for n_rows ≥ n_cols.
    (ref: svd.cuh:332 ``svd_eig``)"""
    A, = _dense(res, A)
    n, p = A.shape
    expects(n >= p, "svd_eig: requires n_rows >= n_cols")
    w, v = torch.linalg.eigh(A.T @ A)
    return _from_gram(A, w, v, gen_left_vec, zero_null=True)


def svd_jacobi(res, A, tol: float = 1e-7, sweeps: int = 15,
               gen_left_vec: bool = True):
    """SVD through the Jacobi eigensolver on AᵀA. (ref: svd.cuh
    ``svdJacobi`` → gesvdj)"""
    A, = _dense(res, A)
    w, v = eig_jacobi(res, A.T @ A, tol=tol, sweeps=sweeps)
    return _from_gram(A, w, v, gen_left_vec, zero_null=False)


def svd_reconstruction(res, U, S, V):
    """U diag(S) Vᵀ. (ref: svd.cuh ``svd_reconstruction``)"""
    U, S, V = _dense(res, U, S, V)
    return (U * S[None, :]) @ V.T


def evaluate_svd_by_percentage(res, A, U, S, V,
                               percent: float = 1e-2) -> bool:
    """Whether ‖A − U diag(S) Vᵀ‖_F ≤ percent · ‖A‖_F. (ref: svd.cuh
    ``evaluate_svd_by_percentage``)"""
    A, = _dense(res, A)
    err = torch.linalg.norm(A - svd_reconstruction(res, U, S, V).to(A))
    return bool(err <= percent * torch.linalg.norm(A))
