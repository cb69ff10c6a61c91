"""Least squares of the port (counterpart of ``raft_tpu/linalg/lstsq.py``;
ref: cpp/include/raft/linalg/lstsq.cuh ``lstsq_svd_qr``,
``lstsq_svd_jacobi``, ``lstsq_eig``, ``lstsq_qr``). Each solves
min_w ‖A w − b‖₂ for A [m, n], m ≥ n, and returns w [n]."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device
from raft_tpu_torch.linalg.svd import svd_jacobi, thin_svd


def _dense(res, A, b):
    return float_operands(input_device(res, A, b), A, b)


def _inverse_above(s, cutoff):
    """1/s where |s| > cutoff, else 0."""
    big = s.abs() > cutoff
    return torch.where(big, 1.0 / torch.where(big, s, torch.ones_like(s)),
                       torch.zeros_like(s))


def _pinv_solve(u, s, v, b, rcond=1e-7):
    """V diag(1/S) Uᵀ b over the singular values above rcond · max S."""
    return v @ (_inverse_above(s, rcond * s.max()) * (u.T @ b))


def lstsq_svd_qr(res, A, b):
    """(ref: lstsq.cuh ``lstsq_svd_qr``)"""
    A, b = _dense(res, A, b)
    u, s, vt = thin_svd(A)
    return _pinv_solve(u, s, vt.T, b)


def lstsq_svd_jacobi(res, A, b, tol: float = 1e-7, sweeps: int = 15):
    """(ref: lstsq.cuh ``lstsq_svd_jacobi``)"""
    A, b = _dense(res, A, b)
    U, S, V = svd_jacobi(res, A, tol=tol, sweeps=sweeps)
    return _pinv_solve(U, S, V, b)


def lstsq_eig(res, A, b):
    """The normal equations through an eigendecomposition:
    w = (AᵀA)⁺ Aᵀ b. (ref: lstsq.cuh ``lstsq_eig``)"""
    A, b = _dense(res, A, b)
    w_eig, v = torch.linalg.eigh(A.T @ A)
    inv_w = _inverse_above(w_eig, 1e-7 * w_eig.abs().max())
    return v @ (inv_w * (v.T @ (A.T @ b)))


def lstsq_qr(res, A, b):
    """QR, then back substitution. (ref: lstsq.cuh ``lstsq_qr``)"""
    A, b = _dense(res, A, b)
    expects(A.shape[0] >= A.shape[1], "lstsq_qr: need m >= n")
    q, r = torch.linalg.qr(A, mode="reduced")
    rhs = q.T @ b
    w = torch.linalg.solve_triangular(
        r, rhs[:, None] if rhs.ndim == 1 else rhs, upper=True)
    return w[:, 0] if rhs.ndim == 1 else w
