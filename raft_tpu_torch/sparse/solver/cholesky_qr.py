"""Cholesky-QR orthonormalization of the port (counterpart of
``raft_tpu/sparse/solver/cholesky_qr.py``; ref: cpp/include/raft/sparse/
solver/detail/cholesky_qr.cuh ``cholesky_qr2``): Q = Y R⁻¹ with R from
chol(YᵀY), twice over; the randomized sparse SVD's orthonormalization."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.resources import float_operands, resolve_device


def cholesky_qr(Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pass: (Q, R). YᵀY gets the reference's jitter eps·trace(YᵀY) on
    its diagonal, so a nearly rank-deficient sketch still factors. Runs
    on Y's device (cuda for numpy input)."""
    Y, = float_operands(resolve_device(None, Y), Y)
    G = Y.T @ Y
    eps = torch.finfo(Y.dtype).eps * torch.trace(G)
    R = torch.linalg.cholesky(
        G + eps * torch.eye(G.shape[0], dtype=Y.dtype, device=Y.device)).T
    # Q = Y R⁻¹ (the reference solves Rᵀ Qᵀ = Yᵀ): one solve from the
    # right over Y's rows, where the reference's form hands cuBLAS a
    # million right-hand sides and took seconds on an H100
    Q = torch.linalg.solve_triangular(R, Y, upper=True, left=False)
    return Q, R


def cholesky_qr2(Y) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two passes (CholeskyQR2). (ref: detail/cholesky_qr.cuh)"""
    Q1, R1 = cholesky_qr(Y)
    Q, R2 = cholesky_qr(Q1)
    return Q, R2 @ R1
