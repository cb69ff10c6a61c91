"""Cholesky rank-1 expansion of the port (counterpart of
``raft_tpu/linalg/cholesky.py``; ref: cpp/include/raft/linalg/
cholesky_r1_update.cuh): given the factor L of A's leading (k−1)×(k−1)
block and A's k-th column, the k×k factor without refactorizing."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device


def cholesky_r1_update(res, L_prev, a_col, eps: float = 0.0):
    """Expand a lower factor by one row and column.

    ``L_prev`` [k−1, k−1] is the factor of A[:k−1, :k−1] (ignored at
    k = 1), ``a_col`` [k] the new column A[:k, k−1], its last entry the
    diagonal. Returns L [k, k]; the new diagonal is clamped at ``eps``
    before its root. (ref: cholesky_r1_update.cuh)"""
    dev = input_device(res, a_col, L_prev)
    a_col, = float_operands(dev, a_col)
    k = a_col.shape[0]
    if k == 1:
        return torch.sqrt(a_col.clamp_min(eps)).reshape(1, 1)
    L_prev, = float_operands(dev, L_prev)
    L_prev = L_prev.to(a_col.dtype)
    expects(tuple(L_prev.shape) == (k - 1, k - 1),
            "cholesky_r1_update: shape mismatch")
    l_row = torch.linalg.solve_triangular(
        L_prev, a_col[:k - 1, None], upper=False)[:, 0]
    d2 = a_col[k - 1] - torch.dot(l_row, l_row)
    L = L_prev.new_zeros((k, k))
    L[:k - 1, :k - 1] = L_prev
    L[k - 1, :k - 1] = l_row
    L[k - 1, k - 1] = torch.sqrt(d2.clamp_min(eps if eps > 0 else 0.0))
    return L
