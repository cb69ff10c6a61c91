"""Keyed reductions over rows and columns of the port (counterpart of
``raft_tpu/linalg/reduce_by_key.py``; ref: cpp/include/raft/linalg/
reduce_rows_by_key.cuh, reduce_cols_by_key.cuh).

The reference's ``segment_sum`` becomes ``index_add_``. On a card that
adds with atomics in no fixed order, so a sum may differ from run to run
(and from the CPU's) by the rounding of its reordered terms:
|Δ| ≤ (n_k − 1)·2⁻²⁴·Σ|terms| for a key with n_k rows (the tolerance
the tests and the card check state), as with RAFT's own atomic kernel.
"""

from __future__ import annotations

from raft_tpu_torch.core.resources import as_tensors


def reduce_rows_by_key(res, matrix, keys, n_unique_keys: int, weights=None):
    """out[k, :] = Σ over rows r with keys[r] == k of w[r]·matrix[r, :].
    (ref: reduce_rows_by_key.cuh)"""
    matrix, keys, weights = as_tensors(res, matrix, keys, weights)
    if weights is not None:
        matrix = matrix * weights[:, None]
    out = matrix.new_zeros((n_unique_keys, matrix.shape[1]))
    return out.index_add_(0, keys.long(), matrix)


def reduce_cols_by_key(res, matrix, keys, n_unique_keys: int):
    """out[:, k] = Σ over columns c with keys[c] == k of matrix[:, c].
    (ref: reduce_cols_by_key.cuh)"""
    matrix, keys = as_tensors(res, matrix, keys)
    out = matrix.new_zeros((matrix.shape[0], n_unique_keys))
    return out.index_add_(1, keys.long(), matrix)
