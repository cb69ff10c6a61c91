"""Sparse element/row operations of the port.

(Counterpart of ``raft_tpu/sparse/op.py``; ref: cpp/include/raft/sparse/
op/ — detail/filter.cuh (remove zeros), op/reduce.cuh (duplicate
reduction), op/row_op.cuh, op/slice.cuh, op/sort.cuh.) The data-dependent
outputs (remove zeros, dedup) are computed on the input's device.
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix, to_device
from raft_tpu_torch.sparse.convert import lexsort_rows_cols


def coo_sort(coo: COOMatrix) -> COOMatrix:
    """Sort by (row, col), stable. (ref: op/sort.cuh ``coo_sort``)"""
    coo = to_device(coo)
    order = lexsort_rows_cols(coo.rows, coo.cols, coo.shape[1])
    return COOMatrix(coo.rows[order], coo.cols[order], coo.values[order],
                     coo.shape)


def coo_remove_zeros(coo: COOMatrix, eps: float = 0.0) -> COOMatrix:
    """Drop entries with |value| <= eps.
    (ref: op/detail/filter.cuh ``coo_remove_zeros``)"""
    coo = to_device(coo)
    keep = coo.values.abs() > eps
    return COOMatrix(coo.rows[keep], coo.cols[keep], coo.values[keep],
                     coo.shape)


def max_duplicates(coo: COOMatrix) -> COOMatrix:
    """Reduce duplicate (row, col) entries keeping the max.
    (ref: op/reduce.cuh ``max_duplicates``)"""
    return _reduce_duplicates(coo, "amax")


def sum_duplicates(coo: COOMatrix) -> COOMatrix:
    """(ref: op/reduce.cuh duplicate sum / ``compute_duplicates_mask``)"""
    return _reduce_duplicates(coo, "sum")


def _reduce_duplicates(coo: COOMatrix, how: str) -> COOMatrix:
    """One entry per distinct (row, col), sorted by (row, col)."""
    coo = to_device(coo)
    n_cols = max(coo.shape[1], 1)
    keys = coo.rows.long() * n_cols + coo.cols.long()
    uniq, inverse = torch.unique(keys, sorted=True, return_inverse=True)
    out = torch.zeros(uniq.shape[0], dtype=coo.values.dtype,
                      device=keys.device)
    if how == "sum":
        out.index_add_(0, inverse, coo.values)
    else:
        out.scatter_reduce_(0, inverse, coo.values, "amax",
                            include_self=False)
    return COOMatrix((uniq // n_cols).to(torch.int32),
                     (uniq % n_cols).to(torch.int32), out, coo.shape)


def csr_row_op(csr: CSRMatrix, op: Callable) -> CSRMatrix:
    """Apply ``op(row_id, value) -> value`` to every nonzero.
    (ref: op/row_op.cuh ``csr_row_op``)"""
    csr = to_device(csr)
    return csr.with_values(op(csr.row_ids(), csr.values))


def csr_row_slice(csr: CSRMatrix, start_row: int,
                  stop_row: int) -> CSRMatrix:
    """Rows [start_row, stop_row). (ref: op/slice.cuh
    ``csr_row_slice_indptr`` / ``csr_row_slice_populate``)"""
    csr = to_device(csr)
    expects(0 <= start_row < stop_row <= csr.shape[0],
            "csr_row_slice: bad range")
    lo = int(csr.indptr[start_row])
    hi = int(csr.indptr[stop_row])
    return CSRMatrix(csr.indptr[start_row:stop_row + 1] - lo,
                     csr.indices[lo:hi], csr.values[lo:hi],
                     (stop_row - start_row, csr.shape[1]))
