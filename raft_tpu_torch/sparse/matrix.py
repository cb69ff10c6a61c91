"""Sparse matrix ops of the port: CSR select_k, diagonal, tf-idf / BM25.

(Counterpart of ``raft_tpu/sparse/matrix.py``; ref: cpp/include/raft/
sparse/matrix/select_k.cuh + detail/select_k-inl.cuh, matrix/detail/
diagonal.cuh, matrix/preprocessing.cuh:28,63,101,167.)
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.kvp import total_order
from raft_tpu_torch.core.sparse_types import CSRMatrix, to_device
from raft_tpu_torch.sparse.linalg import (_as_coo_parts, _segment_sum,
                                          diagonal as _diagonal)


def select_k(res, csr: CSRMatrix, k: int, select_min: bool = True,
             fill_value=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per CSR row → dense (values [n_rows, k], indices [n_rows,
    k]); rows with fewer than k nonzeros are padded with ``fill_value``
    (±inf by default) and index −1, the reference's semantics.
    (ref: sparse/matrix/detail/select_k-inl.cuh)

    The reference's order: one stable sort of (row, value) pairs — its
    ``jnp.lexsort`` — ranks every nonzero within its row, value ascending
    (of the negated values when not ``select_min``), −0 equal to +0, every
    NaN last whatever its sign, equal values in storage order; the first k
    of each row are kept. Here the values become an integer key of that
    order (:func:`_lexsort_key`), sorted stably, then stably by row."""
    expects(k > 0, "select_k: k must be positive")
    csr = to_device(csr)
    rows, cols, vals, shape = _as_coo_parts(csr)
    n_rows = shape[0]
    dev = vals.device
    if fill_value is None:
        fill_value = float("inf") if select_min else float("-inf")
    r = rows.long()
    order = torch.sort(_lexsort_key(vals if select_min else -vals),
                       stable=True).indices
    order = order[torch.sort(r[order], stable=True).indices]
    s_rows = r[order]
    rank = torch.arange(order.shape[0], device=dev) - \
        csr.indptr.long()[s_rows]
    keep = rank < k
    out_v = torch.full((n_rows, k), fill_value, dtype=vals.dtype, device=dev)
    out_i = torch.full((n_rows, k), -1, dtype=torch.int32, device=dev)
    out_v[s_rows[keep], rank[keep]] = vals[order[keep]]
    out_i[s_rows[keep], rank[keep]] = cols[order[keep]].to(torch.int32)
    return out_v, out_i


def _lexsort_key(v):
    """An integer key whose ascending order is the reference's sort order
    of ``v``: −0 as +0 and every NaN as one NaN past +inf, then IEEE total
    order (:func:`total_order`). A stable sort of it ranks equal values in
    storage order on any device."""
    if not v.dtype.is_floating_point:
        return v
    return total_order(torch.where(torch.isnan(v), float("nan"), v + 0.0))


def diagonal(res, A) -> torch.Tensor:
    """The main diagonal (delegates to ``sparse.linalg.diagonal``).
    (ref: sparse/matrix/detail/diagonal.cuh)"""
    return _diagonal(res, A)


def set_diagonal(res, A, diag):
    """Overwrite existing diagonal entries with ``diag[row]``.
    (ref: matrix/detail/diagonal.cuh ``set_diagonal``)"""
    A = to_device(A)
    rows, cols, vals, _ = _as_coo_parts(A)
    diag = torch.as_tensor(diag).to(device=vals.device, dtype=vals.dtype)
    return A.with_values(torch.where(rows == cols, diag[rows.long()], vals))


def scale_by_diagonal_symmetric(res, A, diag):
    """A_ij ← A_ij · d_i · d_j (the D A D scaling of the normalized
    Laplacian). (ref: matrix/detail/diagonal.cuh scaling helpers)"""
    A = to_device(A)
    rows, cols, vals, _ = _as_coo_parts(A)
    diag = torch.as_tensor(diag).to(device=vals.device, dtype=vals.dtype)
    return A.with_values(vals * diag[rows.long()] * diag[cols.long()])


def _feature_doc_counts(cols, n_cols: int, dtype):
    """Occurrences per feature. (ref: detail/preprocessing.cuh
    ``fit_tfidf``)"""
    counts = torch.bincount(cols.long(), minlength=n_cols).to(dtype)
    return torch.where(counts > 0, counts, torch.ones_like(counts))


def encode_tfidf(res, A):
    """TF-IDF: tf = log(value), idf = log(n_rows / feature_count[col] + 1),
    out = tf·idf. (ref: sparse/matrix/preprocessing.cuh:28,63)"""
    A = to_device(A)
    rows, cols, vals, shape = _as_coo_parts(A)
    safe = _feature_doc_counts(cols, shape[1], vals.dtype)
    idf = torch.log(shape[0] / safe[cols.long()] + 1.0)
    return A.with_values(torch.log(vals) * idf)


def encode_bm25(res, A, k_param: float = 1.6, b_param: float = 0.75):
    """Okapi BM25: tf = log(value); idf as tf-idf's; bm = (k+1)·tf /
    (k·((1−b) + b·row_len[row]/avg_len) + tf); out = idf·bm, row_len the
    per-row sum of values and avg_len = total/n_rows.
    (ref: sparse/matrix/preprocessing.cuh:101,167)"""
    A = to_device(A)
    rows, cols, vals, shape = _as_coo_parts(A)
    safe = _feature_doc_counts(cols, shape[1], vals.dtype)
    row_len = _segment_sum(vals, rows, shape[0])
    avg_len = vals.sum() / shape[0]
    tf = torch.log(vals)
    idf = torch.log(shape[0] / safe[cols.long()] + 1.0)
    bm = ((k_param + 1.0) * tf) / (
        k_param * ((1.0 - b_param) + b_param * (row_len[rows.long()]
                                                / avg_len)) + tf)
    return A.with_values(idf * bm)
