"""Sparse format conversions of the port.

(Counterpart of ``raft_tpu/sparse/convert.py``; ref: cpp/include/raft/
sparse/convert/csr.cuh:202 (coo↔csr), convert/coo.cuh, convert/dense.cuh,
convert/detail/adj_to_csr.cuh, bitmap_to_csr.cuh, bitset_to_csr.cuh.)
torch runs eagerly, so the conversions that discover nnz (dense, bitmap,
bitset → sparse) stay on the input's device instead of a host pass.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.bitset import BitmapView, BitsetView
from raft_tpu_torch.core.resources import resolve_device
from raft_tpu_torch.core.sparse_types import (COOMatrix, CSRMatrix, _tensor,
                                              to_device)


def _indptr(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    counts = torch.bincount(rows.long(), minlength=n_rows)
    indptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=rows.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return indptr


def sorted_coo_to_csr(coo: COOMatrix) -> CSRMatrix:
    """COO (sorted by row) → CSR. (ref: convert/csr.cuh
    ``sorted_coo_to_csr``)"""
    coo = to_device(coo)
    return CSRMatrix(_indptr(coo.rows, coo.shape[0]), coo.cols, coo.values,
                     coo.shape)


def lexsort_rows_cols(rows: torch.Tensor, cols: torch.Tensor,
                      n_cols: int) -> torch.Tensor:
    """Stable order by (row, col): ``jnp.lexsort((cols, rows))``."""
    key = rows.long() * max(int(n_cols), 1) + cols.long()
    return torch.sort(key, stable=True).indices


def coo_to_csr(coo: COOMatrix) -> CSRMatrix:
    """General COO → CSR (sorts by (row, col) first).
    (ref: convert/csr.cuh ``coo_to_csr``)"""
    coo = to_device(coo)
    order = lexsort_rows_cols(coo.rows, coo.cols, coo.shape[1])
    return sorted_coo_to_csr(COOMatrix(coo.rows[order], coo.cols[order],
                                       coo.values[order], coo.shape))


def csr_to_coo(csr: CSRMatrix) -> COOMatrix:
    """(ref: convert/coo.cuh ``csr_to_coo`` — indptr expansion)"""
    csr = to_device(csr)
    return COOMatrix(csr.row_ids(), csr.indices, csr.values, csr.shape)


def dense_to_csr(dense, device=None) -> CSRMatrix:
    """(ref: convert/dense.cuh)"""
    return CSRMatrix.from_dense(dense, device=device)


def dense_to_coo(dense, device=None) -> COOMatrix:
    return COOMatrix.from_dense(dense, device=device)


def csr_to_dense(csr: CSRMatrix) -> torch.Tensor:
    """(ref: convert/dense.cuh ``csr_to_dense``)"""
    return to_device(csr).to_dense()


def coo_to_dense(coo: COOMatrix) -> torch.Tensor:
    return to_device(coo).to_dense()


def adj_to_csr(adj, device=None) -> CSRMatrix:
    """Boolean adjacency matrix → CSR of ones.
    (ref: convert/detail/adj_to_csr.cuh)"""
    dev = resolve_device(device, adj)
    adj = _tensor(adj, dev).bool()
    r, c = torch.nonzero(adj, as_tuple=True)
    return CSRMatrix(_indptr(r, adj.shape[0]), c.to(torch.int32),
                     torch.ones(c.shape[0], dtype=torch.float32, device=dev),
                     tuple(adj.shape))


def bitmap_to_csr(bitmap: BitmapView) -> CSRMatrix:
    """2-D bitmap → CSR of ones. (ref: convert/detail/bitmap_to_csr.cuh)"""
    return adj_to_csr(bitmap.to_dense())


def bitset_to_csr(bitset: BitsetView, n_repeat: int = 1) -> CSRMatrix:
    """Bitset → CSR with the bitset as each of ``n_repeat`` identical rows.
    (ref: convert/detail/bitset_to_csr.cuh)"""
    bits = bitset.to_dense()
    dev = bits.device
    (cols,) = torch.nonzero(bits, as_tuple=True)
    nnz_row = cols.shape[0]
    indptr = (torch.arange(n_repeat + 1, dtype=torch.int32, device=dev)
              * nnz_row)
    return CSRMatrix(indptr, cols.to(torch.int32).repeat(n_repeat),
                     torch.ones(nnz_row * n_repeat, dtype=torch.float32,
                                device=dev),
                     (n_repeat, bitset.n_bits))
