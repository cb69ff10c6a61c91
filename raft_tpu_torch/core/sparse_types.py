"""Sparse matrix vocabulary types of the port: COO and CSR with the
structure held apart from the values.

(Counterpart of ``raft_tpu/core/sparse_types.py``; ref: cpp/include/raft/
core/sparse_types.hpp, core/coo_matrix.hpp, core/csr_matrix.hpp.) ``nnz``
and ``shape`` are Python ints; the arrays are torch tensors on one device.

The constructors keep what they are given, so a matrix may also hold numpy
arrays, as the reference's may; every entry point that computes on it
moves it first with :func:`to_device`, onto the device of its tensors, the
one the caller names, or ``cuda`` (see ``core/resources.py``). Each class
has ``from_numpy(...)``, which builds the port's object from the
reference's arrays (``np.asarray`` of its fields), so both packages
compute on the same matrix.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device


def _tensor(a, device: torch.device, dtype=None) -> torch.Tensor:
    """``a`` as a tensor on ``device`` (``dtype`` kept when None)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    a = np.asarray(a)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.ascontiguousarray(a).copy()
    t = torch.from_numpy(a).to(device)
    return t if dtype is None else t.to(dtype)


def _index(a, device: torch.device) -> torch.Tensor:
    """Index arrays are int32 in both packages."""
    return _tensor(a, device, torch.int32)


def _values(a, device: torch.device) -> torch.Tensor:
    """Values keep f32/f64; anything else becomes f32."""
    t = _tensor(a, device)
    if t.dtype not in (torch.float32, torch.float64):
        t = t.to(torch.float32)
    return t


def _device_of(*arrays) -> Optional[torch.device]:
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return None


class COOStructure:
    """(ref: core/coo_matrix.hpp ``coordinate_structure_t``)"""

    def __init__(self, rows, cols, shape: Tuple[int, int]):
        self.rows = rows
        self.cols = cols
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @classmethod
    def from_numpy(cls, rows, cols, shape, device=None) -> "COOStructure":
        dev = resolve_device(device)
        return cls(_index(rows, dev), _index(cols, dev), shape)


class COOMatrix:
    """Owning COO matrix = structure + values.
    (ref: core/coo_matrix.hpp, sparse/coo.hpp ``raft::sparse::COO``)"""

    def __init__(self, rows, cols, values, shape: Tuple[int, int]):
        self.structure = COOStructure(rows, cols, shape)
        self.values = values

    @property
    def rows(self):
        return self.structure.rows

    @property
    def cols(self):
        return self.structure.cols

    @property
    def shape(self) -> Tuple[int, int]:
        return self.structure.shape

    @property
    def nnz(self) -> int:
        return self.structure.nnz

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> Optional[torch.device]:
        return _device_of(self.values, self.rows, self.cols)

    def view(self) -> "COOMatrix":
        return self

    def with_values(self, values) -> "COOMatrix":
        """New COO sharing this structure (the structure/values split)."""
        return COOMatrix(self.rows, self.cols, values, self.shape)

    def to(self, device) -> "COOMatrix":
        dev = torch.device(device)
        return COOMatrix(_index(self.rows, dev), _index(self.cols, dev),
                         _values(self.values, dev), self.shape)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put_((self.rows.long(), self.cols.long()),
                              self.values, accumulate=True)

    @classmethod
    def from_dense(cls, mat, device=None) -> "COOMatrix":
        """Nonzeros of a dense matrix, row-major (a tensor keeps its
        device; other input goes to ``device``, default cuda)."""
        dev = resolve_device(device, mat)
        mat = _tensor(mat, dev)
        r, c = torch.nonzero(mat, as_tuple=True)
        return cls(r.to(torch.int32), c.to(torch.int32), mat[r, c],
                   tuple(mat.shape))

    @classmethod
    def from_numpy(cls, rows, cols, values, shape,
                   device=None) -> "COOMatrix":
        """The carry-across: the reference's COO arrays as the port's
        matrix on ``device`` (default cuda)."""
        dev = resolve_device(device)
        return cls(_index(rows, dev), _index(cols, dev), _values(values, dev),
                   shape)

    def __repr__(self):
        return (f"COOMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype})")


class CSRStructure:
    """(ref: core/csr_matrix.hpp ``compressed_structure_t``)"""

    def __init__(self, indptr, indices, shape: Tuple[int, int]):
        self.indptr = indptr
        self.indices = indices
        self.shape = (int(shape[0]), int(shape[1]))

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @classmethod
    def from_numpy(cls, indptr, indices, shape,
                   device=None) -> "CSRStructure":
        dev = resolve_device(device)
        return cls(_index(indptr, dev), _index(indices, dev), shape)


class CSRMatrix:
    """Owning CSR matrix = compressed structure + values.
    (ref: core/csr_matrix.hpp, core/device_csr_matrix.hpp)"""

    def __init__(self, indptr, indices, values, shape: Tuple[int, int]):
        self.structure = CSRStructure(indptr, indices, shape)
        self.values = values

    @property
    def indptr(self):
        return self.structure.indptr

    @property
    def indices(self):
        return self.structure.indices

    @property
    def shape(self) -> Tuple[int, int]:
        return self.structure.shape

    @property
    def nnz(self) -> int:
        return self.structure.nnz

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self) -> Optional[torch.device]:
        return _device_of(self.values, self.indptr, self.indices)

    def with_values(self, values) -> "CSRMatrix":
        return CSRMatrix(self.indptr, self.indices, values, self.shape)

    def to(self, device) -> "CSRMatrix":
        dev = torch.device(device)
        return CSRMatrix(_index(self.indptr, dev), _index(self.indices, dev),
                         _values(self.values, dev), self.shape)

    def row_ids(self) -> torch.Tensor:
        """One row id per nnz (the csr→coo row expansion, ref:
        sparse/convert/csr.cuh)."""
        indptr = self.indptr
        counts = (indptr[1:] - indptr[:-1]).long()
        rows = torch.arange(self.shape[0], dtype=torch.int32,
                            device=indptr.device)
        return torch.repeat_interleave(rows, counts, output_size=self.nnz)

    def to_dense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        return out.index_put_((self.row_ids().long(), self.indices.long()),
                              self.values, accumulate=True)

    @classmethod
    def from_dense(cls, mat, device=None) -> "CSRMatrix":
        dev = resolve_device(device, mat)
        mat = _tensor(mat, dev)
        r, c = torch.nonzero(mat, as_tuple=True)
        counts = torch.bincount(r, minlength=mat.shape[0])
        indptr = torch.zeros(mat.shape[0] + 1, dtype=torch.int32,
                             device=dev)
        indptr[1:] = torch.cumsum(counts, 0)
        return cls(indptr, c.to(torch.int32), mat[r, c], tuple(mat.shape))

    @classmethod
    def from_numpy(cls, indptr, indices, values, shape,
                   device=None) -> "CSRMatrix":
        """The carry-across: the reference's CSR arrays as the port's
        matrix on ``device`` (default cuda)."""
        dev = resolve_device(device)
        return cls(_index(indptr, dev), _index(indices, dev),
                   _values(values, dev), shape)

    def __repr__(self):
        return (f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"dtype={self.dtype})")


def sparse_arrays(A) -> tuple:
    """(rows, cols, values) of a COO, (indptr, indices, values) of a
    CSR."""
    if isinstance(A, COOMatrix):
        return A.rows, A.cols, A.values
    return A.indptr, A.indices, A.values


def to_device(A, device=None):
    """``A`` (COO or CSR) with tensors on the entry point's device: the
    one named, else the device of its tensors, else cuda. Returns ``A``
    itself when it is already there."""
    if not isinstance(A, (COOMatrix, CSRMatrix)):
        raise TypeError(f"expected a COOMatrix or CSRMatrix, got {type(A)}")
    arrays = sparse_arrays(A)
    dev = resolve_device(device, arrays[2], *arrays[:2])
    if all(isinstance(a, torch.Tensor) and a.device == dev for a in arrays):
        return A
    return A.to(dev)
