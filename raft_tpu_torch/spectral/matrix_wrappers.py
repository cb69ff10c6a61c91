"""Materialization-free spectral operators of the port.

(Counterpart of ``raft_tpu/spectral/matrix_wrappers.py``; ref: cpp/include/
raft/spectral/detail/matrix_wrappers.hpp — ``sparse_matrix_t:132``,
``laplacian_matrix_t:325`` (L·x = D·x − A·x without materializing L),
``modularity_matrix_t:400`` (B·x = A·x − (d·x)·d / 2m).)
"""

from __future__ import annotations

from typing import Union

import torch

from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix, to_device
from raft_tpu_torch.sparse.linalg import spmv

Sparse = Union[COOMatrix, CSRMatrix]


class SparseMatrix:
    """CSR/COO wrapper with ``mv``. (ref: matrix_wrappers.hpp:132)"""

    def __init__(self, res, A: Sparse):
        self.res = res
        self.A = to_device(A, res.device if res is not None else None)
        self.shape = A.shape

    @property
    def dtype(self):
        return self.A.values.dtype

    @property
    def device(self):
        return self.A.values.device

    def _vec(self, x):
        v = self.A.values
        return torch.as_tensor(x).to(device=v.device, dtype=v.dtype)

    def _epilogue(self, out, alpha, beta, y):
        out = alpha * out
        if y is not None and beta != 0.0:
            out = out + beta * self._vec(y)
        return out

    def mv(self, x, alpha=1.0, beta=0.0, y=None):
        return self._epilogue(spmv(self.res, self.A, self._vec(x)), alpha,
                              beta, y)


class LaplacianMatrix(SparseMatrix):
    """L·x = D·x − A·x, degree precomputed, L never materialized.
    (ref: matrix_wrappers.hpp:325 ``laplacian_matrix_t``)"""

    def __init__(self, res, A: Sparse):
        super().__init__(res, A)
        v = self.A.values
        ones = torch.ones(A.shape[1], dtype=v.dtype, device=v.device)
        self.diagonal = spmv(res, self.A, ones)          # degree vector

    def mv(self, x, alpha=1.0, beta=0.0, y=None):
        x = self._vec(x)
        return self._epilogue(self.diagonal * x - spmv(self.res, self.A, x),
                              alpha, beta, y)


class ModularityMatrix(SparseMatrix):
    """B·x = A·x − (d·x)·d / 2m. (ref: matrix_wrappers.hpp:400
    ``modularity_matrix_t``)"""

    def __init__(self, res, A: Sparse):
        super().__init__(res, A)
        v = self.A.values
        ones = torch.ones(A.shape[1], dtype=v.dtype, device=v.device)
        self.degree = spmv(res, self.A, ones)
        self.edge_sum = self.degree.sum()      # = 2m for a symmetric A

    def mv(self, x, alpha=1.0, beta=0.0, y=None):
        x = self._vec(x)
        bx = spmv(self.res, self.A, x) - (
            torch.dot(self.degree, x) / self.edge_sum) * self.degree
        return self._epilogue(bx, alpha, beta, y)
