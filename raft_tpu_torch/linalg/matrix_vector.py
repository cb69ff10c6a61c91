"""Matrix ⊕ vector broadcast ops of the port (counterpart of
``raft_tpu/linalg/matrix_vector.py``; ref: cpp/include/raft/linalg/
matrix_vector_op.cuh and matrix_vector.cuh).

``apply=Apply.ALONG_ROWS`` broadcasts the vector along rows (its length is
n_cols, added to every row); ``ALONG_COLUMNS`` along columns (length
n_rows).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.linalg.types import Apply


def _bcast(vec, apply: Apply):
    return vec[None, :] if apply == Apply.ALONG_ROWS else vec[:, None]


def matrix_vector_op(res, matrix, vec, op: Callable,
                     apply: Apply = Apply.ALONG_ROWS):
    """op(matrix, vector broadcast). (ref: matrix_vector_op.cuh,
    1-vector overload)"""
    matrix, vec = as_tensors(res, matrix, vec)
    n = matrix.shape[1] if apply == Apply.ALONG_ROWS else matrix.shape[0]
    expects(vec.numel() == n, "matrix_vector_op: vector length %d != "
            "extent %d", vec.numel(), n)
    return op(matrix, _bcast(vec, apply))


def matrix_vector_op2(res, matrix, vec1, vec2, op: Callable,
                      apply: Apply = Apply.ALONG_ROWS):
    """Two-vector overload. (ref: matrix_vector_op.cuh 2-vector)"""
    matrix, vec1, vec2 = as_tensors(res, matrix, vec1, vec2)
    return op(matrix, _bcast(vec1, apply), _bcast(vec2, apply))


# named variants (ref: linalg/matrix_vector.cuh)
def binary_mult(res, matrix, vec, apply: Apply = Apply.ALONG_ROWS):
    return matrix_vector_op(res, matrix, vec, lambda m, v: m * v, apply)


def binary_mult_skip_zero(res, matrix, vec, apply: Apply = Apply.ALONG_ROWS):
    """Multiply, zero vector entries taken as 1.
    (ref: matrix_vector.cuh ``binary_mult_skip_zero``)"""
    return matrix_vector_op(
        res, matrix, vec, lambda m, v: torch.where(v == 0, m, m * v), apply)


def binary_div(res, matrix, vec, apply: Apply = Apply.ALONG_ROWS):
    return matrix_vector_op(res, matrix, vec, lambda m, v: m / v, apply)


def binary_div_skip_zero(res, matrix, vec, apply: Apply = Apply.ALONG_ROWS,
                         return_zero: bool = False):
    """Divide, skipping zero vector entries (or zeroing the output there).
    (ref: matrix_vector.cuh ``binary_div_skip_zero``)"""

    def op(m, v):
        zero = v == 0
        q = m / torch.where(zero, torch.ones_like(v), v)
        return torch.where(zero, torch.zeros_like(q) if return_zero else m,
                           q)

    return matrix_vector_op(res, matrix, vec, op, apply)


def binary_add(res, matrix, vec, apply: Apply = Apply.ALONG_ROWS):
    return matrix_vector_op(res, matrix, vec, lambda m, v: m + v, apply)


def binary_sub(res, matrix, vec, apply: Apply = Apply.ALONG_ROWS):
    return matrix_vector_op(res, matrix, vec, lambda m, v: m - v, apply)
