"""Matrix manipulation of the port: slice, reverse, shift, diagonal,
triangular, eye, fill, linewise op, print (counterpart of
``raft_tpu/matrix/manip.py``; ref: cpp/include/raft/matrix/slice.cuh,
reverse.cuh, shift.cuh, diagonal.cuh, triangular.cuh, init.cuh,
linewise_op.cuh, print.hpp). Every function returns a new tensor."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_tensors, input_device
from raft_tpu_torch.linalg.types import Apply


def slice(res, matrix, x1: int, y1: int, x2: int, y2: int):  # noqa: A001
    """A copy of the [x1:x2, y1:y2) submatrix. (ref: slice.cuh)"""
    matrix, = as_tensors(res, matrix)
    expects(0 <= x1 < x2 <= matrix.shape[0]
            and 0 <= y1 < y2 <= matrix.shape[1], "slice: bad coordinates")
    return matrix[x1:x2, y1:y2].clone()


def reverse(res, matrix, along_rows: bool = True):
    """Row order (``along_rows``) or column order flipped.
    (ref: matrix/reverse.cuh ``row_reverse`` / ``col_reverse``)"""
    matrix, = as_tensors(res, matrix)
    return matrix.flip(0 if along_rows else 1)


def col_reverse(res, matrix):
    return reverse(res, matrix, along_rows=False)


def row_reverse(res, matrix):
    return reverse(res, matrix, along_rows=True)


def shift(res, matrix, offset: int, along_rows: bool = True, fill_value=0):
    """Rows (or columns) moved ``offset`` places toward higher indices
    (a negative offset toward lower ones), the vacated lines filled.
    (ref: matrix/shift.cuh)"""
    matrix, = as_tensors(res, matrix)
    dim = 0 if along_rows else 1
    n = matrix.shape[dim]
    expects(abs(offset) <= n, "shift: offset %d exceeds extent %d", offset,
            n)
    rolled = torch.roll(matrix, offset, dims=dim)
    idx = torch.arange(n, device=matrix.device)
    vacated = idx < offset if offset >= 0 else idx >= n + offset
    mask = vacated[:, None] if along_rows else vacated[None, :]
    return torch.where(mask, torch.full((), fill_value, dtype=matrix.dtype,
                                        device=matrix.device), rolled)


def get_diagonal(res, matrix):
    """(ref: matrix/diagonal.cuh ``get_diagonal_vector``)"""
    return as_tensors(res, matrix)[0].diagonal().clone()


def set_diagonal(res, matrix, diag):
    """(ref: diagonal.cuh ``set_diagonal``)"""
    matrix, diag = as_tensors(res, matrix, diag)
    out = matrix.clone()
    n = min(out.shape)
    out.diagonal().copy_(diag[:n])
    return out


def invert_diagonal(res, matrix):
    """(ref: diagonal.cuh ``invert_diagonal``)"""
    matrix, = as_tensors(res, matrix)
    out = matrix.clone()
    out.diagonal().reciprocal_()
    return out


def upper_triangular(res, matrix):
    """The upper triangle. (ref: matrix/triangular.cuh)"""
    return torch.triu(as_tensors(res, matrix)[0])


def lower_triangular(res, matrix):
    return torch.tril(as_tensors(res, matrix)[0])


def eye(res, n_rows: int, n_cols: Optional[int] = None, dtype=torch.float32,
        device=None):
    """Identity on the handle's device (or ``device``).
    (ref: matrix/init.cuh ``eye``)"""
    return torch.eye(n_rows, n_cols if n_cols is not None else n_rows,
                     dtype=dtype, device=input_device(res, device=device))


def fill(res, shape, value, dtype=torch.float32, device=None):
    """(ref: matrix/init.cuh ``fill``)"""
    return torch.full(tuple(shape), value, dtype=dtype,
                      device=input_device(res, device=device))


def linewise_op(res, matrix, *vecs, op: Callable,
                apply: Apply = Apply.ALONG_ROWS):
    """op(matrix, v0, v1, ...) with each vector broadcast line-wise:
    ``ALONG_ROWS`` vectors have length n_cols and span each row,
    ``ALONG_COLUMNS`` ones length n_rows. (ref: matrix/linewise_op.cuh)"""
    matrix, *vecs = as_tensors(res, matrix, *vecs)
    if apply == Apply.ALONG_ROWS:
        return op(matrix, *[v[None, :] for v in vecs])
    return op(matrix, *[v[:, None] for v in vecs])


def print_matrix(matrix, name: str = "", h_separator: str = " ",
                 v_separator: str = "\n") -> str:
    """Host-side pretty print. (ref: matrix/print.hpp)"""
    if isinstance(matrix, torch.Tensor):
        matrix = matrix.detach().cpu().numpy()
    body = v_separator.join(
        h_separator.join(f"{v}" for v in row)
        for row in np.atleast_2d(np.asarray(matrix)))
    return f"{name}{v_separator}{body}" if name else body
