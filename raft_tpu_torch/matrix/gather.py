"""Row gather and scatter of the port, with the conditional and
transforming variants (counterpart of ``raft_tpu/matrix/gather.py``; ref:
cpp/include/raft/matrix/gather.cuh, gather_inplace.cuh, scatter.cuh).
Every variant returns a new tensor; the in-place name is kept."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_tensors


def gather(res, matrix, gather_map, transform_op: Optional[Callable] = None):
    """out[i, :] = op(matrix[map[i], :]). (ref: gather.cuh ``gather``)"""
    matrix, gather_map = as_tensors(res, matrix, gather_map)
    out = matrix[gather_map.long()]
    return transform_op(out) if transform_op else out


def gather_if(res, matrix, gather_map, stencil, pred_op: Callable,
              transform_op: Optional[Callable] = None):
    """Rows gathered where pred_op(stencil[i]); the other output rows are
    zero. (ref: gather.cuh ``gather_if``)"""
    gathered = gather(res, matrix, gather_map, transform_op)
    keep = pred_op(as_tensors(res, stencil, device=gathered.device)[0])
    return torch.where(keep.bool()[:, None], gathered,
                       torch.zeros_like(gathered))


gather_inplace = gather  # (ref: gather_inplace.cuh)


def scatter(res, matrix, scatter_map):
    """out[map[i], :] = matrix[i, :], ``map`` a permutation of
    0..n_rows − 1 as in the reference. (ref: matrix/scatter.cuh)"""
    matrix, scatter_map = as_tensors(res, matrix, scatter_map)
    expects(scatter_map.shape[0] == matrix.shape[0],
            "scatter: map length %d != n_rows %d", scatter_map.shape[0],
            matrix.shape[0])
    out = torch.zeros_like(matrix)
    out[scatter_map.long()] = matrix
    return out
