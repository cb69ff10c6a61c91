"""Row/column norms and normalization of the port (counterpart of
``raft_tpu/linalg/norm.py``; ref: cpp/include/raft/linalg/norm.cuh
rowNorm/colNorm, linalg/normalize.cuh)."""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core import operators as ops
from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.linalg.types import Apply, NormType


def _norm(data, norm_type: NormType, dim: int, final_sqrt: bool,
          keepdim: bool = False):
    if norm_type == NormType.L1:
        return data.abs().sum(dim, keepdim=keepdim)
    if norm_type == NormType.L2:
        out = (data * data).sum(dim, keepdim=keepdim)
        return out.sqrt() if final_sqrt else out
    return data.abs().amax(dim, keepdim=keepdim)


def row_norm(res, data, norm_type: NormType = NormType.L2,
             final_sqrt: bool = False, final_op: Callable = ops.identity_op):
    """One norm per row; L2 is the *squared* norm unless ``final_sqrt``,
    as in the reference. (ref: norm.cuh ``rowNorm``)"""
    return final_op(_norm(as_tensors(res, data)[0], norm_type, 1,
                          final_sqrt))


def col_norm(res, data, norm_type: NormType = NormType.L2,
             final_sqrt: bool = False, final_op: Callable = ops.identity_op):
    """One norm per column. (ref: norm.cuh ``colNorm``)"""
    return final_op(_norm(as_tensors(res, data)[0], norm_type, 0,
                          final_sqrt))


def norm(res, data, norm_type: NormType = NormType.L2,
         apply: Apply = Apply.ALONG_ROWS, final_sqrt: bool = False,
         final_op: Callable = ops.identity_op):
    """ALONG_ROWS → one norm per row (rowNorm), ALONG_COLUMNS → one per
    column (colNorm). (ref: norm.cuh)"""
    if apply == Apply.ALONG_ROWS:
        return row_norm(res, data, norm_type, final_sqrt, final_op)
    return col_norm(res, data, norm_type, final_sqrt, final_op)


def normalize(res, data, norm_type: NormType = NormType.L2, eps: float = 1e-8):
    """Each row divided by its norm (L2 with its root); rows whose norm is
    at most ``eps`` become zeros. (ref: linalg/normalize.cuh
    ``row_normalize``)"""
    data = as_tensors(res, data)[0]
    norms = _norm(data, norm_type, 1, True, keepdim=True)
    small = norms <= eps
    q = data / torch.where(small, torch.ones_like(norms), norms)
    return torch.where(small, torch.zeros_like(q), q)


row_normalize = normalize
