"""Transpose of the port (counterpart of ``raft_tpu/linalg/transpose.py``;
ref: cpp/include/raft/linalg/transpose.cuh). The result is a new
contiguous tensor, as the reference's out-of-place ``geam``; the in-place
name is kept and is the same function."""

from __future__ import annotations

from raft_tpu_torch.core.resources import as_tensors


def transpose(res, matrix):
    return as_tensors(res, matrix)[0].T.contiguous()


transpose_inplace = transpose
