"""Sequence init of the port (counterpart of ``raft_tpu/linalg/init.py``;
ref: cpp/include/raft/linalg/init.cuh ``range``)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import input_device


def range_fill(res, start: int, end: int, dtype=torch.int32, device=None):
    """start, start + 1, …, end − 1 on the handle's device (or
    ``device``). (ref: init.cuh ``range(out, start, end, stream)``)"""
    return torch.arange(start, end, dtype=dtype,
                        device=input_device(res, device=device))
