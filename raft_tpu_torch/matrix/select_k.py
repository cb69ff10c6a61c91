"""Batched top-k selection (counterpart of ``raft_tpu/matrix/select_k.py``;
ref: cpp/include/raft/matrix/select_k.cuh:75).

Semantics kept from the reference: batched rows, optional input indices
(default 0..len-1 per row), ``select_min``, sorted output.

Algorithms. ``XLA_TOPK`` — the framework's own top-k, here ``torch.topk``.
The reference's ``CHUNKED`` (and its ``RADIX`` alias) is an exact
per-chunk + merge selection that exists because XLA's TPU top-k grows
superlinearly with row length; it returns the same exact answer as one
``torch.topk``, which serves it here. ``APPROX`` has no approximate
counterpart in PyTorch: the exact answer meets any recall target.
``SLOTTED`` (and its ``BITONIC`` alias) runs the TPU kernel K3, which is not
ported yet, and raises. AUTO picks ``XLA_TOPK``: the reference's table of
measured timings is TPU data, and the port has none of its own yet.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import ensure_resources
from raft_tpu_torch.matrix.select_k_types import SelectAlgo

_K3_ALGOS = (SelectAlgo.SLOTTED, SelectAlgo.BITONIC)


def choose_select_k_algorithm(n_rows: int, length: int, k: int,
                              dtype=None) -> SelectAlgo:
    """AUTO's choice (see the module docstring)."""
    return SelectAlgo.XLA_TOPK


def _topk_select(in_val, in_idx, k: int, select_min: bool):
    out_val, pos = torch.topk(in_val, k, dim=1, largest=not select_min,
                              sorted=True)
    return out_val, torch.gather(in_idx, 1, pos)


def select_k(res, in_val, in_idx=None, k: int = 1, select_min: bool = True,
             sorted: bool = True,  # noqa: A002
             algo: SelectAlgo = SelectAlgo.AUTO,
             recall_target: float = 0.95
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k smallest (or largest) entries per row.

    Returns ``(out_val [batch, k], out_idx [batch, k])``. ``in_val`` runs
    where it lies when it is a tensor, else on the handle's device."""
    if isinstance(in_val, torch.Tensor):
        dev = in_val.device
    else:
        dev = ensure_resources(res).device
        in_val = torch.as_tensor(in_val, device=dev)
    expects(in_val.ndim == 2, "select_k: in_val must be [batch, len]")
    batch, length = in_val.shape
    expects(0 < k <= length, "select_k: k=%d out of range for len=%d", k,
            length)
    if in_idx is None:
        in_idx = torch.arange(length, dtype=torch.int32,
                              device=dev).expand(batch, length)
    else:
        in_idx = torch.as_tensor(in_idx, device=dev)
        expects(tuple(in_idx.shape) == tuple(in_val.shape),
                "select_k: in_idx shape mismatch")
    if algo == SelectAlgo.AUTO:
        algo = choose_select_k_algorithm(batch, length, k, in_val.dtype)
    if algo in _K3_ALGOS:
        raise NotImplementedError(
            f"select_k: algo={algo.name} runs the slotted selection kernel "
            f"K3 (raft_tpu/ops/select_slotted_pallas.py), not yet ported")
    return _topk_select(in_val, in_idx, k, select_min)
