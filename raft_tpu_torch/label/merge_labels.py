"""Merge two labelings by min-equivalence iteration (counterpart of
``raft_tpu/label/merge_labels.py``; ref: cpp/include/raft/label/
merge_labels.cuh).

The reference's ``while_loop`` of ``segment_min`` rounds becomes a host
loop of ``scatter_reduce(..., "amin")`` rounds on the labels' device, one
host read of the "changed" flag a round: at most ``max_iters`` reads.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensors


def _propagate(out, part, n: int):
    """out[i] ← min(out[i], min of out over i's class in ``part``)."""
    seg_min = torch.full((n,), torch.iinfo(out.dtype).max, dtype=out.dtype,
                         device=out.device)
    seg_min.scatter_reduce_(0, part, out, "amin", include_self=False)
    return torch.minimum(out, seg_min[part])


def merge_labels(res, labels_a, labels_b, max_iters: int = 100
                 ) -> torch.Tensor:
    """The labeling of the finest common coarsening: each output label is
    the least label of its connected class under "same label in a" ∪
    "same label in b". Labels must lie in 0..n − 1."""
    a, b = as_tensors(res, labels_a, labels_b)
    a, b = a.long(), b.long()
    n = a.shape[0]
    out = torch.minimum(a, b).to(torch.int32)
    for _ in range(max_iters):
        new = _propagate(_propagate(out, a, n), b, n)
        changed = bool((new != out).any())
        out = new
        if not changed:
            break
    return out
