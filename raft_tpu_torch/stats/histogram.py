"""Histograms of the port, with K9.

Counterpart of ``raft_tpu/stats/histogram.py`` (ref: cpp/include/raft/
stats/histogram.cuh). Strategies (``HistType``; the reference's names
``GlobalAtomics`` and ``SmemBits`` alias SegmentSum and Blocked):

- ``SegmentSum``: ``torch.bincount`` over ``column·n_bins + bin``;
- ``OneHot``: row blocks of one-hot compares summed (the plain fold that
  is also K9's twin), on the CPU only: the twin is not a card path, so
  on a CUDA device OneHot takes K9 (SegmentSum past K9's bin limit);
- ``Blocked``: K9, ``ops.histogram`` — shared-memory counters per block
  on the card, its twin on the CPU.

``Auto`` on a CUDA device takes Blocked whenever ``n_bins ≤ 1024``, for
every n and batch: the TPU rule's reasons (one lane of 128 at batch 1, a
dispatch worth paying only from n ≥ 4096) do not hold on a GPU; beyond
that it takes SegmentSum. On the CPU it follows the reference's non-TPU
rule: SegmentSum at batch 1 or past 1024 bins, else OneHot. Counts are
integers, so every strategy gives the same answer.
"""

from __future__ import annotations

import enum
from typing import Callable, Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import float_operands, input_device
from raft_tpu_torch.ops.histogram import (MAX_BINS, histogram_blocked,
                                          histogram_blocked_ref)

#: the most bins the dense strategies take under Auto (the reference's)
_DENSE_MAX_BINS = 1024


class HistType(enum.Enum):
    """(ref: stats/histogram.cuh ``HistType``)"""

    Auto = "auto"
    SegmentSum = "segment_sum"
    OneHot = "one_hot"
    Blocked = "blocked"
    # the reference's names, aliases of their roles
    GlobalAtomics = "segment_sum"
    SmemBits = "blocked"


class IdentityBinner:
    """(ref: stats/histogram.cuh ``IdentityBinner``: the data are bin
    ids)"""

    def __call__(self, x, row):
        return x.to(torch.int32)


def _choose_hist_type(device: torch.device, batch: int, n_bins: int,
                      hist_type: HistType = HistType.Auto) -> HistType:
    """The strategy that runs for ``hist_type`` on ``device``."""
    on_card = device.type == "cuda"
    if hist_type is HistType.OneHot and on_card:
        return HistType.Blocked if n_bins <= MAX_BINS else HistType.SegmentSum
    if hist_type is not HistType.Auto:
        return hist_type
    if n_bins > _DENSE_MAX_BINS:
        return HistType.SegmentSum
    if on_card:
        return HistType.Blocked
    return HistType.SegmentSum if batch == 1 else HistType.OneHot


def _hist_segment_sum(bins, n_bins: int):
    n, batch = bins.shape
    cols = torch.arange(batch, device=bins.device)[None, :]
    flat = (cols * n_bins + bins).reshape(-1)
    counts = torch.bincount(flat, minlength=batch * n_bins)
    return counts.reshape(batch, n_bins).T.to(torch.int32).contiguous()


def histogram(res, data, n_bins: int, binner: Optional[Callable] = None,
              hist_type: HistType = HistType.Auto):
    """Column-batched histogram: data [n, batch] → counts [n_bins, batch]
    int32 (1-D data gives [n_bins]). The binner's ids are clipped to
    ``[0, n_bins)`` first, as the reference does. (ref:
    stats/histogram.cuh ``histogram``)"""
    dev = input_device(res, data)
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.array(data))
    data = data.to(dev)
    one_d = data.ndim == 1
    if one_d:
        data = data[:, None]
    if binner is None:
        binner = IdentityBinner()
    cols = torch.arange(data.shape[1], device=dev)
    bins = binner(data, cols[None, :]).to(torch.int32)
    bins = bins.clamp(0, n_bins - 1).contiguous()
    ht = _choose_hist_type(dev, bins.shape[1], n_bins, hist_type)
    if ht is HistType.Blocked:
        out = histogram_blocked(bins, n_bins)
    elif ht is HistType.OneHot:
        out = histogram_blocked_ref(bins, n_bins)
    else:
        out = _hist_segment_sum(bins, n_bins)
    return out[:, 0] if one_d else out


def value_histogram(res, values, n_bins: int, lo=None, hi=None):
    """Equal-width bins over ``[lo, hi]`` (default: the values' range)."""
    (values,) = float_operands(input_device(res, values), values)
    lo = values.min() if lo is None else lo
    hi = values.max() if hi is None else hi
    width = torch.as_tensor((hi - lo) / n_bins, dtype=values.dtype,
                            device=values.device).clamp_min(1e-30)
    bins = ((values - lo) / width).to(torch.int32).clamp(0, n_bins - 1)
    return histogram(res, bins, n_bins)
