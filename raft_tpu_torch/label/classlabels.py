"""Label compaction of the port (counterpart of
``raft_tpu/label/classlabels.py``; ref: cpp/include/raft/label/
classlabels.cuh:31 ``getUniquelabels``, :81,104 ``make_monotonic``): map
arbitrary labels onto 0..n_classes − 1 on the labels' device."""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.resources import as_tensors


def get_unique_labels(res, labels) -> torch.Tensor:
    """The sorted unique labels. (ref: classlabels.cuh:31)"""
    return torch.unique(as_tensors(res, labels)[0], sorted=True)


def make_monotonic(res, labels, classes=None, zero_based: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels remapped onto a dense 0..k − 1 (or 1..k) range in their
    order: (monotonic labels int32, sorted classes).
    (ref: classlabels.cuh:81,104)"""
    labels, classes = as_tensors(res, labels, classes)
    if classes is None:
        classes = get_unique_labels(res, labels)
    classes = torch.sort(classes.to(labels.dtype)).values
    mono = torch.searchsorted(classes, labels).to(torch.int32)
    return (mono if zero_based else mono + 1), classes
