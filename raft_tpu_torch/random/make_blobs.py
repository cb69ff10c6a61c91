"""Isotropic Gaussian blob generator (counterpart of
``raft_tpu/random/make_blobs.py:47``; ref: cpp/include/raft/random/
make_blobs.cuh).

Same parameters and layout as the reference, drawn from a
``torch.Generator`` on the target device. The streams cannot match JAX's
threefry bits: parity tests feed both packages the same numpy data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device


def _imbalanced_counts(n_samples: int, proportions) -> np.ndarray:
    """Per-cluster counts: floor shares, the remainder to the largest
    proportions (ties by index) — deterministic for given inputs."""
    p = np.asarray(proportions, np.float64)
    if (p < 0).any() or p.sum() <= 0:
        raise ValueError("make_blobs: proportions must be non-negative "
                         "and sum to a positive value")
    p = p / p.sum()
    counts = np.floor(p * n_samples).astype(np.int64)
    short = n_samples - int(counts.sum())
    for i in np.argsort(-p, kind="stable")[:short]:
        counts[i] += 1
    return counts


def make_blobs(
    res,
    state,
    n_samples: int,
    n_features: int,
    n_clusters: int = 3,
    cluster_std=1.0,
    centers=None,
    center_box: Tuple[float, float] = (-10.0, 10.0),
    shuffle: bool = True,
    proportions=None,
    return_centers: bool = False,
    dtype=torch.float32,
    device=None,
):
    """Returns ``(X [n_samples, n_features], labels [n_samples])`` — or
    ``(X, labels, centers)`` with ``return_centers=True``.

    ``state`` is an int seed, a ``torch.Generator`` on the target device,
    or None for the handle's own generator; ``device`` defaults to the
    handle's (``res``) or ``cuda``. ``cluster_std`` may be per-center; ``proportions`` switches on the
    imbalanced-sizes mode (see the reference)."""
    if device is None and res is not None:
        device = res.device
    dev = resolve_device(device)
    if isinstance(state, torch.Generator):
        gen = state
    elif state is None:
        gen = res.generator          # the handle's seeded stream
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(state))
    if centers is None:
        lo, hi = center_box
        centers = lo + (hi - lo) * torch.rand(
            (n_clusters, n_features), generator=gen, device=dev,
            dtype=dtype)
    else:
        centers = torch.as_tensor(centers, dtype=dtype, device=dev)
        n_clusters = centers.shape[0]
    if proportions is not None:
        if len(proportions) != n_clusters:
            raise ValueError(
                f"make_blobs: proportions has {len(proportions)} "
                f"entries for {n_clusters} clusters")
        counts = torch.as_tensor(_imbalanced_counts(n_samples, proportions),
                                 device=dev)
        labels = torch.repeat_interleave(
            torch.arange(n_clusters, device=dev), counts).to(torch.int32)
    else:
        # balanced round-robin assignment like the reference
        labels = (torch.arange(n_samples, device=dev, dtype=torch.int32)
                  % n_clusters)
    std = torch.as_tensor(cluster_std, dtype=dtype, device=dev)
    li = labels.long()
    per_point = std[li][:, None] if std.ndim == 1 else std
    X = centers[li] + torch.randn((n_samples, n_features), generator=gen,
                                  device=dev, dtype=dtype) * per_point
    if shuffle:
        perm = torch.randperm(n_samples, generator=gen, device=dev)
        X, labels = X[perm], labels[perm]
    if return_centers:
        return X, labels, centers
    return X, labels
