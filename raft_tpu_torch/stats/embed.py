"""Embedding-quality metrics of the port: silhouette, trustworthiness,
neighborhood recall.

Counterpart of ``raft_tpu/stats/embed.py`` (ref: cpp/include/raft/stats/
silhouette_score.cuh:37 and its batched variant, trustworthiness_score,
neighborhood_recall). Distances come from the port's
:func:`raft_tpu_torch.distance.pairwise_distance`, so an unexpanded
metric runs K8 on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device
from raft_tpu_torch.distance.pairwise import pairwise_distance


def _points_labels(res, X, labels, n_clusters):
    dev = input_device(res, X, labels)
    (X,) = float_operands(dev, X)
    if not isinstance(labels, torch.Tensor):
        labels = torch.from_numpy(np.array(labels))
    labels = labels.to(device=dev, dtype=torch.int64)
    if n_clusters is None:
        n_clusters = int(labels.max()) + 1
    onehot = torch.nn.functional.one_hot(labels, n_clusters).to(X.dtype)
    return X, labels, onehot


def _silhouette_rows(D, own, onehot):
    """s(i) of the rows of D [r, n] (distances to all n points), whose
    labels are ``own`` [r], given every point's one-hot labels [n, k]."""
    sizes = onehot.sum(0)
    sums = D @ onehot
    own_size = sizes[own]
    a = torch.where(own_size > 1,
                    sums.gather(1, own[:, None])[:, 0]
                    / (own_size - 1).clamp_min(1), 0.0)
    means = sums / sizes[None, :].clamp_min(1)
    means = torch.where(sizes[None, :] > 0, means, float("inf"))
    means[torch.arange(D.shape[0], device=D.device), own] = float("inf")
    b = means.amin(1)
    return torch.where(own_size > 1,
                       (b - a) / torch.maximum(a, b).clamp_min(1e-30), 0.0)


def silhouette_score(res, X, labels, n_clusters: Optional[int] = None,
                     metric: str = "sqeuclidean") -> float:
    """Mean silhouette coefficient over the full n × n distance matrix.
    (ref: stats/silhouette_score.cuh:37)"""
    X, labels, onehot = _points_labels(res, X, labels, n_clusters)
    D = pairwise_distance(res, X, X, metric=metric)
    return float(_silhouette_rows(D, labels, onehot).mean())


def silhouette_score_batched(res, X, labels,
                             n_clusters: Optional[int] = None,
                             metric: str = "sqeuclidean",
                             chunk: int = 1024) -> float:
    """The silhouette in row chunks of ``chunk`` × n distances, never the
    full matrix. (ref: detail/batched/silhouette_score.cuh)"""
    X, labels, onehot = _points_labels(res, X, labels, n_clusters)
    n = X.shape[0]
    total = X.new_zeros(())            # on the device: chunks stay async
    for s in range(0, n, chunk):
        D = pairwise_distance(res, X[s:s + chunk], X, metric=metric)
        total += _silhouette_rows(D, labels[s:s + chunk], onehot).sum()
    return float(total) / n


def trustworthiness_score(res, X, X_embedded, n_neighbors: int = 5,
                          metric: str = "sqeuclidean") -> float:
    """How much an embedding keeps local structure (1 = perfectly), with
    both neighbour rankings computed here. (ref:
    stats/trustworthiness_score.cuh; sklearn's definition)"""
    dev = input_device(res, X, X_embedded)
    X, E = float_operands(dev, X, X_embedded)
    n, k = X.shape[0], n_neighbors
    expects(k < n / 2, "trustworthiness: n_neighbors must be < n/2")
    diag = torch.arange(n, device=dev)
    D_orig = pairwise_distance(res, X, X, metric=metric)
    D_emb = pairwise_distance(res, E, E, metric=metric)
    D_orig[diag, diag] = float("inf")
    D_emb[diag, diag] = float("inf")
    # rank of j in i's original ordering (0 = nearest); stable sorts break
    # ties by index, as the reference's argsort and top_k do
    order = torch.argsort(D_orig, dim=1, stable=True)
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, diag[None, :].expand(n, n))
    emb_knn = torch.argsort(D_emb, dim=1, stable=True)[:, :k]
    r = ranks.gather(1, emb_knn).to(torch.float64)
    penalty = ((r - k + 1).clamp_min(0.0) * (r >= k)).sum()
    norm = 2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0))
    return float(1.0 - norm * penalty)


def neighborhood_recall(res, indices, ref_indices) -> float:
    """Mean |knn ∩ ref_knn| / k. (ref: stats/neighborhood_recall.cuh)"""
    dev = input_device(res, indices, ref_indices)
    a, b = ((v if isinstance(v, torch.Tensor)
             else torch.from_numpy(np.array(v))).to(dev)
            for v in (indices, ref_indices))
    expects(a.shape == b.shape, "neighborhood_recall: shape mismatch")
    hits = (a[:, :, None] == b[:, None, :]).any(2)
    return float(hits.to(torch.float64).mean())
