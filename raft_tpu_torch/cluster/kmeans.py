"""Balanced k-means on the port's distance primitives.

Counterpart of ``raft_tpu/cluster/kmeans.py`` (ref: cluster/kmeans.cuh and
kmeans_balanced.cuh): Lloyd iterations of "assign (expanded L2, argmin) →
update (per-cluster mean)", with the balanced variant multiplying the
assignment scores by a per-cluster size penalty so that inverted lists
come out near-uniform. Prediction is the ``fused_l2_nn_argmin`` sweep.

Arithmetic. The reference's ``Xc @ centroids.T`` is an f32 product on
the CPU; the port runs it in full f32 as well: TF32 is off for every
matmul of the port (``core.resources``), since TF32's 10-bit factors
would move labels at near-ties. The centroid update sums a chunk's rows
per cluster as a one-hot product ``onehotᵀ @ Xc`` instead of the
reference's ``segment_sum``: the products are exact (factors 0 and 1)
and a matrix product is deterministic on the card where ``index_add_``'s
atomics are not, so two builds from one seed give one index.

Random state comes from a ``torch.Generator`` seeded with ``seed``; it
cannot reproduce JAX's threefry draws, so k-means++ is held to the
reference by statistics and the Lloyd loop by a shared ``init_centroids``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_f32, ensure_resources

#: balanced-penalty exponent: scores are multiplied by
#: ((size + 1) / (mean_size + 1)) ** alpha
DEFAULT_BALANCE_ALPHA = 0.25

#: row-chunk bound of the assignment sweep: the [chunk, k] score tile
#: stays under ~64 MB f32
_ASSIGN_TILE = 1 << 24


class KMeansResult(NamedTuple):
    """``centroids [k, d]``, the final ``labels [n]``, the true
    (unpenalized) ``inertia``, iterations run and ``cluster_sizes [k]``."""

    centroids: torch.Tensor
    labels: torch.Tensor
    inertia: float
    n_iter: int
    cluster_sizes: torch.Tensor


def _kmeanspp_init(gen: torch.Generator, Xs, k: int):
    """k-means++ on ``Xs``: the first center uniform, each next one drawn
    with probability ∝ the current min-d2, which is updated against the
    newest center only (reference ``:68``)."""
    n, d = Xs.shape
    xs2 = (Xs * Xs).sum(1)
    # a row that holds NaN or ±inf makes a weight that multinomial refuses;
    # then every draw is the reference's categorical one, a Gumbel-max over
    # log(max(mind2, 1e-30)), which ranks a NaN or +inf weight first
    finite = bool(torch.isfinite(xs2).all())
    centers = Xs.new_zeros((k, d))
    mind2 = Xs.new_ones((n,))            # all ones: a uniform first pick
    for i in range(k):
        if finite:
            idx = torch.multinomial(mind2.clamp_min(1e-30), 1,
                                    generator=gen)
        else:
            u = torch.rand(n, generator=gen, device=Xs.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(1e-38)))
            idx = torch.argmax(mind2.clamp_min(1e-30).log() + gumbel)[None]
        c = Xs[idx[0]]
        centers[i] = c
        d2 = (xs2 + (c * c).sum() - 2.0 * (Xs @ c)).clamp_min(0.0)
        mind2 = torch.minimum(mind2, d2)
    return centers


def _assign_chunk(Xc, centroids, weights, k: int):
    """One assignment chunk (reference ``:95``): expanded-L2 scores
    [C, k], times the balance weights for the argmin only. Returns the
    labels, the true inertia sum, the per-cluster row sums and counts."""
    xx = (Xc * Xc).sum(1, keepdim=True)
    cc = (centroids * centroids).sum(1)
    d2 = (xx + cc[None, :] - 2.0 * (Xc @ centroids.T)).clamp_min(0.0)
    labels = torch.argmin(d2 * weights[None, :], dim=1)
    best = torch.gather(d2, 1, labels[:, None])[:, 0]
    onehot = (labels[:, None] == torch.arange(
        k, device=Xc.device)[None, :]).to(Xc.dtype)            # [C, k]
    sums = onehot.T @ Xc
    counts = onehot.sum(0)
    return labels.to(torch.int32), best.sum(), sums, counts


def _balance_weights(counts, alpha: float):
    """((size + 1) / (mean + 1)) ** alpha: empty clusters look closer,
    oversized ones farther (reference ``:117``)."""
    return ((counts + 1.0) / (counts.mean() + 1.0)) ** alpha


def _assign_sweep(X, centroids, weights, k: int):
    """The assignment over row chunks. Returns (labels [n], inertia,
    sums [k, d], counts [k])."""
    n, d = X.shape
    chunk = max(8, min(n, _ASSIGN_TILE // max(1, 4 * k)))
    labels_out = []
    inertia = X.new_zeros(())
    sums = X.new_zeros((k, d))
    counts = X.new_zeros((k,))
    for s in range(0, n, chunk):
        lab, ine, sm, ct = _assign_chunk(X[s:s + chunk], centroids,
                                         weights, k)
        labels_out.append(lab)
        inertia = inertia + ine
        sums = sums + sm
        counts = counts + ct
    return torch.cat(labels_out), inertia, sums, counts


def kmeans_fit(res, X, n_clusters: int, max_iter: int = 20,
               tol: float = 1e-4, seed: int = 0, balanced: bool = False,
               balance_alpha: float = DEFAULT_BALANCE_ALPHA,
               init: str = "kmeans++", init_centroids=None,
               n_init: int = 1,
               max_init_rows: Optional[int] = None) -> KMeansResult:
    """Lloyd k-means (reference ``:164``).

    - **init**: ``"kmeans++"`` on a sub-sample of at most
      ``max_init_rows`` rows (default ``max(16·k, 2048)``) or ``"random"``
      rows; ``init_centroids`` replaces both. ``n_init`` > 1 restarts from
      seeds ``seed, seed+1, …`` and keeps the lowest inertia.
    - **assignment**: expanded L2; ``balanced=True`` multiplies each
      cluster's scores by ``((size+1)/(mean+1))**balance_alpha``. The
      reported inertia is the true d2 sum.
    - **update**: per-cluster means; an empty cluster keeps its centroid.
    - **convergence**: relative inertia change ≤ ``tol``.

    ``X`` is numpy or a tensor; the fit runs on ``X``'s device (a tensor)
    or on the handle's."""
    if n_init > 1 and init_centroids is None:
        best = None
        for i in range(int(n_init)):
            r = kmeans_fit(res, X, n_clusters, max_iter=max_iter, tol=tol,
                           seed=seed + i, balanced=balanced,
                           balance_alpha=balance_alpha, init=init,
                           max_init_rows=max_init_rows)
            if best is None or r.inertia < best.inertia:
                best = r
        return best
    dev = X.device if isinstance(X, torch.Tensor) else \
        ensure_resources(res).device
    X = as_f32(X, dev)
    n, d = X.shape
    k = int(n_clusters)
    expects(k >= 1, "kmeans_fit: n_clusters must be >= 1, got %d", k)
    expects(n >= k, "kmeans_fit: %d rows < n_clusters=%d", n, k)
    expects(init in ("kmeans++", "random"),
            "kmeans_fit: init must be 'kmeans++' or 'random', got %r", init)
    if init_centroids is not None:
        centroids = as_f32(init_centroids, dev)
        expects(tuple(centroids.shape) == (k, d),
                "kmeans_fit: init_centroids shape %s != (%d, %d)",
                tuple(centroids.shape), k, d)
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        cap = max_init_rows or max(16 * k, 2048)
        sub = X
        if n > cap:
            sub = X[torch.randperm(n, generator=gen, device=dev)[:cap]]
        if init == "kmeans++":
            centroids = _kmeanspp_init(gen, sub, k)
        else:
            centroids = sub[torch.randperm(sub.shape[0], generator=gen,
                                           device=dev)[:k]]

    weights = X.new_ones((k,))
    counts = X.new_zeros((k,))
    labels = torch.zeros((n,), dtype=torch.int32, device=dev)
    inertia = float("inf")
    it = 0
    for it in range(1, max_iter + 1):
        if balanced and balance_alpha > 0.0:
            weights = _balance_weights(counts, balance_alpha)
        labels, ine, sums, counts = _assign_sweep(X, centroids, weights, k)
        centroids = torch.where(counts[:, None] > 0,
                                sums / counts[:, None].clamp_min(1.0),
                                centroids)
        ine = float(ine)
        if inertia != float("inf") and ine >= inertia * (1.0 - tol):
            inertia = min(inertia, ine)
            break
        inertia = ine
    return KMeansResult(centroids, labels, inertia, it,
                        counts.to(torch.int32))


def kmeans_predict(res, centroids, X):
    """Nearest-centroid labels (the ``fused_l2_nn_argmin`` sweep; balance
    weights are a training bias only)."""
    from raft_tpu_torch.distance.fused_l2nn import fused_l2_nn_argmin

    res = ensure_resources(res)
    dev = X.device if isinstance(X, torch.Tensor) else res.device
    X, centroids = as_f32(X, dev), as_f32(centroids, dev)
    expects(X.shape[1] == centroids.shape[1],
            "kmeans_predict: dim mismatch %d != %d", X.shape[1],
            centroids.shape[1])
    _, labels = fused_l2_nn_argmin(res, X, centroids)
    return labels


def kmeans_inertia(res, centroids, X, labels=None) -> float:
    """True d2 inertia of a labeling (the argmin sweep's when ``labels``
    is None)."""
    from raft_tpu_torch.distance.fused_l2nn import fused_l2_nn_argmin

    res = ensure_resources(res)
    dev = X.device if isinstance(X, torch.Tensor) else res.device
    X, centroids = as_f32(X, dev), as_f32(centroids, dev)
    if labels is None:
        d2, _ = fused_l2_nn_argmin(res, X, centroids)
        return float(d2.sum())
    diff = X - centroids[torch.as_tensor(labels, device=dev).long()]
    return float((diff * diff).sum())
