"""KMeans estimator of the port — the sklearn-shaped wrapper over
:mod:`raft_tpu_torch.cluster` (counterpart of
``raft_tpu/models/kmeans.py``; ref: kmeans.cuh's fit/predict surface as
cuML's KMeans consumes it)."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import (DeviceResources, as_f32,
                                           resolve_device)


class KMeans:
    """scikit-learn-compatible k-means.

    ``balanced=True`` takes the balanced variant (a per-iteration
    cluster-size penalty, the IVF coarse trainer). ``res`` fixes the
    device of ``predict`` and of numpy inputs; without it a fit runs
    where X's tensors lie, or on cuda. Attributes after ``fit``:
    ``cluster_centers_``, ``labels_``, ``inertia_``, ``n_iter_``."""

    def __init__(self, n_clusters: int = 8, max_iter: int = 300,
                 tol: float = 1e-4, random_state: int = 0,
                 balanced: bool = False, init: str = "kmeans++",
                 n_init: int = 3, res: Optional[DeviceResources] = None):
        self.res = res
        self.n_clusters = int(n_clusters)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.random_state = int(random_state)
        self.balanced = bool(balanced)
        self.init = init
        self.n_init = int(n_init)
        self.cluster_centers_ = None
        self.labels_ = None
        self.inertia_ = None
        self.n_iter_ = None

    @classmethod
    def from_numpy(cls, arrays: dict, device=None, **params) -> "KMeans":
        """A fitted estimator from the reference estimator's attributes
        as numpy: ``cluster_centers_`` and optionally ``labels_``,
        ``inertia_``, ``n_iter_``; ``params`` are constructor arguments.
        Its ``predict``/``transform`` then use those centers."""
        dev = resolve_device(device)
        params.setdefault("res", DeviceResources(device=dev))
        centers = as_f32(np.asarray(arrays["cluster_centers_"]), dev)
        est = cls(n_clusters=centers.shape[0], **params)
        est.cluster_centers_ = centers
        if arrays.get("labels_") is not None:
            est.labels_ = torch.from_numpy(
                np.array(arrays["labels_"], np.int32)).to(dev)
        if arrays.get("inertia_") is not None:
            est.inertia_ = float(arrays["inertia_"])
        if arrays.get("n_iter_") is not None:
            est.n_iter_ = int(arrays["n_iter_"])
        return est

    def fit(self, X) -> "KMeans":
        from raft_tpu_torch.cluster import kmeans_fit

        r = kmeans_fit(self.res, X, self.n_clusters,
                       max_iter=self.max_iter, tol=self.tol,
                       seed=self.random_state, balanced=self.balanced,
                       init=self.init, n_init=self.n_init)
        self.cluster_centers_ = r.centroids
        self.labels_ = r.labels
        self.inertia_ = float(r.inertia)
        self.n_iter_ = int(r.n_iter)
        return self

    def _check_fitted(self, what: str):
        if self.cluster_centers_ is None:
            raise RuntimeError(f"KMeans: call fit() before {what}()")

    def predict(self, X):
        from raft_tpu_torch.cluster import kmeans_predict

        self._check_fitted("predict")
        return kmeans_predict(self.res, self.cluster_centers_, X)

    def fit_predict(self, X):
        return self.fit(X).labels_

    def transform(self, X):
        """Euclidean distances to each center (sklearn's convention)."""
        from raft_tpu_torch.distance.pairwise import pairwise_distance

        self._check_fitted("transform")
        c = self.cluster_centers_
        return pairwise_distance(self.res, as_f32(X, c.device), c,
                                 metric="euclidean")
