"""Nearest-neighbors estimator of the port (counterpart of
``raft_tpu/models/knn.py``): brute force over the certified fused KNN
(``distance.knn``, K1 on a card; BASELINE config 2's path), or an IVF-Flat
or IVF-PQ index (``ann``, K4 / K5 on a card).

The mesh and the sharded planes (``mesh``, ``n_shards``) raise naming
ROADMAP item 7. ``merge`` is kept for the reference's signature; only the
sharded planes read it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import not_ported
from raft_tpu_torch.core.resources import (DeviceResources, as_f32,
                                           device_resources, input_device)
from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.distance.fused_l2nn import knn as _knn

_KERNEL_METRIC = {"sqeuclidean": "l2", "euclidean": "l2", "l2": "l2",
                  "inner_product": "ip"}


class NearestNeighbors:
    """``algorithm``: ``"brute"`` (default), ``"ivf_flat"`` (a balanced
    k-means coarse quantizer over ``n_lists`` padded lists, ``n_probes``
    probed a query; ``n_probes = n_lists`` is exact, the degenerate-exact
    invariant) or ``"ivf_pq"`` (``pq_dim`` subspaces of ``pq_bits``-bit
    codes over the same lists, every candidate rescored exactly). The IVF
    planes serve the L2 family only. ``res`` fixes the device of numpy
    input; without it the estimator runs where X's tensor lies, or on
    cuda."""

    def __init__(self, n_neighbors: int = 5, metric: str = "sqeuclidean",
                 mesh=None, mesh_axis: str = "x",
                 n_shards: Optional[int] = None, merge: str = "auto",
                 algorithm: str = "brute", n_lists: Optional[int] = None,
                 n_probes: Optional[int] = None,
                 pq_dim: Optional[int] = None,
                 pq_bits: Optional[int] = None,
                 res: Optional[DeviceResources] = None):
        if algorithm not in ("brute", "ivf_flat", "ivf_pq"):
            raise ValueError(
                f"NearestNeighbors: algorithm must be 'brute', "
                f"'ivf_flat' or 'ivf_pq', got {algorithm!r}")
        if algorithm in ("ivf_flat", "ivf_pq") and metric not in (
                "sqeuclidean", "euclidean", "l2"):
            raise ValueError(
                f"NearestNeighbors: algorithm={algorithm!r} serves "
                f"the L2 family only, got metric={metric!r}")
        if algorithm == "ivf_pq" and n_shards is not None:
            raise ValueError(
                "NearestNeighbors: algorithm='ivf_pq' is single-device"
                " (shard the flat tier via algorithm='ivf_flat')")
        if mesh is not None:
            not_ported("NearestNeighbors: mesh=")
        if n_shards is not None:
            not_ported("NearestNeighbors: n_shards=")
        self.res = res
        self.n_neighbors = n_neighbors
        self.metric = metric
        self.mesh_axis = mesh_axis
        self.merge = merge
        self.algorithm = algorithm
        self.n_lists = n_lists
        self.n_probes = n_probes
        self.pq_dim = pq_dim
        self.pq_bits = pq_bits
        self._index = None
        self._prepared = None
        self._handle = None

    def fit(self, X) -> "NearestNeighbors":
        dev = input_device(self.res, X)
        self._handle = self.res if self.res is not None else (
            device_resources() if dev.type == "cuda"
            else DeviceResources(device=dev))
        X = as_f32(X, dev)
        self._n_index = X.shape[0]
        self._prepared = None
        if self.algorithm in ("ivf_flat", "ivf_pq"):
            n_lists = self.n_lists or max(
                1, min(1024, int(round(X.shape[0] ** 0.5))))
            if self.algorithm == "ivf_pq":
                from raft_tpu_torch.ann import build_ivf_pq

                self._index = build_ivf_pq(
                    self._handle, X, n_lists=n_lists, pq_dim=self.pq_dim,
                    pq_bits=self.pq_bits, n_probes=self.n_probes)
            else:
                from raft_tpu_torch.ann import build_ivf_flat

                self._index = build_ivf_flat(self._handle, X,
                                             n_lists=n_lists,
                                             n_probes=self.n_probes)
            return self
        self._index = X
        # the build/query split: where knn would take the fused pipeline,
        # prepare its index operands once (their row-padded f32 copy holds
        # X, so X itself is not kept)
        from raft_tpu_torch.distance.knn_fused import (fused_eligible,
                                                       prepare_knn_index)

        kernel_metric = _KERNEL_METRIC.get(self.metric)
        if kernel_metric is not None and fused_eligible(*X.shape, dev):
            self._prepared = prepare_knn_index(X, metric=kernel_metric)
            self._index = None
        return self

    @property
    def _index_matrix(self) -> torch.Tensor:
        if self._index is not None:
            return self._index
        p = self._prepared
        return p.yp[:p.n_rows, :p.d_orig]

    def kneighbors(self, queries, n_neighbors: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(distances [nq, k], ids [nq, k] int32), nearest first."""
        k = n_neighbors or self.n_neighbors
        if self.algorithm in ("ivf_flat", "ivf_pq"):
            if self.algorithm == "ivf_pq":
                from raft_tpu_torch.ann import search_ivf_pq as search
            else:
                from raft_tpu_torch.ann import search_ivf_flat as search
            dists, idx = search(self._handle, self._index, queries, k,
                                n_probes=self.n_probes)
            if self.metric in ("euclidean", "l2"):
                dists = dists.clamp_min(0.0).sqrt()
            return dists, idx
        if self._prepared is not None and k <= self._prepared.n_rows:
            try:
                return _knn(self._handle, self._prepared, queries, k,
                            metric=self.metric)
            except NotImplementedError:
                pass   # a k off the fused envelope: the matrix's dispatch
        return _knn(self._handle, self._index_matrix, queries, k,
                    metric=self.metric)

    def kneighbors_graph(self, queries) -> CSRMatrix:
        """The KNN as a CSR adjacency [nq, n_index] (for spectral
        embedding pipelines)."""
        d, i = self.kneighbors(queries)
        nq, k = i.shape
        indptr = torch.arange(nq + 1, dtype=torch.int32,
                              device=i.device) * k
        return CSRMatrix(indptr, i.reshape(-1), d.reshape(-1),
                         (nq, self._n_index))
