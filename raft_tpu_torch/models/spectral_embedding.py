"""Spectral embedding estimator of the port — the BASELINE config-4
pipeline (graph Laplacian + Lanczos) as a model (counterpart of
``raft_tpu/models/spectral_embedding.py``)."""

from __future__ import annotations

from typing import Optional, Union

from raft_tpu_torch.core.resources import DeviceResources
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.spectral.analysis import fit_embedding


class SpectralEmbedding:
    """``res`` (optional) fixes the device; without it a fit runs where
    the adjacency's tensors lie, or on cuda. ``tiled`` and ``jit_loop``
    as in :func:`raft_tpu_torch.spectral.fit_embedding`; ``mesh`` shards
    the Laplacian's rows over ``mesh[mesh_axis]`` (the multi-device
    fit)."""

    def __init__(self, n_components: int = 2, normalized: bool = True,
                 drop_first: bool = True, ncv: Optional[int] = None,
                 tolerance: float = 1e-5, max_iterations: int = 2000,
                 seed: int = 42, jit_loop=None, tiled="auto",
                 mesh=None, mesh_axis: str = "x",
                 res: Optional[DeviceResources] = None):
        self.res = res
        self.n_components = n_components
        self.normalized = normalized
        self.drop_first = drop_first
        self.ncv = ncv
        self.tolerance = tolerance
        self.max_iterations = max_iterations
        self.seed = seed
        self.jit_loop = jit_loop
        self.tiled = tiled
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.eigenvalues_ = None
        self.embedding_ = None

    def fit(self, adjacency: Union[COOMatrix, CSRMatrix]
            ) -> "SpectralEmbedding":
        vals, emb = fit_embedding(
            self.res, adjacency, self.n_components, ncv=self.ncv,
            tolerance=self.tolerance, max_iterations=self.max_iterations,
            seed=self.seed, drop_first=self.drop_first,
            normalized=self.normalized, jit_loop=self.jit_loop,
            tiled=self.tiled, mesh=self.mesh, mesh_axis=self.mesh_axis)
        self.eigenvalues_ = vals
        self.embedding_ = emb
        return self

    def fit_transform(self, adjacency):
        return self.fit(adjacency).embedding_
