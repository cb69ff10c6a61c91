"""Partition / modularity analysis and spectral embedding of the port.

(Counterpart of ``raft_tpu/spectral/analysis.py``; ref: cpp/include/raft/
spectral/partition.cuh:38 ``analyzePartition``,
modularity_maximization.cuh:31 ``analyzeModularity``, and the BASELINE
"spectral embedding" pipeline: graph Laplacian + Lanczos.)
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix, to_device
from raft_tpu_torch.spectral.matrix_wrappers import (LaplacianMatrix,
                                                     ModularityMatrix)

Sparse = Union[COOMatrix, CSRMatrix]

#: ``tiled="auto"`` takes the K6a path on cuda from this many Laplacian
#: nonzeros up (the reference's TPU threshold, ``analysis.py:109``)
TILED_MIN_NNZ = 200_000


def _clusters(clusters, device, n_clusters: int):
    c = torch.as_tensor(clusters).to(device)
    return [(c == i) for i in range(n_clusters)]


def analyze_partition(res, A: Sparse, n_clusters: int, clusters
                      ) -> Tuple[float, float]:
    """(edge_cut, cost), cost = Σ_i cut(i)/|cluster_i|.
    (ref: spectral/partition.cuh:38 ``analyzePartition``)"""
    L = LaplacianMatrix(res, A)
    dtype = L.diagonal.dtype
    edge_cut = torch.zeros((), dtype=dtype, device=L.diagonal.device)
    cost = edge_cut.clone()
    for member in _clusters(clusters, L.diagonal.device, n_clusters):
        w = member.to(dtype)
        size = w.sum()
        part_cut = torch.dot(w, L.mv(w))
        nonempty = size > 0
        cost = cost + torch.where(
            nonempty, part_cut / torch.where(nonempty, size, 1.0), 0.0)
        edge_cut = edge_cut + torch.where(nonempty, part_cut / 2.0, 0.0)
    return float(edge_cut), float(cost)


def analyze_modularity(res, A: Sparse, n_clusters: int, clusters) -> float:
    """Modularity = Σ_i w_iᵀ B w_i / ‖d‖₁.
    (ref: modularity_maximization.cuh:31 ``analyzeModularity``)"""
    B = ModularityMatrix(res, A)
    dtype = B.degree.dtype
    total = torch.zeros((), dtype=dtype, device=B.degree.device)
    for member in _clusters(clusters, B.degree.device, n_clusters):
        w = member.to(dtype)
        total = total + torch.dot(w, B.mv(w))
    return float(total / B.edge_sum)


def fit_embedding(res, A: Sparse, n_components: int, ncv=None,
                  tolerance: float = 1e-5, max_iterations: int = 2000,
                  seed: int = 42, drop_first: bool = True,
                  normalized: bool = True, jit_loop=None,
                  tiled="auto", mesh=None, mesh_axis: str = "x"):
    """Spectral embedding: the smallest eigenvectors of the graph
    Laplacian, (eigenvalues, embedding [n, n_components]) — the BASELINE
    config-4 pipeline.

    It runs on the handle's device when ``res`` is given, else on the
    adjacency's, else on cuda. ``tiled``: "auto" lays the Laplacian out as
    a ``TiledELL`` (K6a runs every Lanczos matvec) on cuda for f32
    matrices of ≥ :data:`TILED_MIN_NNZ` nonzeros; True/False force
    either path. ``mesh`` makes the solve multi-device (reference
    ``:93-104``): the Laplacian's rows shard over ``mesh[mesh_axis]``
    (``sparse.sharded.shard_spmv_operand``) and every matvec runs K6a on
    each row block; f32 only, and ``tiled=False`` conflicts with it."""
    from raft_tpu_torch.sparse.linalg import (compute_graph_laplacian,
                                              laplacian_normalized,
                                              prepare_spmv)
    from raft_tpu_torch.sparse.solver.lanczos import \
        lanczos_compute_eigenpairs
    from raft_tpu_torch.sparse.solver.lanczos_types import (
        LANCZOS_WHICH, LanczosSolverConfig)

    if tiled not in ("auto", True, False):
        raise ValueError(f"fit_embedding: tiled must be 'auto', True or "
                         f"False, got {tiled!r}")
    if mesh is not None and tiled is False:
        raise ValueError(
            "fit_embedding: tiled=False conflicts with mesh= — the "
            "multi-device path is the sharded tiled-ELL operand")
    A = to_device(A, res.device if res is not None else None)
    k = n_components + (1 if drop_first else 0)
    if normalized:
        L, _ = laplacian_normalized(res, A)
    else:
        L = compute_graph_laplacian(res, A)
    if mesh is not None:
        from raft_tpu_torch.sparse.sharded import shard_spmv_operand

        if L.values.dtype == torch.float64:
            raise ValueError(
                "fit_embedding: mesh= computes in f32 (tiled kernels); "
                "cast the input or drop mesh for the f64 CSR path")
        L = shard_spmv_operand(L, mesh, axis=mesh_axis)
    else:
        if tiled == "auto":
            tiled = (L.values.device.type == "cuda"
                     and L.nnz >= TILED_MIN_NNZ
                     and L.values.dtype == torch.float32)
        if tiled:
            L = prepare_spmv(L)
    config = LanczosSolverConfig(
        n_components=k, max_iterations=max_iterations, ncv=ncv,
        tolerance=tolerance, which=LANCZOS_WHICH.SA, seed=seed,
        jit_loop=jit_loop)
    vals, vecs = lanczos_compute_eigenpairs(res, L, config)
    if drop_first:
        return vals[1:], vecs[:, 1:]
    return vals, vecs
