"""raft_tpu_torch — the PyTorch / CUDA port of raft_tpu for NVIDIA Hopper.

The package mirrors ``raft_tpu``'s module tree (``raft_tpu_torch/distance/
knn_fused.py`` is the counterpart of ``raft_tpu/distance/knn_fused.py``)
and is held against it by parity tests. It imports torch and numpy, never
jax and never raft_tpu. Each TPU Pallas kernel on a ported path becomes a
hand-written Hopper kernel under ``ops/csrc/``, with a plain PyTorch twin.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` or CPU tensors; without a card they raise.

Ported so far: certified fused brute-force KNN (``distance.knn``,
``prepare_knn_index``, ``knn_fused``) with its kernel K1, and its
int8-streamed index (``db_dtype="int8"``) with the kernel K2 — the
packed K1, its wide-feature (d-chunked) form and K2 on ``wgmma`` fed by
TMA through an ``mbarrier`` ring (``ops/csrc/fused_l2_packed_sm90.cu``),
K1's unpacked (past the packed-code envelope, groups split into
segments) and per-slot forms on ``mma.sync``
(``ops/csrc/fused_l2_topk.cu``); the
serving engine over it (``serving.ServingEngine``: micro-batching to a
bucket ladder, admission control, deadlines, snapshot swap; brute
bf16/int8, IVF-Flat and IVF-PQ planes) with its entry
``runtime.knn_query`` and the deadline scopes of ``resilience``; the
streamed sweeps, ``matrix.select_k`` under every ``SelectAlgo`` (the
slotted select kernel K3), ``random.make_blobs``, balanced k-means
(``cluster``) and IVF-Flat (``ann.build_ivf_flat`` / ``search_ivf_flat``)
with its list-major fine-scan kernel K4, IVF-PQ (``ann.build_ivf_pq`` /
``search_ivf_pq``) with its ADC scan kernel K5, and the sparse layer with
spectral embedding (``sparse``, ``spectral``,
``models.SpectralEmbedding``, ``random.rmat_rectangular_gen``): the tiled
layouts, the Lanczos solver, and the SpMV/SpMM kernel K6 and SDDMM
kernel K7; pairwise distances of all 19 metrics
(``distance.pairwise_distance``) with the unexpanded-metric kernel K8,
and ``stats`` (moments, histograms with the blocked kernel K9, clustering
and embedding metrics) with the ``models.KMeans`` estimator.
"""

from raft_tpu_torch import (ann, cluster, core, distance, linalg, matrix,
                            models, mutable, observability, ops, random,
                            resilience, runtime, serving, sparse, spectral,
                            stats)
from raft_tpu_torch.core import DeviceResources, device_resources

__version__ = "0.1.0"

__all__ = ["ann", "cluster", "core", "distance", "linalg", "matrix",
           "models", "mutable", "observability", "ops", "random",
           "resilience", "runtime", "serving", "sparse", "spectral",
           "stats", "DeviceResources", "device_resources", "__version__"]
