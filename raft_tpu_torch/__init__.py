"""raft_tpu_torch — the PyTorch / CUDA port of raft_tpu for NVIDIA Hopper.

The package mirrors ``raft_tpu``'s module tree (``raft_tpu_torch/distance/
knn_fused.py`` is the counterpart of ``raft_tpu/distance/knn_fused.py``)
and is held against it by parity tests. It imports torch and numpy, never
jax and never raft_tpu. Each TPU Pallas kernel on a ported path becomes a
hand-written Hopper kernel under ``ops/csrc/``, with a plain PyTorch twin.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` or CPU tensors; without a card they raise.

Ported so far: certified fused brute-force KNN (``distance.knn``,
``prepare_knn_index``, ``knn_fused``) with its kernel K1, the streamed
sweeps, ``matrix.select_k``, ``random.make_blobs``, balanced k-means
(``cluster``) and IVF-Flat (``ann.build_ivf_flat`` / ``search_ivf_flat``)
with its list-major fine-scan kernel K4.
"""

from raft_tpu_torch import (ann, cluster, core, distance, matrix, mutable,
                            observability, ops, random)
from raft_tpu_torch.core import DeviceResources, device_resources

__version__ = "0.1.0"

__all__ = ["ann", "cluster", "core", "distance", "matrix", "mutable",
           "observability", "ops", "random",
           "DeviceResources", "device_resources", "__version__"]
