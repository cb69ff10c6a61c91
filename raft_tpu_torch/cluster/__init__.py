"""raft_tpu_torch.cluster — balanced k-means of the port."""

from raft_tpu_torch.cluster.kmeans import (
    KMeansResult,
    kmeans_fit,
    kmeans_inertia,
    kmeans_predict,
)

__all__ = ["KMeansResult", "kmeans_fit", "kmeans_inertia", "kmeans_predict"]
