"""raft_tpu_torch.models — estimators of the port (k-means, spectral
embedding)."""

from raft_tpu_torch.models.kmeans import KMeans
from raft_tpu_torch.models.spectral_embedding import SpectralEmbedding

__all__ = ["KMeans", "SpectralEmbedding"]
