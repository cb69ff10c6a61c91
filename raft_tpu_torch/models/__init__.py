"""raft_tpu_torch.models — estimators of the port (k-means, spectral
embedding, PCA, truncated SVD)."""

from raft_tpu_torch.models.kmeans import KMeans
from raft_tpu_torch.models.pca import PCA
from raft_tpu_torch.models.spectral_embedding import SpectralEmbedding
from raft_tpu_torch.models.tsvd import TruncatedSVD

__all__ = ["KMeans", "PCA", "SpectralEmbedding", "TruncatedSVD"]
