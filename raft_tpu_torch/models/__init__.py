"""raft_tpu_torch.models — estimators of the port (spectral embedding so
far)."""

from raft_tpu_torch.models.spectral_embedding import SpectralEmbedding

__all__ = ["SpectralEmbedding"]
