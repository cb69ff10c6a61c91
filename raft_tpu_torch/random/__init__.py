"""raft_tpu_torch.random — dataset and graph generators of the port."""

from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.rmat import rmat_from_uniforms, rmat_rectangular_gen

__all__ = ["make_blobs", "rmat_from_uniforms", "rmat_rectangular_gen"]
