"""raft_tpu_torch.random — dataset generators of the port."""

from raft_tpu_torch.random.make_blobs import make_blobs

__all__ = ["make_blobs"]
