"""raft_tpu_torch.linalg — shared linalg types of the port (the dense
routines come in a later slice)."""

from raft_tpu_torch.linalg.types import NormType

__all__ = ["NormType"]
