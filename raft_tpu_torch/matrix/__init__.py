"""raft_tpu_torch.matrix — batched top-k selection of the port."""

from raft_tpu_torch.matrix.select_k import choose_select_k_algorithm, select_k
from raft_tpu_torch.matrix.select_k_types import SelectAlgo

__all__ = ["select_k", "choose_select_k_algorithm", "SelectAlgo"]
