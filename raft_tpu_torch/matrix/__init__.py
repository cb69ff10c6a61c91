"""raft_tpu_torch.matrix — batched top-k selection of the port."""

from raft_tpu_torch.matrix.select_k import choose_select_k_algorithm, select_k
from raft_tpu_torch.matrix.select_k_chunked import (chunked_envelope,
                                                    select_k_chunked)
from raft_tpu_torch.matrix.select_k_slotted import (select_k_slotted,
                                                    slotted_envelope)
from raft_tpu_torch.matrix.select_k_types import (SelectAlgo,
                                                  f32_comparable_keys)

__all__ = ["select_k", "choose_select_k_algorithm", "SelectAlgo",
           "select_k_slotted", "slotted_envelope", "select_k_chunked",
           "chunked_envelope", "f32_comparable_keys"]
