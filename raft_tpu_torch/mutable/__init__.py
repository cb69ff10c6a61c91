"""raft_tpu_torch.mutable — the index layout of the port (the mutable
index, its WAL and checkpoints come in a later slice)."""

from raft_tpu_torch.mutable.layout import (
    IndexLayout,
    fused_ops_for_layout,
    quantize_layout,
    ragged_layout_from_lists,
)

__all__ = ["IndexLayout", "fused_ops_for_layout", "quantize_layout",
           "ragged_layout_from_lists"]
