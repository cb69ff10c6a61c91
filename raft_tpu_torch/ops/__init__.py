"""raft_tpu_torch.ops — hand-written Hopper kernels of the port, each with
its plain PyTorch twin in the same module (CUDA sources under ``csrc/``,
built by ``_build`` at first use)."""

from raft_tpu_torch.ops.fused_l2_topk import (
    fused_l2_group_topk_packed,
    fused_l2_group_topk_packed_ref,
    split_hi_lo,
)

__all__ = ["fused_l2_group_topk_packed", "fused_l2_group_topk_packed_ref",
           "split_hi_lo"]
