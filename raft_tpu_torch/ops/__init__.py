"""raft_tpu_torch.ops — hand-written Hopper kernels of the port, each with
its plain PyTorch twin in the same module (CUDA sources under ``csrc/``,
built by ``_build`` at first use)."""

from raft_tpu_torch.ops.fine_scan import (
    fine_scan_list_major,
    fine_scan_list_major_q8,
    fine_scan_list_major_q8_ref,
    fine_scan_list_major_ref,
)
from raft_tpu_torch.ops.fused_l2_topk import (
    fused_l2_group_topk_packed,
    fused_l2_group_topk_packed_ref,
    split_hi_lo,
)

__all__ = ["fine_scan_list_major", "fine_scan_list_major_q8",
           "fine_scan_list_major_q8_ref", "fine_scan_list_major_ref",
           "fused_l2_group_topk_packed", "fused_l2_group_topk_packed_ref",
           "split_hi_lo"]
