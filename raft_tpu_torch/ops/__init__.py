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
from raft_tpu_torch.ops.sddmm import (
    sddmm_entries,
    sddmm_entries_ref,
    sddmm_tiled,
    sddmm_tiled_ref,
)
from raft_tpu_torch.ops.spmv import (
    spmm_tiled,
    spmm_tiled_ref,
    spmv_pair_tiled,
    spmv_pair_tiled_ref,
    spmv_tiled,
    spmv_tiled_ref,
)

__all__ = ["fine_scan_list_major", "fine_scan_list_major_q8",
           "fine_scan_list_major_q8_ref", "fine_scan_list_major_ref",
           "fused_l2_group_topk_packed", "fused_l2_group_topk_packed_ref",
           "sddmm_entries", "sddmm_entries_ref", "sddmm_tiled",
           "sddmm_tiled_ref", "spmm_tiled", "spmm_tiled_ref",
           "spmv_pair_tiled", "spmv_pair_tiled_ref", "spmv_tiled",
           "spmv_tiled_ref", "split_hi_lo"]
