"""raft_tpu_torch.ops — hand-written Hopper kernels of the port, each with
its plain PyTorch twin in the same module (CUDA sources under ``csrc/``,
built by ``_build`` at first use)."""

from raft_tpu_torch.ops.folds import fold_group_top2
from raft_tpu_torch.ops.fine_scan import (
    fine_scan_list_major,
    fine_scan_list_major_q8,
    fine_scan_list_major_q8_ref,
    fine_scan_list_major_ref,
)
from raft_tpu_torch.ops.fused_l2_topk import (
    fused_l2_group_topk,
    fused_l2_group_topk_dchunk,
    fused_l2_group_topk_dchunk_ref,
    fused_l2_group_topk_packed,
    fused_l2_group_topk_packed_dchunk,
    fused_l2_group_topk_packed_dchunk_ref,
    fused_l2_group_topk_packed_q8,
    fused_l2_group_topk_packed_q8_ref,
    fused_l2_group_topk_packed_ref,
    fused_l2_group_topk_ref,
    fused_l2_slot_topk,
    fused_l2_slot_topk_dchunk,
    fused_l2_slot_topk_dchunk_ref,
    fused_l2_slot_topk_ref,
    split_hi_lo,
)
from raft_tpu_torch.ops.histogram import (
    histogram_blocked,
    histogram_blocked_ref,
)
from raft_tpu_torch.ops.lap_jv import lap_jv_solve, lap_jv_solve_ref
from raft_tpu_torch.ops.pq_scan import (
    pq_scan_list_major,
    pq_scan_list_major_ref,
)
from raft_tpu_torch.ops.select_slotted import (
    select_slot_topk_packed,
    select_slot_topk_packed_ref,
)
from raft_tpu_torch.ops.sddmm import (
    sddmm_csr,
    sddmm_csr_ref,
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
from raft_tpu_torch.ops.unexpanded import (
    unexpanded_pairwise_tiled,
    unexpanded_pairwise_tiled_ref,
)

__all__ = ["fine_scan_list_major", "fine_scan_list_major_q8",
           "fine_scan_list_major_q8_ref", "fine_scan_list_major_ref",
           "fold_group_top2", "fused_l2_group_topk",
           "fused_l2_group_topk_dchunk", "fused_l2_group_topk_dchunk_ref",
           "fused_l2_group_topk_packed_dchunk",
           "fused_l2_group_topk_packed_dchunk_ref",
           "fused_l2_group_topk_ref", "fused_l2_slot_topk",
           "fused_l2_slot_topk_dchunk", "fused_l2_slot_topk_dchunk_ref",
           "fused_l2_slot_topk_ref", "select_slot_topk_packed",
           "select_slot_topk_packed_ref",
           "fused_l2_group_topk_packed", "fused_l2_group_topk_packed_q8",
           "fused_l2_group_topk_packed_q8_ref",
           "fused_l2_group_topk_packed_ref", "histogram_blocked",
           "histogram_blocked_ref", "lap_jv_solve", "lap_jv_solve_ref",
           "pq_scan_list_major",
           "pq_scan_list_major_ref",
           "sddmm_csr", "sddmm_csr_ref", "sddmm_entries",
           "sddmm_entries_ref", "sddmm_tiled",
           "sddmm_tiled_ref", "spmm_tiled", "spmm_tiled_ref",
           "spmv_pair_tiled", "spmv_pair_tiled_ref", "spmv_tiled",
           "spmv_tiled_ref", "split_hi_lo", "unexpanded_pairwise_tiled",
           "unexpanded_pairwise_tiled_ref"]
