"""raft_tpu_torch.ann — IVF-Flat of the port (build, query-major and
list-major search, the degenerate-exact plane)."""

from raft_tpu_torch.ann.ivf_flat import (
    IvfFlatIndex,
    build_ivf_flat,
    build_list_schedule,
    resolve_fine_scan,
    search_ivf_flat,
)

__all__ = ["IvfFlatIndex", "build_ivf_flat", "build_list_schedule",
           "resolve_fine_scan", "search_ivf_flat"]
