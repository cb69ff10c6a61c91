"""raft_tpu_torch.ann — IVF-Flat and IVF-PQ of the port (build, the
query-major and list-major searches, the ADC search with its certificate
ladder, the degenerate-exact plane)."""

from raft_tpu_torch.ann.ivf_flat import (
    DEFAULT_ROW_QUANTUM,
    FINE_SCANS,
    IvfFlatIndex,
    build_ivf_flat,
    build_list_schedule,
    resolve_fine_scan,
    search_ivf_flat,
)
from raft_tpu_torch.ann.ivf_pq import (
    PQ_SCANS,
    IvfPqIndex,
    build_ivf_pq,
    pack_pq_codes,
    resolve_pq_scan,
    search_ivf_pq,
    unpack_pq_codes,
    warm_pq_scan,
)

__all__ = ["DEFAULT_ROW_QUANTUM", "FINE_SCANS", "PQ_SCANS", "IvfFlatIndex",
           "IvfPqIndex", "build_ivf_flat", "build_ivf_pq",
           "build_list_schedule", "pack_pq_codes", "resolve_fine_scan",
           "resolve_pq_scan", "search_ivf_flat", "search_ivf_pq",
           "unpack_pq_codes", "warm_pq_scan"]
