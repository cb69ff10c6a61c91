"""raft_tpu_torch.observability — the cost model the IVF choosers read
and the certificate counters of the IVF-PQ ladder (the metrics, tracing
and flight planes are not ported)."""

from raft_tpu_torch.observability.costmodel import (
    DB_DTYPE_BYTES,
    FINE_SCAN_MARGIN,
    PQ_SCAN_MARGIN,
    choose_fine_scan,
    choose_pq_scan,
    ivf_traffic_model,
    pq_bytes_ratio,
    pq_index_bytes,
)
from raft_tpu_torch.observability.quality import (
    certificate_counts,
    measured_rerun_frac,
    record_certificate,
    record_pq_rungs,
)

__all__ = ["DB_DTYPE_BYTES", "FINE_SCAN_MARGIN", "PQ_SCAN_MARGIN",
           "certificate_counts", "choose_fine_scan", "choose_pq_scan",
           "ivf_traffic_model", "measured_rerun_frac", "pq_bytes_ratio",
           "pq_index_bytes", "record_certificate", "record_pq_rungs"]
