"""raft_tpu_torch.observability — the cost model the IVF fine-scan
crossover reads (the metrics, tracing and flight planes are not ported)."""

from raft_tpu_torch.observability.costmodel import (
    DB_DTYPE_BYTES,
    FINE_SCAN_MARGIN,
    choose_fine_scan,
    ivf_traffic_model,
)

__all__ = ["DB_DTYPE_BYTES", "FINE_SCAN_MARGIN", "choose_fine_scan",
           "ivf_traffic_model"]
