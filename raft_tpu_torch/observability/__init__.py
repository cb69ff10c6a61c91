"""raft_tpu_torch.observability — the operations planes of the port.

Counterpart of ``raft_tpu/observability``:

- :class:`MetricsRegistry` — counters / gauges / fixed-bucket
  histograms, thread-safe, with a disabled mode whose fast path is a
  no-op attribute lookup (:data:`NULL_METRIC`); names are the
  reference's ``raft_tpu_*``.
- :func:`span` / :func:`instrument` — tracing on the
  :mod:`raft_tpu_torch.core.nvtx` range stack (NVTX ranges on the card).
- the flight recorder (:mod:`~raft_tpu_torch.observability.flight`) and
  its typed emitters (:mod:`~raft_tpu_torch.observability.timeline`),
  exported as Perfetto JSON, and the model-vs-measured
  :class:`DriftLedger` (``RAFT_TPU_DRIFT_LEDGER``).
- hooks (:mod:`~raft_tpu_torch.observability.hooks`) — comms
  collectives, the kernel library cache, ``core.memory.MemoryTracker``
  and ``benchmark.Fixture`` results report in under the reference's
  names.
- exporters — Prometheus text, JSON lines, a summary table.
- the quality plane (certificate counters, :class:`ShadowSampler`), the
  per-query explain plane, windowed aggregation and the SLO burn-rate
  engine, the crash-durable blackbox and the hang watchdog — all served
  live by :class:`raft_tpu_torch.tools.debugz.DebugzServer`.
- the cost model (:mod:`~raft_tpu_torch.observability.costmodel`):
  cost records, the roofline and its report, each kernel's analytic
  work (``kernel_cost``), and the models the IVF choosers and the
  sharded merge read; :class:`Profiler` is the ``res.profiler`` slot
  (:mod:`~raft_tpu_torch.observability.profiler`, with a
  ``torch.profiler`` trace window).

``RAFT_TPU_DISABLE_TRACING`` disables ranges, spans, metrics and the
flight recorder; :func:`disable` does so at run time.
"""

from raft_tpu_torch.observability.metrics import (
    COMPILE_TIME_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    NULL_METRIC,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    bucket_percentile,
    disable,
    enable,
    get_registry,
    percentile,
    set_registry,
    tracing_enabled,
)
from raft_tpu_torch.observability.flight import (
    KNOWN_EVENT_KINDS,
    NULL_FLIGHT,
    FlightRecorder,
    disable_flight,
    enable_flight,
    flight_enabled,
    get_flight_recorder,
    post_mortem,
    set_flight_recorder,
)
from raft_tpu_torch.observability.timeline import (
    DRIFT_BAND,
    DriftLedger,
    emit_marker,
    get_drift_ledger,
    record_drift,
    set_drift_ledger,
)
from raft_tpu_torch.observability.spans import instrument, span, tree_nbytes
from raft_tpu_torch.observability.hooks import (
    record_alloc,
    record_benchmark,
    record_cache,
    record_collective,
    record_free,
)
from raft_tpu_torch.observability.exporters import (
    bench_results,
    export_jsonl,
    export_perfetto,
    export_prometheus,
    summary_table,
)
from raft_tpu_torch.observability.costmodel import (
    CostRecord,
    RooflineEstimate,
    classify,
    kernel_cost,
    roofline,
    roofline_report,
    DB_DTYPE_BYTES,
    FINE_SCAN_MARGIN,
    MERGE_STRATEGIES,
    PQ_SCAN_MARGIN,
    choose_fine_scan,
    choose_merge_strategy,
    choose_pq_scan,
    ici_time_model,
    ici_traffic_model,
    ivf_traffic_model,
    pq_bytes_ratio,
    pq_index_bytes,
)
from raft_tpu_torch.observability.profiler import (
    Profiler,
    get_profiler,
    set_profiler,
)
from raft_tpu_torch.observability.quality import (
    ShadowSampler,
    certificate_counts,
    measured_rerun_frac,
    quality_block,
    quality_enabled,
    recall_at_k,
    record_certificate,
    record_pending,
    record_pq_rungs,
)
from raft_tpu_torch.observability.explain import (
    clear_records,
    explain_records,
)
from raft_tpu_torch.observability.windows import MetricWindows
from raft_tpu_torch.observability.slo import (
    BurnWindow,
    SloEngine,
    SloObjective,
    default_objectives,
)
from raft_tpu_torch.observability.blackbox import BlackBox, reconstruct
from raft_tpu_torch.observability.watchdog import (
    Watchdog,
    dump_stacks,
    format_stacks,
)


def reset() -> None:
    """Clear the process-global registry (metrics and events), the
    flight-recorder ring, the explain ring and the quality plane's
    pending records and counters."""
    from raft_tpu_torch.observability import quality as _quality

    get_registry().reset()
    get_flight_recorder().clear()
    clear_records()
    _quality.clear()


__all__ = [
    "COMPILE_TIME_BUCKETS", "DEFAULT_TIME_BUCKETS", "NULL_METRIC",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "bucket_percentile", "disable", "enable", "get_registry", "percentile",
    "set_registry", "tracing_enabled",
    "KNOWN_EVENT_KINDS", "NULL_FLIGHT", "FlightRecorder", "disable_flight",
    "enable_flight", "flight_enabled", "get_flight_recorder", "post_mortem",
    "set_flight_recorder", "emit_marker",
    "DRIFT_BAND", "DriftLedger", "get_drift_ledger", "record_drift",
    "set_drift_ledger",
    "record_alloc", "record_benchmark", "record_cache", "record_collective",
    "record_free",
    "CostRecord", "RooflineEstimate", "classify", "kernel_cost", "roofline",
    "roofline_report", "Profiler", "get_profiler", "set_profiler",
    "instrument", "span", "tree_nbytes",
    "bench_results", "export_jsonl", "export_perfetto", "export_prometheus",
    "summary_table",
    "DB_DTYPE_BYTES", "FINE_SCAN_MARGIN", "PQ_SCAN_MARGIN",
    "MERGE_STRATEGIES", "choose_fine_scan", "choose_merge_strategy",
    "choose_pq_scan", "ici_time_model", "ici_traffic_model",
    "ivf_traffic_model",
    "pq_bytes_ratio", "pq_index_bytes",
    "ShadowSampler", "certificate_counts", "measured_rerun_frac",
    "quality_block", "quality_enabled", "recall_at_k", "record_certificate",
    "record_pending", "record_pq_rungs",
    "clear_records", "explain_records",
    "MetricWindows", "BurnWindow", "SloEngine", "SloObjective",
    "default_objectives",
    "BlackBox", "reconstruct",
    "Watchdog", "dump_stacks", "format_stacks",
    "reset",
]
