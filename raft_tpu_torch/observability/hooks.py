"""Reporting hooks the rest of the port calls into.

Counterpart of ``raft_tpu/observability/hooks.py``: one small function
an instrumented subsystem, so call sites stay a single line and the
metric names (the reference's) live in one place:

- comms      → :func:`record_collective`  (``comms.comms.MeshComms``)
- kernels    → :func:`record_cache`       (``ops._build.load``)
- memory     → :func:`record_alloc` / :func:`record_free`
  (``core.memory.MemoryTracker``)
- benchmarks → :func:`record_benchmark`   (``benchmark.Fixture.run``)

Two counts differ from the reference's by design. ``record_collective``
counts a call: each ``MeshComms`` collective reports once a call, where
the reference counts once a traced program (the port traces nothing).
``record_cache`` counts the kernel library cache of ``ops._build.load``:
a hit when the library is already loaded or built, a miss when ``nvcc``
runs, the port's counterpart of the compile cache. The metrics keep the
reference's names and help text, so the exposition reads the same.

Every hook is a no-op after one ``enabled`` check when tracing is
disabled, and none of them may raise into the hot path.
"""

from __future__ import annotations

from typing import Dict, Optional

from raft_tpu_torch.observability.metrics import get_registry
from raft_tpu_torch.observability.timeline import (emit_benchmark,
                                             emit_collective,
                                             emit_compile)

COMMS_CALLS = "raft_tpu_comms_calls_total"
COMMS_BYTES = "raft_tpu_comms_bytes_total"
CACHE_HITS = "raft_tpu_compile_cache_hits_total"
CACHE_MISSES = "raft_tpu_compile_cache_misses_total"
MEM_ALLOC_CALLS = "raft_tpu_memory_alloc_total"
MEM_ALLOC_BYTES = "raft_tpu_memory_alloc_bytes_total"
MEM_FREE_CALLS = "raft_tpu_memory_free_total"
MEM_CURRENT = "raft_tpu_memory_current_bytes"
MEM_PEAK = "raft_tpu_memory_peak_bytes"
BENCH_SECONDS = "raft_tpu_benchmark_seconds"
BENCH_RUNS = "raft_tpu_benchmark_runs_total"


def record_collective(collective: str, x, axis_name: str = "") -> None:
    """Count one collective call and its payload bytes (a rank's block:
    ``x`` is a tensor or an array). Called once a
    collective call, so a count is a call (the reference counts once a
    traced program); the help text is the reference's."""
    reg = get_registry()
    if not reg.enabled:
        return
    labels = {"collective": collective, "axis": str(axis_name)}
    reg.counter(COMMS_CALLS, labels,
                help="Collective invocations (counted at trace time)").inc()
    n = _nbytes(x)
    if isinstance(n, int):
        reg.counter(COMMS_BYTES, labels,
                    help="Per-shard payload bytes entering collectives"
                    ).inc(n)
    emit_collective(collective, n if isinstance(n, int) else 0,
                    str(axis_name))


def _nbytes(x) -> Optional[int]:
    """Payload bytes of a tensor or an array; None for anything else."""
    nelement = getattr(x, "nelement", None)
    if callable(nelement):                      # torch.Tensor
        return int(nelement()) * int(x.element_size())
    n = getattr(x, "nbytes", None)
    return n if isinstance(n, int) else None


def record_cache(hit: bool) -> None:
    """Kernel-library cache hit/miss accounting (``ops._build.load``)."""
    reg = get_registry()
    if not reg.enabled:
        return
    if hit:
        reg.counter(CACHE_HITS, help="CompileCache lookups served from "
                                     "an already-compiled executable").inc()
    else:
        reg.counter(CACHE_MISSES, help="CompileCache lookups that paid a "
                                       "compilation").inc()
    emit_compile("compile_cache", hit=hit)


def record_alloc(nbytes: int, current_bytes: int, peak_bytes: int) -> None:
    """MemoryTracker.allocate bridge: counters + live/peak gauges."""
    reg = get_registry()
    if not reg.enabled:
        return
    reg.counter(MEM_ALLOC_CALLS, help="Logical allocations through "
                                      "MemoryTracker").inc()
    reg.counter(MEM_ALLOC_BYTES, help="Logical bytes allocated through "
                                      "MemoryTracker").inc(max(0, nbytes))
    reg.gauge(MEM_CURRENT, help="Live logical bytes (MemoryTracker)"
              ).set(current_bytes)
    reg.gauge(MEM_PEAK, help="Peak logical bytes (MemoryTracker)"
              ).set(peak_bytes)


def record_free(nbytes: int, current_bytes: int) -> None:
    """MemoryTracker.deallocate bridge."""
    reg = get_registry()
    if not reg.enabled:
        return
    reg.counter(MEM_FREE_CALLS, help="Logical deallocations through "
                                     "MemoryTracker").inc()
    reg.gauge(MEM_CURRENT, help="Live logical bytes (MemoryTracker)"
              ).set(current_bytes)


def record_benchmark(name: str, result: Dict[str, float],
                     nbytes: Optional[float] = None) -> None:
    """Benchmark result → registry: ``Fixture.run`` calls this with its
    ``seconds`` (device time between CUDA events on the card, unlike the
    dispatch time spans record)."""
    reg = get_registry()
    if not reg.enabled:
        return
    labels = {"bench": name}
    reg.histogram(BENCH_SECONDS, labels,
                  help="RTT-corrected execute seconds from benchmark."
                       "Fixture.run").observe(result.get("seconds", 0.0))
    reg.counter(BENCH_RUNS, labels, help="Fixture.run invocations").inc()
    event = {"type": "benchmark", "bench": name}
    event.update({k: v for k, v in result.items()})
    if nbytes is not None:
        event["nbytes"] = nbytes
    reg.emit(event)
    emit_benchmark(name, float(result.get("seconds", 0.0)))
