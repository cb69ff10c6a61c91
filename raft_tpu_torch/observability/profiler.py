"""The ``res.profiler`` resource: cost records, the roofline, and traces.

Counterpart of ``raft_tpu/observability/profiler.py``. One
:class:`Profiler` a handle (the process-wide one unless a handle sets its
own, as ``res.metrics`` falls back): it holds the chip's peaks
(:func:`raft_tpu_torch.utils.arch.chip_spec`), keeps the latest
:class:`~raft_tpu_torch.observability.costmodel.CostRecord` an (entry,
shape signature), and publishes every capture into the metrics registry,
where the exporters and :func:`~raft_tpu_torch.observability.costmodel.
roofline_report` read it.

The reference asks XLA's cost analysis of a compiled executable for an
entry's work. PyTorch compiles nothing, so :meth:`Profiler.capture_fn`
takes, in this order: the record memoised for (entry, signature); the
entry's registered cost function (:meth:`Profiler.register_cost`), which
counts its kernel's work analytically with
:func:`~raft_tpu_torch.observability.costmodel.kernel_cost`
(``distance.knn`` is registered here: K1 or K2 at the index's shape); or
one run of the callable under ``torch.utils.flop_counter.FlopCounterMode``
with the bytes of its inputs and outputs. Each first capture also writes
the predicted half of the drift ledger (``measured=False``).

:meth:`Profiler.trace` is a ``torch.profiler.profile`` window: the ranges
already open at entry are re-entered as ``record_function`` ranges, and
ranges opened inside it are ``record_function`` ranges too
(:func:`raft_tpu_torch.core.nvtx.profiling`), so a kernel in the trace
nests under the span that launched it, as the reference's
``TraceAnnotation`` bridge does for xprof.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Dict, Iterator, Optional

import torch

from raft_tpu_torch.core import nvtx
from raft_tpu_torch.observability import costmodel
from raft_tpu_torch.observability.costmodel import CostRecord
from raft_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from raft_tpu_torch.observability.spans import span, tree_nbytes
from raft_tpu_torch.utils.arch import ChipSpec, chip_spec


def _leaf_sig(a) -> str:
    if isinstance(a, torch.Tensor):
        return f"{a.dtype}{tuple(a.shape)}@{a.device}"
    shape = getattr(a, "shape", None)
    if shape is not None and hasattr(a, "dtype"):       # numpy
        return f"{a.dtype}{tuple(shape)}@host"
    if a is None or isinstance(a, (bool, int, float, str)):
        return repr(a)
    # an index or another object: its identity (its own shape lives on it)
    return f"{type(a).__name__}@{id(a):x}"


def _signature(args, kwargs=None) -> str:
    """Shape, dtype and device signature of a call: the cost-record key."""
    parts = []

    def walk(t):
        if isinstance(t, (tuple, list)):
            for v in t:
                walk(v)
        elif isinstance(t, dict):
            for k in sorted(t, key=str):
                parts.append(f"{k}=")
                walk(t[k])
        else:
            parts.append(_leaf_sig(t))

    walk((args, kwargs or {}))
    return ";".join(parts)


def _knn_cost(res, index, queries, k, *args, **kwargs):
    """``distance.knn``'s work on a prepared index: one K1 (bf16) or K2
    (int8) launch at the index's shape (the queries against every
    prepared row). None for a raw matrix, which takes the streamed
    sweep."""
    from raft_tpu_torch.distance.knn_fused import KnnIndex

    if not isinstance(index, KnnIndex):
        return None
    Q = int(queries.shape[0])
    M = int(index.prepared_rows)
    groups = -(-(M // index.T) // index.g)
    if index.db_dtype == "int8":
        return costmodel.kernel_cost(
            "K2", entry="distance.knn", Q=Q, M=M, d=index.stream_width,
            S=M // (index.g * index.T) * 128, passes=index.passes)
    return costmodel.kernel_cost(
        "K1", entry="distance.knn", Q=Q, M=M, d=index.stream_width,
        S=groups * 128, passes=index.passes)


#: the entries whose cost function every profiler starts with
DEFAULT_COSTS: Dict[str, Callable] = {"distance.knn": _knn_cost}


def _device_of(args) -> Optional[torch.device]:
    stack = [args]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.Tensor):
            return t.device
        if isinstance(t, (tuple, list)):
            stack.extend(t)
        elif isinstance(t, dict):
            stack.extend(t.values())
        else:
            dev = getattr(t, "device", None)
            if isinstance(dev, torch.device):
                return dev
    return None


class Profiler:
    """Cost records and roofline placement for one handle.

    Thread-safe; a capture never raises into the caller (a failed count
    leaves the entry without a record)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 spec: Optional[ChipSpec] = None):
        self._registry = registry
        self.spec = spec if spec is not None else chip_spec()
        self._lock = threading.Lock()
        self._records: Dict[str, CostRecord] = {}       # latest per entry
        self._by_key: Dict[tuple, CostRecord] = {}      # (entry, key)
        self._costs: Dict[str, Callable] = dict(DEFAULT_COSTS)

    @property
    def registry(self) -> MetricsRegistry:
        # late-bound default, so a registry swapped after construction is
        # the one captures publish into
        return self._registry if self._registry is not None \
            else get_registry()

    # -- capture ----------------------------------------------------------
    def register_cost(self, entry: str, cost_fn: Callable) -> None:
        """Count ``entry``'s work with ``cost_fn(*args, **kwargs)`` (a
        :class:`CostRecord`, or None to fall back to the flop counter).
        An entry ``name/variant`` with no function of its own takes
        ``name``'s."""
        with self._lock:
            self._costs[entry] = cost_fn

    def capture(self, entry: str, record: CostRecord,
                key: str = "") -> CostRecord:
        """Record ``record`` as ``entry``'s cost at signature ``key`` and
        publish it. Returns the stored record."""
        rec = CostRecord(**{**record.__dict__, "entry": entry,
                            "key": key or record.key})
        with self._lock:
            self._records[entry] = rec
            self._by_key[(entry, rec.key)] = rec
        costmodel.publish(rec, self.registry)
        return rec

    def capture_fn(self, entry: str, fn: Callable, *args,
                   **kwargs) -> Optional[CostRecord]:
        """``entry``'s cost for ``fn(*args, **kwargs)``, memoised by
        (entry, signature): the registered cost function's record, else
        one run under ``FlopCounterMode``. Either way ``fn`` runs once,
        and ``peak_hbm_bytes`` is the allocator's high-water mark during
        that run above what was allocated before it (the call's outputs
        and temporaries; 0 on the CPU)."""
        key = _signature(args, kwargs)
        with self._lock:
            hit = self._by_key.get((entry, key))
            cost_fn = self._costs.get(entry,
                                      self._costs.get(entry.split("/")[0]))
        if hit is not None:
            with self._lock:
                self._records[entry] = hit
            return hit
        try:
            rec = cost_fn(*args, **kwargs) if cost_fn is not None else None
            dev = _device_of((args, kwargs))
            cuda = dev is not None and dev.type == "cuda"
            if cuda:
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                before = torch.cuda.memory_allocated(dev)
            if rec is None:
                from torch.utils.flop_counter import FlopCounterMode

                with FlopCounterMode(display=False) as fc:
                    out = fn(*args, **kwargs)
                n_in, n_out = tree_nbytes((args, kwargs)), tree_nbytes(out)
                rec = CostRecord(entry=entry, flops=float(
                    fc.get_total_flops()), bytes_accessed=float(n_in + n_out),
                    argument_bytes=n_in, output_bytes=n_out)
            else:
                out = fn(*args, **kwargs)
            del out
            if cuda:
                torch.cuda.synchronize(dev)
                rec.peak_hbm_bytes = int(
                    torch.cuda.max_memory_allocated(dev) - before)
            rec.platform = dev.type if dev is not None else "cpu"
        except Exception:
            return None
        rec = self.capture(entry, rec, key=key)
        # the predicted half of the drift ledger, once an (entry,
        # signature): the roofline-perfect seconds and bytes; the
        # measured half arrives when benchmark.Fixture.run times the site
        try:
            from raft_tpu_torch.observability.timeline import record_drift

            est = costmodel.roofline(rec, self.spec)
            record_drift(entry, predicted_seconds=est.roof_seconds,
                         predicted_bytes=rec.bytes_accessed,
                         measured=False)
        except Exception:
            pass
        return rec

    # -- queries ----------------------------------------------------------
    def records(self) -> Dict[str, CostRecord]:
        """Latest record an entry (a copy)."""
        with self._lock:
            return dict(self._records)

    def get(self, entry: str) -> Optional[CostRecord]:
        with self._lock:
            return self._records.get(entry)

    def roofline(self, entry: str, seconds: Optional[float] = None,
                 f32: bool = False):
        """The :class:`~raft_tpu_torch.observability.costmodel.
        RooflineEstimate` of one captured entry (None if uncaptured);
        ``seconds`` defaults to the entry's latest benchmark event."""
        rec = self.get(entry)
        if rec is None:
            return None
        if seconds is None:
            from raft_tpu_torch.observability.exporters import bench_results

            r = bench_results(self.registry).get(entry, {})
            s = r.get("seconds")
            seconds = s if isinstance(s, (int, float)) else None
        return costmodel.roofline(rec, self.spec, seconds=seconds, f32=f32)

    def report(self) -> str:
        """The roofline table over this profiler's records."""
        return costmodel.roofline_report(
            registry=self.registry, spec=self.spec,
            records=list(self.records().values()))

    # -- torch.profiler bridge ---------------------------------------------
    @contextlib.contextmanager
    def trace(self, log_dir: Optional[str] = None,
              name: str = "raft_tpu.trace") -> Iterator[object]:
        """A ``torch.profiler.profile`` window (CPU, and CUDA on a card),
        attributed to the range stack; yields the profile (None without
        ``log_dir``, where the window only annotates). With ``log_dir``
        the Chrome trace is written to ``<log_dir>/trace.json`` when the
        window closes. The window itself is a span."""
        with contextlib.ExitStack() as stack:
            prof = None
            if log_dir is not None:
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                stack.callback(_export, prof, log_dir)  # after its exit
                stack.enter_context(prof)
            stack.enter_context(nvtx.profiling())
            from torch.profiler import record_function

            for rng in nvtx.range_stack():
                stack.enter_context(record_function(rng))
            stack.enter_context(span(name))
            yield prof


def _export(prof, log_dir: str) -> None:
    """Write ``prof``'s Chrome trace under ``log_dir``."""
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    except Exception as e:
        from raft_tpu_torch.core.logger import log_warn

        log_warn("profiler.trace: could not write %s: %s", log_dir, e)


# -- process-global default (the registry's pattern) ----------------------
_global_profiler: Optional[Profiler] = None
_global_lock = threading.Lock()


def get_profiler() -> Profiler:
    """The process-global Profiler, created on first use: what
    ``res.profiler`` is when no handle sets its own."""
    global _global_profiler
    with _global_lock:
        if _global_profiler is None:
            _global_profiler = Profiler()
        return _global_profiler


def set_profiler(profiler: Optional[Profiler]) -> Optional[Profiler]:
    """Swap the process-global Profiler (tests). Returns the previous."""
    global _global_profiler
    with _global_lock:
        prev, _global_profiler = _global_profiler, profiler
        return prev
