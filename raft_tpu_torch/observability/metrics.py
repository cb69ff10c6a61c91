"""Metrics substrate: counters, gauges, fixed-bucket histograms.

Counterpart of ``raft_tpu/observability/metrics.py``: one process-wide
:class:`MetricsRegistry` every layer of the port reports into, exported
by :mod:`raft_tpu_torch.observability.exporters`. Metric names are the
reference's (``raft_tpu_*``) letter for letter, so one dashboard reads
both packages, and the Prometheus text of the same calls is byte-equal.

Design constraints:

- **Cheap enough to leave on.** Metric handles are get-or-create by
  ``(name, labels)``; the hot path after creation is one lock-guarded
  float add, on the host: nothing here touches the card.
- **A disabled mode that is a no-op attribute lookup.** When the
  registry is disabled (``RAFT_TPU_DISABLE_TRACING``, or
  :func:`disable`), ``counter()``/``gauge()``/``histogram()`` return the
  shared :data:`NULL_METRIC` whose methods do nothing and which never
  creates a registry entry — the contract ``core/nvtx.py`` keeps for
  ranges.
- **Thread-safe.** Registry creation and every metric mutation hold a
  lock; the serving batcher, the shadow scorer, the watchdog and the
  debugz handlers report and read concurrently.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

LabelDict = Optional[Dict[str, str]]
_LabelKey = Tuple[Tuple[str, str], ...]

# Fixed default buckets for wall-time histograms: 1 µs .. 30 s. NOTE the
# 30 s ceiling: anything slower lands only in the (always-emitted)
# cumulative ``le="+Inf"`` bucket, losing resolution; longer operations
# use COMPILE_TIME_BUCKETS instead.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-6, 1e-5, 1e-4, 1e-3, 3e-3, 1e-2, 3e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0,
)

# Long-operation preset: the same decade ladder, extended to 300 s (a
# kernel build or an index build takes minutes, not seconds) so such
# timings keep bucket resolution instead of piling into +Inf.
COMPILE_TIME_BUCKETS: Tuple[float, ...] = (
    1e-3, 1e-2, 1e-1, 3e-1, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0,
)


def _label_key(labels: LabelDict) -> _LabelKey:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def percentile(values: Iterable[float], q: float) -> float:
    """Linear-interpolated percentile of raw samples (numpy's default
    "linear" method: rank = (n−1)·q/100, interpolate between the two
    neighboring order statistics).

    The shared implementation ``ServingEngine.stats`` reads its p50 and
    p99 through."""
    vs = sorted(float(v) for v in values)
    if not vs:
        raise ValueError("percentile: empty sample set")
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile: q={q} outside [0, 100]")
    if len(vs) == 1:
        return vs[0]
    rank = (len(vs) - 1) * (q / 100.0)
    lo = int(math.floor(rank))
    hi = min(lo + 1, len(vs) - 1)
    frac = rank - lo
    return vs[lo] + (vs[hi] - vs[lo]) * frac


class Counter:
    """Monotonically increasing value. (Prometheus counter semantics.)"""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelDict = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Value that can go up and down."""

    __slots__ = ("name", "labels", "_lock", "_value")

    def __init__(self, name: str, labels: LabelDict = None):
        self.name = name
        self.labels = dict(labels or {})
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus ``le`` semantics).

    ``buckets`` are the finite upper bounds; an implicit ``+Inf`` bucket
    always exists, so ``bucket_counts`` has ``len(buckets) + 1`` entries
    and the last one equals ``count``.
    """

    __slots__ = ("name", "labels", "buckets", "_lock", "_bucket_counts",
                 "_sum", "_count")

    def __init__(self, name: str, labels: LabelDict = None,
                 buckets: Iterable[float] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.labels = dict(labels or {})
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError(f"histogram {name}: needs at least one bucket")
        self._lock = threading.Lock()
        self._bucket_counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        value = float(value)
        # linear scan: bucket lists are short (≤ ~16) and the scan is
        # branch-predictable; bisect would pay more in call overhead
        idx = len(self.buckets)
        for i, b in enumerate(self.buckets):
            if value <= b:
                idx = i
                break
        with self._lock:
            self._bucket_counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def bucket_counts(self) -> List[int]:
        """Per-bucket (non-cumulative) counts, +Inf bucket last."""
        with self._lock:
            return list(self._bucket_counts)

    def cumulative_counts(self) -> List[int]:
        """Cumulative counts per ``le`` bound, +Inf last (== count)."""
        with self._lock:
            out, acc = [], 0
            for c in self._bucket_counts:
                acc += c
                out.append(acc)
            return out

    def percentile(self, q: float) -> Optional[float]:
        """Estimated q-th percentile from the bucket counts (the
        ``histogram_quantile`` method, via :func:`bucket_percentile`).

        Interpolation contract (pinned against :func:`percentile` on
        raw samples):

        - the target rank is ``(q/100)·count``; the answer is a linear
          interpolation inside the first bucket whose CUMULATIVE count
          reaches it — the estimate is therefore exact only up to one
          bucket width (a single populated bucket ``(lo, b]`` reports
          a point inside ``[lo, b]``, not the sample's true value);
        - the first bucket's lower edge is 0 for non-negative bounds
          (``min(0, b0)`` otherwise);
        - observations past the last finite bound (the ``+Inf``
          overflow bucket) clamp to that bound — an all-in-+Inf
          histogram reports ``buckets[-1]`` for every q;
        - None when empty — exporters render a dash instead of a fake
          zero."""
        cum = self.cumulative_counts()
        return bucket_percentile(self.buckets, cum, q)


def bucket_percentile(buckets: Tuple[float, ...], cumulative: List[int],
                      q: float) -> Optional[float]:
    """The ``histogram_quantile`` interpolation over explicit bucket
    state: ``buckets`` are the finite upper bounds, ``cumulative`` the
    cumulative counts per bound with the ``+Inf`` entry LAST (length
    ``len(buckets) + 1``). Shared by :meth:`Histogram.percentile` (live
    totals) and :mod:`raft_tpu_torch.observability.windows` (windowed count
    DELTAS — the same math over a snapshot difference). See the method
    docstring for the full interpolation contract."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile: q={q} outside [0, 100]")
    total = cumulative[-1]
    if total == 0:
        return None
    rank = (q / 100.0) * total
    for i, b in enumerate(buckets):
        if cumulative[i] >= rank:
            lo = (buckets[i - 1] if i > 0 else min(0.0, b))
            prev = cumulative[i - 1] if i > 0 else 0
            in_bucket = cumulative[i] - prev
            frac = ((rank - prev) / in_bucket) if in_bucket else 1.0
            return lo + (b - lo) * frac
    return buckets[-1]   # +Inf bucket: clamp to the last finite bound


class _NullMetric:
    """Shared do-nothing metric returned by a disabled registry.

    Every mutating method of Counter/Gauge/Histogram exists here as a
    no-op, so call sites never branch on enablement — the disabled fast
    path is one attribute lookup plus an empty call.
    """

    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        pass

    def dec(self, amount: float = 1.0) -> None:
        pass

    def set(self, value: float) -> None:
        pass

    def observe(self, value: float) -> None:
        pass

    @property
    def value(self) -> float:
        return 0.0

    @property
    def count(self) -> int:
        return 0

    @property
    def sum(self) -> float:
        return 0.0

    def percentile(self, q: float) -> Optional[float]:
        return None


NULL_METRIC = _NullMetric()

_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Process-wide (or test-local) store of named metrics + event log.

    Metrics are keyed by ``(name, labels)``; ``name`` is bound to one
    kind (counter/gauge/histogram) at first creation and a kind
    collision raises. The event log is a bounded deque of dicts — the
    substrate of the JSON-lines exporter (span ends and other events).
    """

    def __init__(self, enabled: bool = True, max_events: int = 4096):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, _LabelKey], object] = {}
        self._kinds: Dict[str, str] = {}
        self._help: Dict[str, str] = {}
        self.events: collections.deque = collections.deque(maxlen=max_events)

    # -- get-or-create ----------------------------------------------------
    def _get(self, kind: str, name: str, labels: LabelDict, help: str = "",
             **kw):
        if not self.enabled:
            return NULL_METRIC
        key = (name, _label_key(labels))
        with self._lock:
            bound = self._kinds.get(name)
            if bound is not None and bound != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {bound}, "
                    f"requested {kind}")
            metric = self._metrics.get(key)
            if metric is None:
                metric = _KINDS[kind](name, labels, **kw)
                self._metrics[key] = metric
                self._kinds[name] = kind
                if help:
                    self._help.setdefault(name, help)
            return metric

    def counter(self, name: str, labels: LabelDict = None,
                help: str = "") -> Counter:
        return self._get("counter", name, labels, help)

    def gauge(self, name: str, labels: LabelDict = None,
              help: str = "") -> Gauge:
        return self._get("gauge", name, labels, help)

    def histogram(self, name: str, labels: LabelDict = None, help: str = "",
                  buckets: Iterable[float] = DEFAULT_TIME_BUCKETS) -> Histogram:
        return self._get("histogram", name, labels, help, buckets=buckets)

    # -- events -----------------------------------------------------------
    def emit(self, event: Dict) -> None:
        """Append an event (a JSON-serializable dict) to the bounded log;
        a ``ts`` wall-clock field is stamped if absent."""
        if not self.enabled:
            return
        event.setdefault("ts", time.time())
        self.events.append(event)

    # -- introspection ----------------------------------------------------
    def kind_of(self, name: str) -> Optional[str]:
        with self._lock:
            return self._kinds.get(name)

    def help_of(self, name: str) -> str:
        with self._lock:
            return self._help.get(name, "")

    def collect(self) -> List[object]:
        """Stable-ordered snapshot of all live metrics (by name, then
        label key) — the exporters' single entry point."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
            return [m for _, m in items]

    def __len__(self) -> int:
        with self._lock:
            return len(self._metrics)

    def reset(self) -> None:
        """Drop every metric and event (tests; long-running re-baselining)."""
        with self._lock:
            self._metrics.clear()
            self._kinds.clear()
            self._help.clear()
        self.events.clear()


def validate_buckets(buckets: Iterable[float]) -> Tuple[float, ...]:
    """Sorted finite bucket bounds or raise — shared by callers that
    accept user-provided bucket lists."""
    bs = tuple(sorted(float(b) for b in buckets))
    if not bs or any(not math.isfinite(b) for b in bs):
        raise ValueError("buckets must be a non-empty list of finite bounds")
    return bs


# -- the process-global registry -----------------------------------------
# RAFT_TPU_DISABLE_TRACING is the one switch shared with core/nvtx.py: set,
# it disables ranges, spans, AND metrics (the "--no-nvtx build").
ENV_DISABLED = bool(os.environ.get("RAFT_TPU_DISABLE_TRACING"))

_global_registry = MetricsRegistry(enabled=not ENV_DISABLED)
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry every built-in hook reports into."""
    return _global_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests; multi-tenant embedding).
    Returns the previous one."""
    global _global_registry
    with _global_lock:
        prev, _global_registry = _global_registry, registry
        return prev


def enable() -> None:
    """Runtime re-enable (no effect on already-decorated functions if the
    process started with RAFT_TPU_DISABLE_TRACING — those were left
    bare; see spans.instrument)."""
    _global_registry.enabled = True


def disable() -> None:
    """Runtime disable: hooks fall through to NULL_METRIC no-ops and new
    registry entries stop appearing."""
    _global_registry.enabled = False


def tracing_enabled() -> bool:
    return _global_registry.enabled
