"""Windowed aggregation over the MetricsRegistry: rate(), delta(),
windowed percentiles (counterpart of ``raft_tpu/observability/
windows.py``).

Every metric in the registry is cumulative-since-process-start — the
right substrate for scrapes, useless on its own for "is the error rate
high NOW". This module keeps a bounded ring of per-window metric
snapshots (one cheap ``tick()`` per interval: counters copy one float,
histograms one short cumulative-count list) and answers windowed
questions by SUBTRACTING snapshots:

- :meth:`MetricWindows.delta` — counter/histogram-count increase over
  the last ``window_s`` seconds (summed across label sets by default,
  so ``delta(REQUESTS)`` is total traffic and
  ``delta(REQUESTS, {"status": "shed"})`` the shed slice);
- :meth:`MetricWindows.rate` — delta divided by the ACTUAL covered
  interval (the ring stores real tick timestamps — a late tick widens
  the denominator instead of inflating the rate);
- :meth:`MetricWindows.percentile` — the ``histogram_quantile``
  interpolation (:func:`~raft_tpu_torch.observability.metrics.
  bucket_percentile`) over windowed bucket-count DELTAS — a true
  rolling p50/p99, not the since-start estimate;
- :meth:`MetricWindows.gauge` — the newest sampled gauge value.

The clock is injectable (tests tick a fake clock through hours of
burn-rate history in microseconds) and the ring is bounded: capacity ×
interval is the longest lookback any SLO window can ask for — sized by
the caller (:class:`~raft_tpu_torch.observability.slo.SloEngine` sizes it to
cover its slowest burn window).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from raft_tpu_torch.observability.metrics import (Counter, Gauge, Histogram,
                                            MetricsRegistry,
                                            bucket_percentile,
                                            get_registry)

_LabelKey = Tuple[Tuple[str, str], ...]


def _key(name: str, labels: Optional[Dict[str, str]]) -> Tuple:
    return (name, tuple(sorted((str(k), str(v))
                               for k, v in (labels or {}).items())))


class _Snap:
    """One tick's frozen view: scalar values for counters/gauges,
    (bounds, cumulative counts, sum) for histograms."""

    __slots__ = ("ts", "scalars", "hists")

    def __init__(self, ts: float):
        self.ts = ts
        self.scalars: Dict[Tuple, float] = {}
        self.hists: Dict[Tuple, Tuple[Tuple[float, ...], List[int],
                                      float]] = {}


class MetricWindows:
    """A ring of per-window registry snapshots (see module doc).

    ``interval_s`` is the nominal tick spacing — :meth:`tick` is
    rate-limited to it, so wiring it into a hot loop is safe (extra
    calls are one clock read). ``capacity`` bounds the lookback to
    ``capacity × interval_s`` seconds."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 5.0, capacity: int = 720,
                 clock=time.monotonic):
        self._registry = registry
        self.interval_s = max(1e-3, float(interval_s))
        self.capacity = max(2, int(capacity))
        self._clock = clock
        self._lock = threading.Lock()
        self._ring: List[_Snap] = []

    @property
    def registry(self) -> MetricsRegistry:
        return (self._registry if self._registry is not None
                else get_registry())

    # -- ticking ----------------------------------------------------------
    def tick(self, force: bool = False) -> bool:
        """Snapshot the registry if a full interval has passed since
        the last tick (``force=True`` snapshots regardless — tests and
        the end-of-run bench stamp). Returns whether a snapshot was
        taken."""
        now = self._clock()
        with self._lock:
            if (not force and self._ring
                    and now - self._ring[-1].ts < self.interval_s):
                return False
        snap = _Snap(now)
        for metric in self.registry.collect():
            mk = _key(metric.name, metric.labels)
            if isinstance(metric, Histogram):
                snap.hists[mk] = (metric.buckets,
                                  metric.cumulative_counts(),
                                  metric.sum)
            elif isinstance(metric, (Counter, Gauge)):
                snap.scalars[mk] = metric.value
        with self._lock:
            self._ring.append(snap)
            if len(self._ring) > self.capacity:
                del self._ring[:len(self._ring) - self.capacity]
        return True

    def _bracket(self, window_s: float) -> Optional[Tuple[_Snap, _Snap]]:
        """(oldest snapshot covering the window, newest snapshot) — or
        None with fewer than two ticks. The old edge is the NEWEST
        snapshot at least ``window_s`` old (so the covered interval is
        ≥ the asked window when history allows), falling back to the
        oldest one held."""
        with self._lock:
            if len(self._ring) < 2:
                return None
            newest = self._ring[-1]
            cutoff = newest.ts - float(window_s)
            old = self._ring[0]
            for snap in self._ring[:-1]:
                if snap.ts <= cutoff:
                    old = snap
                else:
                    break
            if old is newest:
                old = self._ring[-2]
            return old, newest

    # -- windowed reads ---------------------------------------------------
    def _scalar_sum(self, snap: _Snap, name: str,
                    labels: Optional[Dict[str, str]]) -> float:
        if labels is not None:
            return snap.scalars.get(_key(name, labels), 0.0)
        total = 0.0
        for (n, _lk), v in snap.scalars.items():
            if n == name:
                total += v
        return total

    def _hist_count(self, snap: _Snap, name: str,
                    labels: Optional[Dict[str, str]]) -> float:
        total = 0.0
        for (n, lk), (_b, cum, _s) in snap.hists.items():
            if n != name:
                continue
            if labels is not None and lk != _key(name, labels)[1]:
                continue
            total += cum[-1]
        return total

    def delta(self, name: str, labels: Optional[Dict[str, str]] = None,
              window_s: Optional[float] = None) -> float:
        """Counter increase (or histogram observation-count increase)
        over the window — summed across label sets when ``labels`` is
        None. 0.0 with insufficient history (an honest "no evidence
        yet", never a crash)."""
        br = self._bracket(window_s if window_s is not None
                           else self.interval_s)
        if br is None:
            return 0.0
        old, new = br
        d = (self._scalar_sum(new, name, labels)
             - self._scalar_sum(old, name, labels))
        if d == 0.0:
            d = (self._hist_count(new, name, labels)
                 - self._hist_count(old, name, labels))
        return max(0.0, d)

    def rate(self, name: str, labels: Optional[Dict[str, str]] = None,
             window_s: Optional[float] = None) -> float:
        """Per-second rate over the window: delta over the ACTUAL
        interval the bracketing snapshots cover."""
        br = self._bracket(window_s if window_s is not None
                           else self.interval_s)
        if br is None:
            return 0.0
        old, new = br
        dt = new.ts - old.ts
        if dt <= 0.0:
            return 0.0
        return self.delta(name, labels, window_s) / dt

    def percentile(self, name: str, q: float,
                   labels: Optional[Dict[str, str]] = None,
                   window_s: Optional[float] = None) -> Optional[float]:
        """Windowed histogram percentile: the bucket interpolation over
        cumulative-count DELTAS between the bracketing snapshots,
        merged across label sets when ``labels`` is None. None without
        enough history or observations in the window."""
        br = self._bracket(window_s if window_s is not None
                           else self.interval_s)
        if br is None:
            return None
        old, new = br
        want_lk = None if labels is None else _key(name, labels)[1]
        bounds: Optional[Tuple[float, ...]] = None
        window_cum: Optional[List[float]] = None
        for (n, lk), (b, cum, _s) in new.hists.items():
            if n != name or (want_lk is not None and lk != want_lk):
                continue
            old_h = old.hists.get((n, lk))
            old_cum = old_h[1] if old_h is not None else [0] * len(cum)
            d = [max(0, c1 - c0) for c1, c0 in zip(cum, old_cum)]
            if bounds is None:
                bounds = b
                window_cum = d
            elif b == bounds and window_cum is not None:
                window_cum = [a + x for a, x in zip(window_cum, d)]
        if bounds is None or window_cum is None:
            return None
        return bucket_percentile(bounds, window_cum, q)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None
              ) -> Optional[float]:
        """The newest sampled value of a gauge (or counter) — None when
        it has never been sampled."""
        with self._lock:
            if not self._ring:
                return None
            newest = self._ring[-1]
        mk = _key(name, labels)
        if labels is None:
            for (n, _lk), v in newest.scalars.items():
                if n == name:
                    return v
            return None
        return newest.scalars.get(mk)

    def covered_s(self) -> float:
        """Seconds of history the ring currently holds."""
        with self._lock:
            if len(self._ring) < 2:
                return 0.0
            return self._ring[-1].ts - self._ring[0].ts

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
