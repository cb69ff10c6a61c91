"""Declarative SLOs with multi-window burn-rate alerts (counterpart of
``raft_tpu/observability/slo.py``).

A single threshold on a raw counter either pages on every blip (too
fast a window) or hours after the budget is gone (too slow). The
standard fix (the Google SRE multiwindow recipe) alerts on the **burn
rate** — the bad-event fraction divided by the SLO's error budget, so
``burn = 1`` exactly spends the budget over the SLO period — and only
fires when BOTH a fast and a slow window exceed the threshold: the
fast window gives detection latency, the slow window de-flaps it, and
recovery clears the alert as soon as the fast window drops back under.

:class:`SloEngine` evaluates a list of :class:`SloObjective` over a
:class:`~raft_tpu_torch.observability.windows.MetricWindows` ring.
:func:`default_objectives` declares the serving SLOs:

- **availability** — 1 − (shed + deadline + error) / total over
  ``raft_tpu_serving_requests_total`` status deltas;
- **latency** — fraction of requests over the latency threshold,
  straight from ``raft_tpu_serving_latency_seconds`` bucket deltas (a
  histogram IS a pre-aggregated threshold-violation counter — pick the
  bucket, no per-request state needed);
- **shadow recall** — shadow-floor breaches over shadow samples (the
  online recall plane's breach counter).

Each objective carries two severity rungs: ``page`` (fast 60 s / slow
300 s at 14.4× burn — budget gone in ~2 days at that rate) and
``ticket`` (300 s / 3600 s at 6×). Transitions emit an ``"alert"``
flight event (:func:`~raft_tpu_torch.observability.timeline.emit_alert`),
bump ``raft_tpu_slo_burn_alerts_total{slo,severity}``, and surface in
:meth:`SloEngine.status` — what ``ServingEngine.stats()``, ``/statusz``
and the ``/healthz`` 503 flip read. The engine holds no thread: the
serving batcher loop (or a test) calls :meth:`tick`; evaluation is
pure snapshot arithmetic, rate-limited by the windows ring's interval.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Tuple

from raft_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from raft_tpu_torch.observability.timeline import emit_alert
from raft_tpu_torch.observability.windows import MetricWindows

#: alert-transition counter (bumped once per firing transition, not per
#: tick the alert stays active — dashboards count pages, not samples)
BURN_ALERTS = "raft_tpu_slo_burn_alerts_total"

#: serving metric names mirrored here (slo.py does not import the
#: serving engine — observability stays importable without it)
REQUESTS = "raft_tpu_serving_requests_total"
LATENCY = "raft_tpu_serving_latency_seconds"
SHADOW_SAMPLES = "raft_tpu_serving_shadow_samples_total"
SHADOW_BREACHES = "raft_tpu_serving_shadow_breaches_total"

#: request statuses that consume the availability error budget
BAD_STATUSES = ("shed", "deadline", "error")

#: default latency SLO threshold (seconds) — requests slower than this
#: count against the latency budget
LATENCY_THRESHOLD_S = 0.250


@dataclasses.dataclass(frozen=True)
class BurnWindow:
    """One severity rung: fire when burn(fast) AND burn(slow) both
    exceed ``factor``; clear when burn(fast) drops back under."""

    severity: str          # "page" | "ticket"
    fast_s: float
    slow_s: float
    factor: float


#: the SRE-book pairs: page on a 14.4× burn (1h-scale budget
#: exhaustion), ticket on a sustained 6×.
DEFAULT_WINDOWS = (
    BurnWindow("page", fast_s=60.0, slow_s=300.0, factor=14.4),
    BurnWindow("ticket", fast_s=300.0, slow_s=3600.0, factor=6.0),
)


@dataclasses.dataclass(frozen=True)
class SloObjective:
    """One declarative objective.

    ``bad_fraction(windows, window_s)`` returns the bad-event fraction
    over the window — or None when the window has no evidence (no
    traffic, no shadow samples): an evidence-free window neither fires
    nor clears anything. ``objective`` is the good-fraction target
    (0.99 availability ⇒ a 0.01 error budget)."""

    name: str
    objective: float
    bad_fraction: Callable[[MetricWindows, float], Optional[float]]
    windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - float(self.objective))

    def burn(self, windows: MetricWindows,
             window_s: float) -> Optional[float]:
        """Burn rate over one window: bad fraction / error budget
        (1.0 = exactly spending the budget); None without evidence."""
        bad = self.bad_fraction(windows, window_s)
        if bad is None:
            return None
        return max(0.0, float(bad)) / self.budget


# -- the default serving objectives -------------------------------------
def _availability_bad(w: MetricWindows, window_s: float
                      ) -> Optional[float]:
    total = w.delta(REQUESTS, window_s=window_s)
    if total <= 0.0:
        return None
    bad = sum(w.delta(REQUESTS, {"status": s}, window_s=window_s)
              for s in BAD_STATUSES)
    return bad / total


def _latency_bad(threshold_s: float):
    def bad(w: MetricWindows, window_s: float) -> Optional[float]:
        br = w._bracket(window_s)
        if br is None:
            return None
        old, new = br
        total = 0.0
        slow = 0.0
        for (n, lk), (bounds, cum, _s) in new.hists.items():
            if n != LATENCY:
                continue
            old_h = old.hists.get((n, lk))
            old_cum = old_h[1] if old_h is not None else [0] * len(cum)
            d_total = cum[-1] - old_cum[-1]
            if d_total <= 0:
                continue
            # requests at or under the threshold: the cumulative count
            # of the last bucket bound <= threshold (bucket edges are
            # the only resolution a histogram has — the declared
            # threshold should sit on one)
            le = 0.0
            for i, b in enumerate(bounds):
                if b <= threshold_s:
                    le = cum[i] - old_cum[i]
            total += d_total
            slow += d_total - le
        if total <= 0.0:
            return None
        return slow / total

    return bad


def _recall_bad(w: MetricWindows, window_s: float) -> Optional[float]:
    samples = w.delta(SHADOW_SAMPLES, window_s=window_s)
    if samples <= 0.0:
        return None
    return w.delta(SHADOW_BREACHES, window_s=window_s) / samples


def default_objectives(availability: float = 0.99,
                       latency_objective: float = 0.99,
                       latency_threshold_s: float = LATENCY_THRESHOLD_S,
                       recall_objective: float = 0.95,
                       windows: Tuple[BurnWindow, ...] = DEFAULT_WINDOWS
                       ) -> List[SloObjective]:
    """The serving SLO set (see module doc). ``windows`` is injectable
    so tests shrink the rungs to seconds."""
    return [
        SloObjective("availability", availability, _availability_bad,
                     windows),
        SloObjective("latency_p99", latency_objective,
                     _latency_bad(latency_threshold_s), windows),
        SloObjective("shadow_recall", recall_objective, _recall_bad,
                     windows),
    ]


class SloEngine:
    """Evaluate objectives over a windows ring; own the alert state
    machine (see module doc)."""

    def __init__(self, windows: Optional[MetricWindows] = None,
                 objectives: Optional[List[SloObjective]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=None):
        if windows is None:
            windows = MetricWindows(registry=registry,
                                    **({} if clock is None
                                       else {"clock": clock}))
        self.windows = windows
        self.objectives = (default_objectives() if objectives is None
                           else list(objectives))
        self._registry = registry
        self._lock = threading.Lock()
        #: {(slo, severity): {"since": ts, "burn_fast": x, ...}}
        self._active: Dict[Tuple[str, str], Dict] = {}

    @property
    def registry(self) -> MetricsRegistry:
        return (self._registry if self._registry is not None
                else get_registry())

    # -- evaluation -------------------------------------------------------
    def tick(self, force: bool = False) -> List[Dict]:
        """Snapshot the registry (rate-limited by the windows ring) and
        re-evaluate every objective. Returns the alert TRANSITIONS this
        tick (firing/resolved events, not steady state). Never raises —
        the batcher loop calls this inline."""
        try:
            if not self.windows.tick(force=force) and not force:
                return []
            return self._evaluate()
        except Exception:
            return []

    def _evaluate(self) -> List[Dict]:
        transitions: List[Dict] = []
        for obj in self.objectives:
            for rung in obj.windows:
                key = (obj.name, rung.severity)
                fast = obj.burn(self.windows, rung.fast_s)
                slow = obj.burn(self.windows, rung.slow_s)
                firing = (fast is not None and slow is not None
                          and fast >= rung.factor
                          and slow >= rung.factor)
                clearing = fast is not None and fast < rung.factor
                with self._lock:
                    active = key in self._active
                    if firing and not active:
                        info = {"slo": obj.name,
                                "severity": rung.severity,
                                "state": "firing",
                                "burn_fast": round(fast, 3),
                                "burn_slow": round(slow, 3),
                                "factor": rung.factor}
                        self._active[key] = dict(info)
                        transitions.append(info)
                    elif active and clearing:
                        info = dict(self._active.pop(key))
                        info.update(state="resolved",
                                    burn_fast=round(fast, 3))
                        transitions.append(info)
                    elif active and fast is not None:
                        self._active[key]["burn_fast"] = round(fast, 3)
                        if slow is not None:
                            self._active[key]["burn_slow"] = round(
                                slow, 3)
        for t in transitions:
            if t["state"] == "firing":
                self.registry.counter(
                    BURN_ALERTS,
                    {"slo": t["slo"], "severity": t["severity"]},
                    help="SLO burn-rate alert firing transitions",
                ).inc()
            emit_alert(t["slo"], t["severity"], t["state"],
                       burn_fast=t.get("burn_fast"),
                       burn_slow=t.get("burn_slow"),
                       factor=t.get("factor"))
        return transitions

    # -- read surfaces ----------------------------------------------------
    def active_alerts(self) -> List[Dict]:
        """Currently-firing alerts (copies), page severity first."""
        with self._lock:
            alerts = [dict(v) for v in self._active.values()]
        alerts.sort(key=lambda a: (a["severity"] != "page", a["slo"]))
        return alerts

    def burning(self, severity: str = "page") -> bool:
        """Is any alert of this severity active? (the ``/healthz`` 503
        predicate)"""
        with self._lock:
            return any(sev == severity for _, sev in self._active)

    def status(self) -> Dict:
        """The SLO panel: per-objective burn rates at every rung plus
        the active alerts — what ``stats()``/``/statusz`` render."""
        objectives = []
        for obj in self.objectives:
            rungs = []
            for rung in obj.windows:
                fast = obj.burn(self.windows, rung.fast_s)
                slow = obj.burn(self.windows, rung.slow_s)
                rungs.append({
                    "severity": rung.severity,
                    "factor": rung.factor,
                    "burn_fast": (None if fast is None
                                  else round(fast, 3)),
                    "burn_slow": (None if slow is None
                                  else round(slow, 3)),
                    "firing": (obj.name, rung.severity) in self._active,
                })
            objectives.append({"slo": obj.name,
                               "objective": obj.objective,
                               "windows": rungs})
        return {"objectives": objectives,
                "active_alerts": self.active_alerts(),
                "covered_s": round(self.windows.covered_s(), 3),
                "healthy": not self.burning("page")}
