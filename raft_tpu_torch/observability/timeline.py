"""Typed timeline emitters and the model-vs-measured drift ledger.

Counterpart of ``raft_tpu/observability/timeline.py``. Every subsystem
that takes part in the timeline calls one helper here, so event shapes
stay the reference's and the disabled fast path stays a single boolean
test: no helper computes an argument before checking
``recorder.enabled``.

Emitters → :data:`raft_tpu_torch.observability.flight.KNOWN_EVENT_KINDS`:

- :func:`emit_span` (``span``) — from ``spans._record``: complete
  events carrying begin + duration, bytes in/out and the range stack.
- :func:`emit_collective` (``collective``) — from
  ``hooks.record_collective``: payload bytes and axis of one collective
  call (counted a call in the port: it has no trace time).
- :func:`emit_compile` / :func:`emit_dispatch` (``compile`` /
  ``dispatch``) — the kernel library cache of ``ops/_build.py`` and the
  runtime entry's dispatch.
- :func:`emit_fault` / :func:`emit_retry` / :func:`emit_degradation`
  (``fault`` / ``retry`` / ``degradation``) — from
  :mod:`raft_tpu_torch.resilience`.
- :func:`emit_deadline` (``deadline``) — a scope armed or fired.
- :func:`emit_error` (``error``), :func:`emit_benchmark`
  (``benchmark``), :func:`emit_mutation` (``mutation``).
- :func:`emit_marker` (``marker``), :func:`emit_quality` (``quality``),
  :func:`emit_flow` (``flow``), :func:`emit_serving` (``serving``),
  :func:`emit_explain` (``explain``), :func:`emit_alert` (``alert``),
  :func:`emit_stall` (``stall``), :func:`emit_epilogue` (``epilogue``).

Drift ledger
------------
:class:`DriftLedger` records, per site, the cost model's prediction
beside a measurement: ``Profiler.capture_fn`` appends the predicted half
(``measured=False``) and ``benchmark.Fixture.run`` the measured half
(``measured=True`` only on a CUDA device). In memory always; written to
the path in ``RAFT_TPU_DRIFT_LEDGER`` when set, or by
:meth:`DriftLedger.save`. The file format is the reference's (schema 1,
``band``, ``entries``), so each package loads the other's file.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from raft_tpu_torch.observability.flight import get_flight_recorder

#: flag a site when predicted and measured disagree by more than this
#: factor (either direction); the reference's band
DRIFT_BAND = 3.0

DRIFT_SCHEMA = 1
DRIFT_RECORDS = "raft_tpu_drift_records_total"
DRIFT_RATIO = "raft_tpu_drift_seconds_ratio"
#: ledger loads that degraded to empty, by reason (unreadable /
#: invalid): counted always, warned once per (path, reason) per process
DRIFT_DEGRADED = "raft_tpu_drift_ledger_degraded_total"

_degraded_warned: set = set()


def _ledger_degraded(path: str, reason: str, detail: str = "") -> None:
    try:
        from raft_tpu_torch.observability.metrics import get_registry

        get_registry().counter(
            DRIFT_DEGRADED, {"reason": reason},
            help="Drift-ledger loads degraded to empty, by reason"
        ).inc()
    except Exception:
        pass
    key = (path, reason)
    if key not in _degraded_warned:
        _degraded_warned.add(key)
        from raft_tpu_torch.core.logger import log_warn

        log_warn("drift ledger %s degraded to empty (%s)%s — this WARN "
                 "fires once per process; the drift_ledger_degraded "
                 "counter keeps counting", path, reason,
                 f": {detail}" if detail else "")


def _reset_degraded_warnings() -> None:
    """Test hook: re-arm the once-per-process WARN."""
    _degraded_warned.clear()


def _now() -> float:
    return time.perf_counter()


# ------------------------------------------------------------- emitters
def emit_span(name: str, parent: str, seconds: float, bytes_in: int,
              bytes_out: int, error: bool,
              stack: Optional[List[str]] = None) -> None:
    """One completed instrumented span (ph=X, begin = now − seconds)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("span", name, ts=_now() - seconds, dur=seconds, ph="X",
               stack=stack, range=parent, bytes_in=bytes_in,
               bytes_out=bytes_out, error=error)


def emit_collective(collective: str, nbytes: int, axis: str) -> None:
    """One comms collective call (lane = the mesh axis)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("collective", collective, lane=f"comms:{axis or '?'}",
               bytes=nbytes, axis=axis)


def emit_compile(entry: str, seconds: float = 0.0,
                 hit: Optional[bool] = None) -> None:
    """A kernel-library cache hit or miss, or a timed build (ph=X when a
    duration is known)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    if seconds:
        rec.record("compile", entry, ts=_now() - seconds, dur=seconds,
                   ph="X", hit=bool(hit) if hit is not None else False)
    else:
        rec.record("compile", entry,
                   hit=bool(hit) if hit is not None else None)


def emit_dispatch(entry: str) -> None:
    """One runtime-entry dispatch."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("dispatch", entry)


def emit_fault(site: str, kind: str) -> None:
    """One injected fault firing at ``site``."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("fault", site, fault_kind=kind)


def emit_retry(site: str, attempt: int, error: str) -> None:
    """One bounded-retry attempt."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("retry", site, attempt=attempt, error=error[:200])


def emit_degradation(site: str, action: str) -> None:
    """One graceful-degradation ladder rung (policy.record_degradation)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("degradation", site, action=action)


def emit_deadline(label: str, seconds: Optional[float], fired: bool,
                  stack: Optional[List[str]] = None) -> None:
    """A deadline scope armed (``fired=False``) or converting a hang
    into DeadlineExceededError (``fired=True``)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("deadline", label, stack=stack, budget_seconds=seconds,
               fired=fired)


def emit_error(error_type: str, message: str,
               context: str = "") -> None:
    """One classified device error."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("error", error_type, message=message[:300],
               context=context)


def emit_benchmark(name: str, seconds: float) -> None:
    """One Fixture.run result (ph=X spanning the measured time)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("benchmark", name, ts=_now() - seconds, dur=seconds,
               ph="X")


def emit_marker(name: str, **args) -> None:
    """Free-form instant (benchmark phase boundaries etc.)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("marker", name, **args)


def emit_quality(site: str, **args) -> None:
    """One quality-plane incident (``quality`` kind): a nonzero batch
    of certificate failures, the fixup tier that absorbed them, or an
    IVF q8 exact-scan rerun — result-quality anomalies land on the same
    timeline as the perf events around them (emitted by
    :mod:`raft_tpu_torch.observability.quality`)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("quality", site, **args)


def emit_flow(step: str, rid: int, ph: str = "t",
              outcome: Optional[str] = None, **args) -> None:
    """One per-request flow point (``flow`` kind, Chrome flow-event
    phases): ``ph="s"`` starts request ``rid``'s flow at enqueue,
    ``ph="t"`` steps it through batch assembly / dispatch / requeue on
    the batcher thread, ``ph="f"`` terminates it at completion.
    ``outcome`` annotates the terminus (``ok`` / ``shed`` / ``expired``
    / ``deadline`` / ``reject`` / ``error``). All points share the
    constant event name — Chrome binds flows on (cat, name, id), so
    one request renders as one connected arrow chain across lanes; the
    step label rides in args."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    if outcome is not None:
        args["outcome"] = outcome
    rec.record("flow", "request", ph=ph, flow_id=int(rid), step=step,
               **args)


def emit_mutation(event: str, **args) -> None:
    """One mutable-index event (``mutation`` kind): ``event`` names the
    step — ``upsert`` / ``delete`` (with row counts and the post-apply
    delta/tombstone occupancy), ``compact_start`` / ``compact_swap`` /
    ``compact_abort`` (the fold's lifecycle, with generation numbers),
    ``checkpoint`` and ``recovery`` (:mod:`raft_tpu_torch.mutable`)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("mutation", event, lane="mutable", **args)


def emit_serving(event: str, **args) -> None:
    """One serving-engine lifecycle event (``serving`` kind). ``event``
    names the step — ``enqueue`` (request admitted, with queue depth),
    ``flush`` (a coalesced micro-batch dispatched, with bucket/rows),
    ``shed`` (overload admission rejection), ``swap`` (index snapshot
    generation change), ``warmup`` (a bucket's warm-up dispatch at
    engine start), ``reject`` (request larger than the bucket ladder),
    ``mutate`` (an upsert/delete applied on the batcher) — so a
    Perfetto trace shows the queue → batch → dispatch pipeline next to
    the deadline and fault events around it."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("serving", event, lane="serving", **args)


def emit_explain(site: str, rid: int, **args) -> None:
    """One per-query explain record (``explain`` kind): the decision
    trail of a sampled live search — chosen plane with its downgrade
    reasons, probed lists, pool width, per-query certificate margins,
    fixup/rerun outcome and per-stage timings — emitted by
    :mod:`raft_tpu_torch.observability.explain` when a capture finalizes, so
    the trace shows WHY a request resolved the way it did next to the
    dispatch/flow events of the same request id."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("explain", site, rid=rid, **args)


def emit_alert(slo: str, severity: str, state: str, **args) -> None:
    """One SLO burn-rate alert transition (``alert`` kind): ``state``
    is ``firing`` (both burn windows over threshold) or ``resolved``
    (recovery cleared it) — emitted by
    :mod:`raft_tpu_torch.observability.slo` so pages line up on the same
    timeline as the sheds/deadlines that caused them."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("alert", slo, severity=severity, state=state,
               lane="slo", **args)


def emit_stall(source: str, **args) -> None:
    """One hang-watchdog stall detection (``stall`` kind): ``source``
    names the silent heartbeat (``serving-batcher``) or the overdue
    request set — emitted by :mod:`raft_tpu_torch.observability.watchdog`
    alongside the thread-stack dump it writes into the blackbox, so a
    postmortem can tell a hang from a violent crash."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("stall", source, lane="watchdog", **args)


def emit_epilogue(reason: str, **args) -> None:
    """The clean-shutdown marker (``epilogue`` kind) the blackbox
    records last: a blackbox file whose newest record is NOT an
    epilogue was a violent death (:mod:`raft_tpu_torch.observability
    .blackbox` reconstructs the verdict from exactly this)."""
    rec = get_flight_recorder()
    if not rec.enabled:
        return
    rec.record("epilogue", reason, lane="lifecycle", **args)


# --------------------------------------------------------- drift ledger
class DriftLedger:
    """Per-site history of (predicted, measured) pairs.

    Thread-safe; bounded to ``max_entries`` per site (newest kept).
    ``record()`` computes ``drift_seconds_ratio`` =
    ``max(pred/meas, meas/pred)`` when both sides are present, emits a
    ``drift`` flight event + registry gauge, and persists when the
    ledger has a ``path`` (atomic tmp+rename — a torn write must not
    corrupt the evidence trail)."""

    def __init__(self, path: Optional[str] = None,
                 max_entries: int = 20):
        self.path = path
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[str, List[Dict]] = {}

    # -- record -----------------------------------------------------------
    def record(self, site: str,
               predicted_seconds: Optional[float] = None,
               predicted_bytes: Optional[float] = None,
               measured_seconds: Optional[float] = None,
               measured_bytes: Optional[float] = None,
               measured: bool = False, **extra) -> Dict:
        """Append one entry for ``site``; returns it. Never raises into
        the caller's hot path (persistence failures are logged once)."""
        entry: Dict = {
            "predicted_seconds": predicted_seconds,
            "predicted_bytes": predicted_bytes,
            "measured_seconds": measured_seconds,
            "measured_bytes": measured_bytes,
            "measured": bool(measured),
            "ts": time.time(),
        }
        if extra:
            entry.update(extra)
        if (isinstance(predicted_seconds, (int, float))
                and isinstance(measured_seconds, (int, float))
                and predicted_seconds > 0 and measured_seconds > 0):
            r = predicted_seconds / measured_seconds
            entry["drift_seconds_ratio"] = max(r, 1.0 / r)
        with self._lock:
            hist = self._entries.setdefault(site, [])
            hist.append(entry)
            del hist[:-self.max_entries]
        try:
            from raft_tpu_torch.observability.metrics import get_registry

            reg = get_registry()
            reg.counter(DRIFT_RECORDS, {"site": site},
                        help="Drift-ledger entries recorded").inc()
            ratio = entry.get("drift_seconds_ratio")
            if isinstance(ratio, (int, float)):
                reg.gauge(DRIFT_RATIO, {"site": site},
                          help="Latest |model/measured| seconds ratio "
                               "(1.0 = perfect model)").set(ratio)
        except Exception:
            pass
        rec = get_flight_recorder()
        if rec.enabled:
            rec.record("drift", site, measured=bool(measured),
                       predicted_seconds=predicted_seconds,
                       measured_seconds=measured_seconds,
                       ratio=entry.get("drift_seconds_ratio"))
        if self.path:
            self.save()
        return entry

    # -- queries ----------------------------------------------------------
    def entries(self) -> Dict[str, List[Dict]]:
        with self._lock:
            return {k: [dict(e) for e in v]
                    for k, v in self._entries.items()}

    def latest(self, site: str) -> Optional[Dict]:
        with self._lock:
            hist = self._entries.get(site)
            return dict(hist[-1]) if hist else None

    def sites(self) -> List[str]:
        with self._lock:
            return sorted(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._entries.values())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def merge(self, other: "DriftLedger") -> None:
        """Append ``other``'s per-site histories after this ledger's
        (bounded per site, newest kept) — how a benchmark process folds
        its in-memory entries into the durable repo-root ledger."""
        for site, hist in other.entries().items():
            with self._lock:
                dest = self._entries.setdefault(site, [])
                dest.extend(hist)
                del dest[:-self.max_entries]

    # -- persistence ------------------------------------------------------
    def to_dict(self) -> Dict:
        with self._lock:
            return {"schema": DRIFT_SCHEMA, "band": DRIFT_BAND,
                    "entries": {k: [dict(e) for e in v]
                                for k, v in self._entries.items()}}

    def save(self, path: Optional[str] = None) -> Optional[str]:
        """Atomic write (tmp + fsync + replace + parent-dir fsync);
        returns the path or None on failure (a ledger write must never
        fail a benchmark)."""
        target = path or self.path
        if not target:
            return None
        try:
            payload = self.to_dict()

            def _write(f):
                json.dump(payload, f, indent=1, sort_keys=True,
                          default=str)
                f.write("\n")

            from raft_tpu_torch.core.diskio import atomic_write

            atomic_write(target, _write, mode="w")
            return target
        except Exception as e:
            from raft_tpu_torch.core.logger import log_warn

            log_warn("drift ledger: could not write %s: %s", target, e)
            return None

    @staticmethod
    def load(path: str, max_entries: int = 20) -> "DriftLedger":
        """Read a ledger file; a corrupt or missing file degrades to
        empty and never raises, but not silently: every degraded load
        counts under :data:`DRIFT_DEGRADED` with a once-per-process WARN
        (an absent file is the normal cold state, not a degradation)."""
        led = DriftLedger(path=path, max_entries=max_entries)
        try:
            with open(path) as f:
                data = json.load(f)
        except FileNotFoundError:
            return led
        except Exception as e:
            _ledger_degraded(path, "unreadable",
                             f"{type(e).__name__}: {e}")
            return led
        entries = data.get("entries") if isinstance(data, dict) else None
        if not isinstance(entries, dict):
            _ledger_degraded(path, "invalid",
                             "no entries mapping in the payload")
            return led
        try:
            with led._lock:
                for site, hist in entries.items():
                    if isinstance(hist, list):
                        led._entries[str(site)] = [
                            dict(e) for e in hist
                            if isinstance(e, dict)
                        ][-max_entries:]
        except Exception as e:
            _ledger_degraded(path, "invalid",
                             f"{type(e).__name__}: {e}")
        return led


_global_ledger: Optional[DriftLedger] = None
_ledger_lock = threading.Lock()


def get_drift_ledger() -> DriftLedger:
    """Process-global ledger, created lazily; persists automatically
    when env ``RAFT_TPU_DRIFT_LEDGER`` names a path."""
    global _global_ledger
    with _ledger_lock:
        if _global_ledger is None:
            path = os.environ.get("RAFT_TPU_DRIFT_LEDGER", "").strip()
            _global_ledger = DriftLedger(path=path or None)
        return _global_ledger


def set_drift_ledger(ledger: DriftLedger) -> Optional[DriftLedger]:
    """Swap the process-global ledger (tests). Returns the previous."""
    global _global_ledger
    with _ledger_lock:
        prev, _global_ledger = _global_ledger, ledger
        return prev


def record_drift(site: str, **kw) -> Optional[Dict]:
    """Module-level convenience over :meth:`DriftLedger.record` on the
    process-global ledger; respects the tracing kill switch and never
    raises into the measurement path."""
    try:
        from raft_tpu_torch.observability.metrics import tracing_enabled

        if not tracing_enabled():
            return None
        return get_drift_ledger().record(site, **kw)
    except Exception:
        return None
