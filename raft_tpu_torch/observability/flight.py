"""Flight recorder: a process-wide ring buffer of typed timeline events.

Counterpart of ``raft_tpu/observability/flight.py``. The metrics
registry answers "how much"; the flight recorder answers "when": the
admissions, batch flushes, snapshot swaps, deadline scopes, injected
faults, explain records, SLO alerts and watchdog stalls in time order.
The viewer is Perfetto (https://ui.perfetto.dev) through
:func:`raft_tpu_torch.observability.exporters.export_perfetto`.

- **One process-wide recorder** (:func:`get_flight_recorder`), a
  lock-guarded fixed-capacity ring (``collections.deque(maxlen=N)``;
  env ``RAFT_TPU_FLIGHT_EVENTS``, default 4096). Old events fall off
  the back; ``dropped`` counts them so a dump is honest about what it
  no longer holds.
- **Typed events**: every event carries a ``kind`` from
  :data:`KNOWN_EVENT_KINDS`, a ``name``, a monotonic timestamp
  (``time.perf_counter``), a Chrome-trace phase (``ph``: ``"X"``
  complete with ``dur``, ``"i"`` instant, ``s``/``t``/``f`` flow), a
  ``lane`` (the Perfetto track: a thread, ``serving``, ``slo``...) and
  the range ``stack`` at emit time. The emit helpers live in
  :mod:`raft_tpu_torch.observability.timeline`; call sites never build
  raw dicts.
- **Zero-overhead disabled mode**: ``RAFT_TPU_DISABLE_TRACING`` or
  :func:`disable_flight` leaves every ``record()`` as one boolean test.
- **Post-mortem dumps**: when ``RAFT_TPU_FLIGHT_DIR`` is set,
  :func:`post_mortem` writes the ring as Perfetto JSON, at most
  ``RAFT_TPU_FLIGHT_MAX_DUMPS`` (default 16) per process.
  ``DeviceError`` and ``DeadlineExceededError`` carry the newest
  :data:`TAIL_EVENTS` events in their ``flight_tail``.
- **Crash-durable mirror**: with a blackbox installed
  (:mod:`raft_tpu_torch.observability.blackbox`) every event is also
  framed into its memory-mapped ring file.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional

#: the closed vocabulary of timeline event kinds (the reference's tuple,
#: kind for kind, so a trace of either package reads the same way)
KNOWN_EVENT_KINDS = (
    "span",          # instrumented-call complete events (begin+dur)
    "collective",    # collectives with per-shard payload bytes
    "compile",       # kernel-library cache hits/misses, builds
    "dispatch",      # runtime-entry dispatch
    "fault",         # injected faults (resilience.faults)
    "retry",         # bounded-retry attempts (resilience.policy)
    "degradation",   # graceful-degradation ladder rungs
    "deadline",      # deadline scopes armed / fired
    "error",         # classified device errors
    "benchmark",     # benchmark results
    "drift",         # model-vs-measured drift ledger records
    "marker",        # free-form instants (benchmark phases etc.)
    "serving",       # serving engine: enqueue/flush/shed/swap/warmup
    "quality",       # certificate failures / fixups / q8 reruns
    "flow",          # per-request Perfetto flow points (ph s/t/f)
    "mutation",      # mutable-index stream: upsert/delete/
    #                  compact_start/compact_swap/compact_abort/
    #                  checkpoint/recovery
    "explain",       # per-query explain records (observability.explain)
    "alert",         # SLO burn-rate alerts firing/resolving
    #                  (observability.slo)
    "stall",         # hang-watchdog stall detections
    #                  (observability.watchdog)
    "epilogue",      # clean-shutdown marker the blackbox appends last
    #                  (observability.blackbox)
)

#: events attached to DeviceError/DeadlineExceededError payloads
TAIL_EVENTS = 64

DEFAULT_CAPACITY = 4096

FLIGHT_EVENTS_TOTAL = "raft_tpu_flight_events_total"

#: ring evictions surfaced to the registry by :func:`sync_dropped_metric`
#: — truncated evidence must be visible before anyone trusts a dump
FLIGHT_DROPPED = "raft_tpu_flight_dropped_total"

#: crash-durable mirror (an observability.blackbox.BlackBox, installed
#: by blackbox.install()) — None is the disabled state, and the cost of
#: disabled is exactly one module-attribute read + None test per event.
_mirror = None


def _env_capacity() -> int:
    try:
        n = int(os.environ.get("RAFT_TPU_FLIGHT_EVENTS", DEFAULT_CAPACITY))
        return max(16, n)
    except (TypeError, ValueError):
        return DEFAULT_CAPACITY


class FlightRecorder:
    """Lock-guarded fixed-capacity ring of typed timeline events.

    ``enabled`` is the hot-path switch: ``record()`` on a disabled
    recorder returns after one boolean test, allocating nothing. The
    ring itself is a ``deque(maxlen=capacity)`` — append past capacity
    evicts the oldest event (wraparound), counted in ``dropped``.
    """

    def __init__(self, capacity: Optional[int] = None,
                 enabled: bool = True):
        self.enabled = enabled
        self.capacity = capacity if capacity else _env_capacity()
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._seq = 0          # total events ever recorded

    # -- emit -------------------------------------------------------------
    def record(self, kind: str, name: str, ts: Optional[float] = None,
               dur: float = 0.0, ph: str = "i",
               lane: Optional[str] = None,
               stack: Optional[List[str]] = None, **args) -> None:
        """Append one event. ``ts`` is the event's BEGIN time on the
        ``time.perf_counter`` clock (stamped now if omitted); ``dur``
        seconds for ``ph="X"`` complete events. Never raises."""
        if not self.enabled:
            return
        ev: Dict = {"kind": kind, "name": name,
                    "ts": time.perf_counter() if ts is None else ts,
                    "ph": ph,
                    "lane": lane if lane is not None
                    else threading.current_thread().name}
        if dur:
            ev["dur"] = dur
        if stack:
            ev["stack"] = list(stack)
        if args:
            ev.update(args)
        with self._lock:
            self._seq += 1
            self._ring.append(ev)
        # crash-durable mirror, outside the ring lock: the blackbox
        # serializes internally and its append never raises
        bb = _mirror
        if bb is not None:
            bb.append_event(ev)

    # -- queries ----------------------------------------------------------
    def events(self) -> List[Dict]:
        """Snapshot of the ring, oldest first (copies of the dicts so a
        caller cannot mutate recorded history)."""
        with self._lock:
            return [dict(ev) for ev in self._ring]

    def tail(self, n: int = TAIL_EVENTS) -> List[Dict]:
        """The newest ``n`` events, oldest-of-the-tail first."""
        with self._lock:
            if n >= len(self._ring):
                return [dict(ev) for ev in self._ring]
            return [dict(ev) for ev in
                    list(self._ring)[len(self._ring) - n:]]

    @property
    def dropped(self) -> int:
        """Events evicted by wraparound since the last clear()."""
        with self._lock:
            return self._seq - len(self._ring)

    @property
    def seq(self) -> int:
        """Total events ever recorded (monotonic; survives wraparound)."""
        with self._lock:
            return self._seq

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = 0


#: shared do-nothing recorder — what a disabled process records into.
#: One object, never replaced: the disabled fast path is one boolean.
NULL_FLIGHT = FlightRecorder(capacity=16, enabled=False)

# RAFT_TPU_DISABLE_TRACING is the one switch shared with core/nvtx.py and
# the metrics registry: set, it disables ranges, spans, metrics AND the
# flight recorder (the "--no-nvtx build").
_ENV_DISABLED = bool(os.environ.get("RAFT_TPU_DISABLE_TRACING"))

_global_recorder = NULL_FLIGHT if _ENV_DISABLED else FlightRecorder()
_global_lock = threading.Lock()


def get_flight_recorder() -> FlightRecorder:
    """The process-global recorder every timeline helper emits into."""
    return _global_recorder


def set_flight_recorder(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process-global recorder (tests). Returns the previous."""
    global _global_recorder
    with _global_lock:
        prev, _global_recorder = _global_recorder, recorder
        return prev


def enable_flight() -> None:
    """Runtime re-enable (a process started with
    RAFT_TPU_DISABLE_TRACING keeps the shared null recorder — swap in a
    real one with :func:`set_flight_recorder` if you truly want both)."""
    _global_recorder.enabled = _global_recorder is not NULL_FLIGHT


def disable_flight() -> None:
    """Runtime disable: record() becomes a one-boolean no-op."""
    _global_recorder.enabled = False


def flight_enabled() -> bool:
    return _global_recorder.enabled


# ---------------------------------------------------------------- dumps
_dump_lock = threading.Lock()
_dump_count = 0


def flight_dir() -> Optional[str]:
    """The post-mortem dump directory, or None when dumps are off."""
    d = os.environ.get("RAFT_TPU_FLIGHT_DIR", "").strip()
    return d or None


def _max_dumps() -> int:
    try:
        return int(os.environ.get("RAFT_TPU_FLIGHT_MAX_DUMPS", "16"))
    except (TypeError, ValueError):
        return 16


def post_mortem(trigger: str, error: Optional[BaseException] = None,
                directory: Optional[str] = None) -> Optional[str]:
    """Dump the ring as Perfetto JSON for post-mortem analysis.

    Writes ``flight_<pid>_<seq>_<trigger>.json`` into ``directory`` (or
    ``RAFT_TPU_FLIGHT_DIR``; no-op returning None when neither is set,
    when the recorder is disabled/empty, or past the per-process dump
    cap). The file is the standard Chrome trace-event object — open it
    at https://ui.perfetto.dev — with a ``raft_tpu`` metadata section
    recording the trigger, the error and the drop count. NEVER raises:
    a failed dump must not mask the error being diagnosed."""
    global _dump_count
    try:
        rec = get_flight_recorder()
        out_dir = directory or flight_dir()
        if out_dir is None or not rec.enabled or not len(rec):
            return None
        with _dump_lock:
            if _dump_count >= _max_dumps():
                return None
            _dump_count += 1
            n = _dump_count
        from raft_tpu_torch.observability.exporters import export_perfetto

        trace = export_perfetto(rec)
        trace["raft_tpu"] = {
            "trigger": trigger,
            "error": f"{type(error).__name__}: {error}"[:500]
            if error is not None else None,
            "dropped_events": rec.dropped,
            "wallclock": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime()),
        }
        os.makedirs(out_dir, exist_ok=True)
        safe = "".join(c if c.isalnum() or c in "-_." else "-"
                       for c in trigger)[:64]
        path = os.path.join(
            out_dir, f"flight_{os.getpid()}_{n:03d}_{safe}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(trace, f, indent=1, default=str)
            f.write("\n")
        os.replace(tmp, path)
        return path
    except Exception:
        return None


_dropped_sync_lock = threading.Lock()
_dropped_exported = 0


def sync_dropped_metric(recorder: Optional[FlightRecorder] = None) -> int:
    """Fold ring evictions since the last sync into the monotone
    :data:`FLIGHT_DROPPED` counter; returns the recorder's current
    ``dropped`` count. Called from /statusz renders, watchdog ticks and
    blackbox snapshots — cheap (two lock-guarded reads) and never
    raises past the registry. A ``clear()`` (which resets ``dropped``)
    only rebaselines: the counter never decrements."""
    rec = recorder if recorder is not None else _global_recorder
    dropped = rec.dropped
    global _dropped_exported
    with _dropped_sync_lock:
        delta = dropped - _dropped_exported
        _dropped_exported = dropped
    if delta > 0:
        try:
            from raft_tpu_torch.observability.metrics import get_registry

            get_registry().counter(
                FLIGHT_DROPPED,
                help="Flight-recorder events evicted by ring wraparound",
            ).inc(delta)
        except Exception:
            pass
    return dropped


def error_tail() -> List[Dict]:
    """The last-:data:`TAIL_EVENTS` events, for attaching to a
    classified error's payload ([] when disabled — no allocation on the
    disabled path). Never raises."""
    try:
        rec = get_flight_recorder()
        if not rec.enabled:
            return []
        return rec.tail(TAIL_EVENTS)
    except Exception:
        return []
