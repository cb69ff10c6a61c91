"""Hang watchdog: heartbeat tracking + thread-stack dumps into the blackbox
(counterpart of ``raft_tpu/observability/watchdog.py``).

A SIGKILL leaves an epilogue-less blackbox and the verdict is easy. A
*hang* is worse: the process is alive, /statusz still answers, but the
batcher thread is wedged (a deadlock, a stuck collective, an interpreter
pile-up) and every queued request silently ages past its deadline. The
watchdog is the component that notices — and that writes down WHAT the
process was doing while it still can, because once someone kill -9's
the hung process, the stacks are gone.

Discipline (the SloEngine model): the watchdog is a daemon thread that
ticks on its own clock and NEVER sleeps or does I/O while holding a
lock. Heartbeats land under a tiny dedicated lock; engine state is read
through :meth:`ServingEngine.inflight_requests`, which takes the
batcher cond only long enough to copy the queue. On a stall — a
heartbeat silent past ``stall_after_s``, or an in-flight request aged
past its deadline by more than a tick — it:

- dumps every Python thread stack (``sys._current_frames``), each
  annotated with its *blocked-at* site (the innermost non-``threading``
  frame beneath a ``wait``/``acquire``/``join``), plus the in-flight
  request table, into the blackbox as a ``dump`` record;
- emits one ``stall`` flight event (mirrored into the blackbox too),
  latched once per stall episode so a wedged batcher does not flood
  the ring it is trying to preserve.

Each healthy tick also drives the blackbox's periodic metrics snapshot
and folds flight-ring evictions into ``raft_tpu_flight_dropped_total``.
Enable with ``RAFT_TPU_WATCHDOG_S`` (tick seconds; unset/0 = off, the
defaults-off contract) or ``ServingEngine(watchdog_s=...)``; live
dumps are served read-only at debugz ``/stackz``.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

from raft_tpu_torch.core import env

WATCHDOG_ENV = "RAFT_TPU_WATCHDOG_S"

#: a heartbeat is stalled after this many tick intervals of silence
STALL_TICKS = 4

#: threading.py functions that mean "this thread is parked on a lock" —
#: the first frame beneath them is the blocked-at site
_WAIT_FNS = frozenset(
    {"wait", "wait_for", "acquire", "join", "_wait_for_tstate_lock"})


def interval_from_env() -> Optional[float]:
    """The configured tick interval, or None when the watchdog is off."""
    try:
        s = env.get(WATCHDOG_ENV)
        if s is None:
            return None
        val = float(s)
        return val if val > 0 else None
    except (TypeError, ValueError):
        return None


# ----------------------------------------------------------- stack dumps
def dump_stacks() -> Dict:
    """Every Python thread's stack as a JSON-friendly dict: thread
    name/ident/daemon flag, outermost-first frames, and the blocked-at
    annotation for threads parked inside :mod:`threading`. Read-only
    and lock-free (``sys._current_frames`` snapshots atomically under
    the GIL); safe to call from any thread, including /stackz."""
    frames = sys._current_frames()
    by_ident = {t.ident: t for t in threading.enumerate()}
    threads: List[Dict] = []
    for ident, frame in frames.items():
        t = by_ident.get(ident)
        stack = traceback.extract_stack(frame)
        entries = [{"where": f"{fs.filename}:{fs.lineno}",
                    "fn": fs.name, "code": fs.line or ""}
                   for fs in stack]
        threads.append({
            "name": t.name if t else f"ident-{ident}",
            "ident": ident,
            "daemon": bool(t.daemon) if t else None,
            "blocked_at": _blocked_at(stack),
            "frames": entries,
        })
    threads.sort(key=lambda d: str(d["name"]))
    return {"pid": os.getpid(), "ts": time.perf_counter(),
            "wall": time.time(), "threads": threads}


def _blocked_at(stack: List[traceback.FrameSummary]) -> Optional[str]:
    """The held-lock site: for a thread whose innermost frames sit in
    ``threading.py`` ``wait``/``acquire``/``join``, the first frame
    beneath them — i.e. the caller that took the lock. None for a
    running (or C-blocked) thread."""
    waiting = False
    for fs in reversed(stack):
        if os.path.basename(fs.filename) == "threading.py":
            if fs.name in _WAIT_FNS:
                waiting = True
            continue
        if waiting:
            return f"{fs.filename}:{fs.lineno} in {fs.name}"
        return None
    return None


def format_stacks(dump: Optional[Dict] = None) -> str:
    """The human rendering of :func:`dump_stacks` (the /stackz body)."""
    d = dump if dump is not None else dump_stacks()
    lines = [f"thread dump — pid {d['pid']} — "
             f"{len(d['threads'])} thread(s)", ""]
    for t in d["threads"]:
        head = f"== {t['name']} (ident {t['ident']}"
        if t.get("daemon"):
            head += ", daemon"
        head += ")"
        if t.get("blocked_at"):
            head += f" blocked at {t['blocked_at']}"
        lines.append(head)
        for fr in t["frames"]:
            lines.append(f"  {fr['where']} in {fr['fn']}")
            if fr["code"]:
                lines.append(f"    {fr['code']}")
        lines.append("")
    return "\n".join(lines)


# -------------------------------------------------------------- watchdog
class Watchdog:
    """Daemon-thread hang detector over named heartbeats + an engine's
    in-flight request table.

    ``clock`` is injectable (tests drive :meth:`tick` by hand with a
    fake monotonic clock); ``engine`` is duck-typed to anything with an
    ``inflight_requests()`` method. ``stall_after_s`` defaults to
    :data:`STALL_TICKS` intervals of silence.
    """

    def __init__(self, engine=None, interval_s: Optional[float] = None,
                 stall_after_s: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if interval_s is None:
            interval_s = interval_from_env()
        self.interval_s = float(interval_s) if interval_s else 0.0
        self.stall_after_s = (float(stall_after_s) if stall_after_s
                              else max(self.interval_s * STALL_TICKS,
                                       0.001))
        self._engine = engine
        self._clock = clock
        self._beat_lock = threading.Lock()
        self._beats: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._stall_active = False
        self.ticks = 0
        self.stalls = 0

    @property
    def enabled(self) -> bool:
        return self.interval_s > 0

    # -- heartbeats (the hot path: one dict store under a tiny lock) ------
    def beat(self, name: str = "serving-batcher") -> None:
        """Record one liveness heartbeat (the batcher calls this every
        loop iteration, OUTSIDE its cond lock)."""
        now = self._clock()
        with self._beat_lock:
            self._beats[name] = now

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "Watchdog":
        """Start the daemon tick thread (no-op when disabled)."""
        if not self.enabled or self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, 2 * self.interval_s))
            self._thread = None

    def _loop(self) -> None:
        # Event.wait is the sleep — no lock is ever held across it
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:
                # the watchdog must never take the process down
                pass

    # -- detection ---------------------------------------------------------
    def tick(self) -> Optional[Dict]:
        """One detection pass. Returns the stall-dump dict when THIS
        tick opened a stall episode, else None."""
        self.ticks += 1
        now = self._clock()
        with self._beat_lock:
            beats = dict(self._beats)
        stalled = {name: now - t for name, t in beats.items()
                   if now - t > self.stall_after_s}
        inflight: List[Dict] = []
        if self._engine is not None:
            try:
                inflight = self._engine.inflight_requests()
            except Exception:
                inflight = []
        overdue = [r for r in inflight if self._is_overdue(r)]
        from raft_tpu_torch.observability import blackbox, flight

        flight.sync_dropped_metric()
        bb = blackbox.active()
        if not stalled and not overdue:
            self._stall_active = False
            if bb is not None:
                bb.maybe_snapshot(inflight=inflight or None)
            return None
        if self._stall_active:
            return None      # one dump per episode — no ring flooding
        self._stall_active = True
        self.stalls += 1
        source = (next(iter(sorted(stalled)))
                  if stalled else "inflight-deadline")
        age = (max(stalled.values()) if stalled
               else max((r.get("age_s") or 0.0) for r in overdue))
        dump = dump_stacks()
        dump["trigger"] = {"source": source,
                           "stalled_heartbeats": stalled,
                           "overdue_requests": len(overdue),
                           "age_s": age}
        dump["inflight"] = inflight
        if bb is not None:
            bb.dump(dump)
            bb.snapshot(inflight=inflight or None)
        from raft_tpu_torch.observability.timeline import emit_stall

        emit_stall(source, age_s=age, inflight=len(inflight),
                   overdue=len(overdue), stalls=self.stalls)
        return dump

    def _is_overdue(self, req: Dict) -> bool:
        deadline_in = req.get("deadline_in_s")
        if deadline_in is not None:
            # a request past its deadline by more than a full tick means
            # nobody is failing expired requests — the batcher is gone
            return deadline_in < -max(self.interval_s, 0.001)
        return (req.get("age_s") or 0.0) > self.stall_after_s

    def stats(self) -> Dict:
        with self._beat_lock:
            beats = dict(self._beats)
        now = self._clock()
        return {"enabled": self.enabled,
                "interval_s": self.interval_s,
                "stall_after_s": self.stall_after_s,
                "ticks": self.ticks,
                "stalls": self.stalls,
                "stall_active": self._stall_active,
                "heartbeats": {k: round(now - v, 6)
                               for k, v in beats.items()}}
