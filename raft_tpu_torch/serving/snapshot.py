"""Immutable index snapshots with background rebuild-and-swap.

Counterpart of ``raft_tpu/serving/snapshot.py``. The serving engine
queries an :class:`IndexSnapshot` — a frozen (prepared index, generation)
pair — taken once per micro-batch, so every request of a batch sees one
index even while an update is in flight.

- ``current()`` is a bare attribute read: readers never block on a swap.
- ``update(y)`` rebuilds on a background thread and swaps the new
  snapshot in when it is built. A failed build leaves the current
  snapshot in place (counted, logged, never raised into the query path).
- Generations are monotonic; a build that finishes after a newer
  generation was installed is coalesced away (counted).
- A snapshot is published only once its index is complete on the card:
  the build's stream records an event that is synchronized before the
  swap, so a batch on another stream never reads a half-written index.

Swaps, failed and coalesced rebuilds and the rebuilds in flight are
plain counters (:meth:`SnapshotStore.stats`) and also the reference's
registry metrics; a swap is a ``serving`` timeline event. A rebuild runs
in the ``serving.build_snapshot`` span and carries the
``serving_snapshot`` fault site.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Callable, Optional

import torch

from raft_tpu_torch.observability import instrument
from raft_tpu_torch.resilience.faults import fault_point

_log = logging.getLogger(__name__)

SNAPSHOT_SWAPS = "raft_tpu_serving_snapshot_swaps_total"
SNAPSHOT_FAILURES = "raft_tpu_serving_snapshot_failures_total"
#: the generation being served, as a gauge
SNAPSHOT_GENERATION = "raft_tpu_serving_snapshot_generation"
#: background rebuilds in flight
REBUILD_INFLIGHT = "raft_tpu_serving_snapshot_rebuild_inflight"
#: builds whose swap a newer generation won
SNAPSHOT_COALESCED = "raft_tpu_serving_snapshot_coalesced_total"


def _metric(kind: str, name: str, help: str, value: float = 1.0) -> None:
    """One registry write (counter ``inc`` or gauge ``set``); never
    raises into the rebuild path."""
    try:
        from raft_tpu_torch.observability.metrics import get_registry

        reg = get_registry()
        if kind == "gauge":
            reg.gauge(name, help=help).set(value)
        else:
            reg.counter(name, help=help).inc(value)
    except Exception:
        pass


class IndexSnapshot:
    """One frozen (index, generation) pair; nothing in it is mutated
    after construction."""

    __slots__ = ("index", "generation", "n_rows")

    def __init__(self, index, generation: int):
        self.index = index
        self.generation = generation
        self.n_rows = int(getattr(index, "n_rows", 0))

    @property
    def device(self) -> torch.device:
        return self.index.device

    def __repr__(self):
        return (f"IndexSnapshot(gen={self.generation}, "
                f"n_rows={self.n_rows})")


def wait_built(index) -> None:
    """Block until the work queued on the calling thread's current stream
    (the index's build) has finished on the card; a no-op on the CPU."""
    dev = getattr(index, "device", None)
    if dev is not None and torch.device(dev).type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        done.synchronize()


@instrument("serving.build_snapshot")
def build_snapshot(y, build: Callable, generation: int,
                   **build_kw) -> IndexSnapshot:
    """One snapshot: ``build(y, **build_kw)`` (the engine passes the index
    build of its data plane), complete on the card before it returns.
    Carries the ``serving_snapshot`` fault site."""
    fault_point("serving_snapshot")
    index = build(y, **build_kw)
    wait_built(index)
    return IndexSnapshot(index, generation)


def _swapped(snap: IndexSnapshot) -> None:
    """Registry and timeline record of one installed snapshot."""
    _metric("counter", SNAPSHOT_SWAPS, "Index snapshot swaps installed")
    _metric("gauge", SNAPSHOT_GENERATION, "Generation of the "
            "currently-serving index snapshot", snap.generation)
    try:
        from raft_tpu_torch.observability.timeline import emit_serving

        emit_serving("swap", generation=snap.generation, n_rows=snap.n_rows,
                     db_dtype=getattr(snap.index, "db_dtype", None))
    except Exception:
        pass


class SnapshotStore:
    """Holder of the current :class:`IndexSnapshot` and the background
    rebuild machinery. ``current()`` is one attribute read; swaps and
    generation accounting hold a small lock."""

    def __init__(self, build: Callable, initial_index=None):
        self._build = build
        self._lock = threading.Lock()
        self._generation = 0
        self._current: Optional[IndexSnapshot] = None
        self._build_thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self._counts = collections.Counter()
        if initial_index is not None:
            wait_built(initial_index)
            self._current = IndexSnapshot(initial_index, 0)

    # -- readers (lock-free) ---------------------------------------------
    def current(self) -> Optional[IndexSnapshot]:
        """The live snapshot: a bare attribute read."""
        return self._current

    @property
    def generation(self) -> int:
        """The newest generation requested (installed or in flight)."""
        return self._generation

    @property
    def last_error(self) -> Optional[BaseException]:
        """The most recent failed rebuild's error (diagnostic only)."""
        return self._last_error

    def stats(self) -> dict:
        """Swaps installed, rebuilds failed and coalesced away, rebuilds
        in flight, and the generation being served."""
        with self._lock:
            out = {k: self._counts[k] for k in
                   ("swaps", "failures", "coalesced", "rebuild_inflight")}
        cur = self._current
        out["current_generation"] = cur.generation if cur else None
        return out

    # -- writers ----------------------------------------------------------
    def update(self, y, block: bool = False, **build_kw):
        """Rebuild from ``y`` and swap when ready: on a background thread
        (returned) by default, inline with ``block=True``. A failed build
        is counted and recorded, and the current snapshot stays."""
        with self._lock:
            self._generation += 1
            gen = self._generation

        def _run():
            with self._lock:
                self._counts["rebuild_inflight"] += 1
                inflight = self._counts["rebuild_inflight"]
            _metric("gauge", REBUILD_INFLIGHT, "Background snapshot "
                    "rebuilds currently in flight", inflight)
            try:
                snap = build_snapshot(y, self._build, gen, **build_kw)
            except Exception as e:
                self._last_error = e
                with self._lock:
                    self._counts["failures"] += 1
                _metric("counter", SNAPSHOT_FAILURES,
                        "Index snapshot rebuilds that failed (old "
                        "snapshot kept serving)")
                _log.warning("serving: snapshot rebuild (gen %d) failed "
                             "(%s: %s) — keeping the current snapshot",
                             gen, type(e).__name__, str(e)[:200])
                return
            finally:
                with self._lock:
                    self._counts["rebuild_inflight"] -= 1
                    inflight = self._counts["rebuild_inflight"]
                _metric("gauge", REBUILD_INFLIGHT, "Background snapshot "
                        "rebuilds currently in flight", inflight)
            with self._lock:
                # last requested wins: a build older than the installed
                # generation is coalesced away, counted (checked and
                # swapped under one lock, so two racing builds cannot
                # install out of order)
                cur = self._current
                coalesced = cur is not None and cur.generation > gen
                if coalesced:
                    self._counts["coalesced"] += 1
                else:
                    self._current = snap
                    self._counts["swaps"] += 1
            if coalesced:
                _metric("counter", SNAPSHOT_COALESCED,
                        "Snapshot rebuilds coalesced away by a newer "
                        "generation winning the race")
                return
            _swapped(snap)

        if block:
            _run()
            return None
        t = threading.Thread(target=_run, name=f"snapshot-build-{gen}",
                             daemon=True)
        with self._lock:
            self._build_thread = t
        t.start()
        return t

    def wait_for_builds(self, timeout: Optional[float] = None) -> None:
        """Join the most recent background build."""
        t = self._build_thread
        if t is not None:
            t.join(timeout)
