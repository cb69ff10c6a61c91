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

The reference's gauges and counters of the metrics registry are plain
counters here, read through :meth:`SnapshotStore.stats`.
"""

from __future__ import annotations

import collections
import logging
import threading
from typing import Callable, Optional

import torch

_log = logging.getLogger(__name__)


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


def build_snapshot(y, build: Callable, generation: int,
                   **build_kw) -> IndexSnapshot:
    """One snapshot: ``build(y, **build_kw)`` (the engine passes the index
    build of its data plane), complete on the card before it returns."""
    index = build(y, **build_kw)
    wait_built(index)
    return IndexSnapshot(index, generation)


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
            try:
                snap = build_snapshot(y, self._build, gen, **build_kw)
            except Exception as e:
                self._last_error = e
                with self._lock:
                    self._counts["failures"] += 1
                _log.warning("serving: snapshot rebuild (gen %d) failed "
                             "(%s: %s) — keeping the current snapshot",
                             gen, type(e).__name__, str(e)[:200])
                return
            finally:
                with self._lock:
                    self._counts["rebuild_inflight"] -= 1
            with self._lock:
                # last requested wins: a build older than the installed
                # generation is coalesced away, counted (checked and
                # swapped under one lock, so two racing builds cannot
                # install out of order)
                cur = self._current
                if cur is not None and cur.generation > gen:
                    self._counts["coalesced"] += 1
                    return
                self._current = snap
                self._counts["swaps"] += 1

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
