"""The closed-loop micro-batching query engine of the port.

Counterpart of ``raft_tpu/serving/engine.py`` (its core: admission,
batching, deadlines, snapshots and warm-up). A thread-safe request queue
coalesces arriving queries into micro-batches, pads each batch up to the
bucket ladder (:mod:`raft_tpu_torch.serving.buckets`) and dispatches it
against an immutable :class:`~raft_tpu_torch.serving.snapshot.
IndexSnapshot` (background rebuild-and-swap for updates: readers never
block on a swap). One batcher thread moves the request rows to the card
and dispatches on the handle's stream (``DeviceResources.stream``).

- **Admission**: a request larger than the top bucket raises
  :class:`RequestTooLargeError` (never truncated); a queue at its row cap
  sheds the request with :class:`OverloadShedError`; a request whose
  deadline expires while queued fails with ``DeadlineExceededError`` when
  its batch is assembled, without a dispatch.
- **Per-batch deadline**: the batcher arms a
  :func:`~raft_tpu_torch.resilience.deadline` scope with the smallest
  remaining budget of the batch; the completion wait polls a CUDA event
  recorded after the dispatch, so a hung dispatch fails that batch with a
  typed error and the engine survives. (The certified pipeline reads its
  certificate-failure count on the host mid-dispatch; a hang before that
  read is not cancellable.) Riders whose own budget is left are re-queued
  once.
- **Warm-up**: :meth:`ServingEngine.start` runs one real dispatch per rung
  against the current snapshot, and every rebuilt snapshot gets the same
  before it is swapped in; both load every kernel library the plane can
  reach. The reference's "zero compiles after warm-up" becomes "zero
  kernel builds and loads after warm-up" (``stats()["builds_after_
  warmup"]``, from ``raft_tpu_torch.ops._build``). PyTorch is eager, so
  there is no executable to cache; CUDA graphs per rung are later work
  (the certified pipeline reads its failure count on the host, so a
  dispatch cannot be captured as it stands).

Planes: ``algorithm="brute"`` (:func:`raft_tpu_torch.runtime.knn_query`
over a bf16 or int8 :class:`~raft_tpu_torch.distance.knn_fused.KnnIndex`;
``db_dtype=`` or ``RAFT_TPU_DB_DTYPE`` is kept through every rebuild),
``algorithm="ivf_flat"`` (``ann.search_ivf_flat``) and
``algorithm="ivf_pq"`` (snapshots built by ``ann.build_ivf_pq`` with
``pq_dim`` / ``pq_bits``, served by ``ann.search_ivf_pq``, warmed by
``ann.warm_pq_scan``).

Not in the port yet, each raising ``NotImplementedError`` when asked for:
``mesh`` (ROADMAP item 7), the mutable and durable planes with
``upsert``/``delete`` (item 10), and the shadow sampler, explain plane,
SLO engine, debugz server, blackbox and watchdog (item 14).

Env knobs: ``RAFT_TPU_SERVING_BUCKETS``, ``RAFT_TPU_SERVING_FLUSH_MS``
(default 2 ms), ``RAFT_TPU_SERVING_QUEUE_CAP`` (4096 rows),
``RAFT_TPU_SERVING_DEADLINE_S`` (none), ``RAFT_TPU_DB_DTYPE``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core import env
from raft_tpu_torch.core.error import (DeadlineExceededError, LogicError,
                                       RaftException, expects)
from raft_tpu_torch.core.resources import DeviceResources, resolve_device
from raft_tpu_torch.ops import _build
from raft_tpu_torch.resilience import deadline, wait_event
from raft_tpu_torch.serving.buckets import bucket_for, bucket_ladder
from raft_tpu_torch.serving.snapshot import (IndexSnapshot, SnapshotStore,
                                             wait_built)

FLUSH_MS_ENV = "RAFT_TPU_SERVING_FLUSH_MS"
QUEUE_CAP_ENV = "RAFT_TPU_SERVING_QUEUE_CAP"
DEADLINE_ENV = "RAFT_TPU_SERVING_DEADLINE_S"

#: requests bumped out of a batch by a neighbour's deadline (their own
#: budget left) are re-queued once, then fail honestly
_MAX_REQUEUES = 1

#: the kernel libraries each plane can reach (warm-up loads them all)
_PLANE_LIBS = {"brute": ("fused_l2_topk",),
               "ivf_flat": ("fine_scan", "fused_l2_topk"),
               "ivf_pq": ("pq_scan", "fused_l2_topk")}

#: options of the reference engine not in the port yet: (ROADMAP item,
#: what they are)
_NOT_PORTED = {
    "mesh": (7, "the query-sharded mesh plane"),
    "mutable": (10, "the mutable plane"),
    "index_ids": (10, "the mutable plane"),
    "compact_threshold": (10, "the mutable plane"),
    "delta_cap": (10, "the mutable plane"),
    "durable": (10, "the durability plane"),
    "durable_dir": (10, "the durability plane"),
    "wal_sync": (10, "the durability plane"),
    "shadow_frac": (14, "the recall shadow sampler"),
    "shadow_floor": (14, "the recall shadow sampler"),
    "explain_frac": (14, "the explain plane"),
    "debug_port": (14, "the debugz server"),
    "blackbox_path": (14, "the crash-durable blackbox"),
    "watchdog_s": (14, "the hang watchdog"),
    "slo": (14, "the SLO burn-rate engine"),
}


def _not_ported(option: str):
    item, what = _NOT_PORTED[option]
    raise NotImplementedError(
        f"ServingEngine: {option}= needs {what}, which is not ported to "
        f"the GPU yet (ROADMAP queue 1, item {item})")


class RequestTooLargeError(LogicError):
    """The request exceeds the largest bucket of the ladder: rejected at
    admission, never truncated (split it, or raise the ladder through
    ``RAFT_TPU_SERVING_BUCKETS``)."""


class OverloadShedError(RaftException):
    """Admission control shed this request: the queue is at its row cap.
    Callers back off and retry; overload never becomes unbounded queueing
    latency."""


class ServingFuture:
    """Completion handle of one submitted request."""

    __slots__ = ("_event", "_vals", "_ids", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._vals = None
        self._ids = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, vals, ids) -> None:
        self._vals, self._ids = vals, ids
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still pending")
        return self._error

    def result(self, timeout: Optional[float] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Block for this request's (values [n, k], ids [n, k]); re-raises
        the request's classified failure."""
        if not self._event.wait(timeout):
            raise TimeoutError("serving request still pending")
        if self._error is not None:
            raise self._error
        return self._vals, self._ids


class _Request:
    __slots__ = ("x", "n", "enqueued_at", "deadline_at", "future",
                 "requeues")

    def __init__(self, x, n, enqueued_at, deadline_at, future):
        self.x = x
        self.n = n
        self.enqueued_at = enqueued_at
        self.deadline_at = deadline_at
        self.future = future
        self.requeues = 0


def execute_batch(plane, snap: IndexSnapshot, x: np.ndarray, bucket: int,
                  n_valid: int, budget_s: Optional[float] = None,
                  stream=None):
    """Dispatch one coalesced micro-batch against one snapshot (reference
    ``:192``): the rows ``x`` [n_valid, d] go to the snapshot's device,
    are padded up to ``bucket`` and run through ``plane(snap, xp)``, which
    returns (vals, ids, n_fail). On a card the dispatch runs on ``stream``.
    With a budget ``budget_s`` it runs inside a :func:`deadline` scope and
    the completion wait polls a CUDA event recorded after the dispatch, so
    a hung dispatch becomes the scope's error; without one, the copy of the
    results to the host is the wait. Returns (vals [n_valid, k], ids
    [n_valid, k]) as numpy, and n_fail."""
    from raft_tpu_torch.distance.knn_fused import pad_query_rows

    dev = snap.index.device

    def _dispatch():
        xt = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        vals, ids, n_fail = plane(snap, pad_query_rows(xt, bucket))
        if budget_s is not None and dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            wait_event(done)
        return (vals[:n_valid].cpu().numpy(), ids[:n_valid].cpu().numpy(),
                n_fail)

    ctx = (torch.cuda.stream(stream) if stream is not None
           else contextlib.nullcontext())
    with ctx:
        if budget_s is None:
            return _dispatch()
        with deadline(budget_s, label="serving_flush"):
            return _dispatch()


class ServingEngine:
    """Dynamic micro-batching KNN serving engine (reference ``:229``).

    ``index`` is a prepared :class:`~raft_tpu_torch.distance.knn_fused.
    KnnIndex` (or, for ``algorithm="ivf_flat"`` / ``"ivf_pq"``, an
    ``IvfFlatIndex`` / ``IvfPqIndex``),
    whose device the engine serves on, or a raw [m, d] matrix, built at
    construction on ``device`` (default ``cuda``; ``device="cpu"`` runs
    the plain twins).

    Lifecycle::

        eng = ServingEngine(index, k=64)
        eng.start()                      # warms every bucket
        vals, ids = eng.submit(q, deadline_s=0.05).result(30)
        eng.update_index(new_y)          # background rebuild-and-swap
        eng.stop()

    ``clock`` is injectable (tests pin a deterministic clock for deadline
    and ageing accounting; the batcher's waits stay real-time).
    """

    def __init__(self, index, k: int, *, res=None, mesh=None,
                 buckets: Union[str, Sequence[int], None] = None,
                 flush_interval_s: Optional[float] = None,
                 max_queue_rows: Optional[int] = None,
                 default_deadline_s: Optional[float] = None,
                 passes: int = 3, metric: str = "l2",
                 T: Optional[int] = None, Qb: Optional[int] = None,
                 g: Optional[int] = None, store_yp: bool = True,
                 rescore: Optional[bool] = None, certify: str = "kernel",
                 algorithm: str = "brute",
                 n_lists: Optional[int] = None,
                 n_probes: Optional[int] = None,
                 pq_dim: Optional[int] = None,
                 pq_bits: Optional[int] = None,
                 db_dtype: Optional[str] = None,
                 shadow_frac: Optional[float] = None,
                 shadow_floor: Optional[float] = None,
                 mutable: bool = False, index_ids=None,
                 compact_threshold: Optional[int] = None,
                 delta_cap: Optional[int] = None, durable: bool = False,
                 durable_dir: Optional[str] = None,
                 wal_sync: Optional[str] = None,
                 explain_frac: Optional[float] = None,
                 debug_port: Optional[int] = None,
                 blackbox_path: Optional[str] = None,
                 watchdog_s: Optional[float] = None, slo=None,
                 clock=time.monotonic, device=None):
        from raft_tpu_torch.ann import IvfFlatIndex, IvfPqIndex
        from raft_tpu_torch.distance.knn_fused import KnnIndex, fused_config

        asked = dict(mesh=mesh, index_ids=index_ids,
                     compact_threshold=compact_threshold,
                     delta_cap=delta_cap, durable_dir=durable_dir,
                     wal_sync=wal_sync, shadow_frac=shadow_frac,
                     shadow_floor=shadow_floor, explain_frac=explain_frac,
                     debug_port=debug_port, blackbox_path=blackbox_path,
                     watchdog_s=watchdog_s, slo=slo)
        for option, value in asked.items():
            if value is not None:
                _not_ported(option)
        if mutable:
            _not_ported("mutable")
        if durable:
            _not_ported("durable")
        if algorithm not in ("brute", "ivf_flat", "ivf_pq"):
            raise ValueError(f"ServingEngine: algorithm must be 'brute', "
                             f"'ivf_flat' or 'ivf_pq', got {algorithm!r}")
        if algorithm != "brute":
            expects(metric == "l2", "ServingEngine: algorithm=%r serves "
                    "metric='l2' only" % (algorithm,))
        self._algorithm = algorithm
        self._n_lists, self._n_probes = n_lists, n_probes
        self._pq_dim, self._pq_bits = pq_dim, pq_bits
        self._rescore, self._certify = rescore, certify
        self._clock = clock
        self.k = int(k)
        # db_dtype threads through every rebuild (None: the plane's
        # default, or the fleet default of RAFT_TPU_DB_DTYPE)
        if db_dtype is None:
            db_dtype = env.raw("RAFT_TPU_DB_DTYPE")
        self._db_dtype = db_dtype
        if isinstance(index, (KnnIndex, IvfFlatIndex)):
            want = ("ivf_pq" if isinstance(index, IvfPqIndex) else
                    "ivf_flat" if isinstance(index, IvfFlatIndex) else
                    "brute")
            if want != algorithm:
                raise ValueError("ServingEngine: prepared index type does "
                                 "not match algorithm=%r" % (algorithm,))
            self.device = index.device
        else:
            self.device = resolve_device(device, index)
        self.res = res if res is not None else DeviceResources(
            device=self.device)
        self._build_kw = dict(passes=passes, metric=metric, T=T, Qb=Qb, g=g,
                              store_yp=store_yp)
        if db_dtype is not None:
            self._build_kw["db_dtype"] = db_dtype
        # background rebuilds run on a stream of their own, so an update
        # overlaps serving; the store publishes a snapshot only once its
        # build stream has finished
        self._build_stream = (torch.cuda.Stream(device=self.device)
                              if self.device.type == "cuda" else None)
        initial = (index if isinstance(index, (KnnIndex, IvfFlatIndex))
                   else self._build_index(index))
        expects(self.k <= initial.n_rows,
                "ServingEngine: k=%d > index size %d", self.k,
                initial.n_rows)
        self.d = initial.d_orig
        self._store = SnapshotStore(self._build_index, initial_index=initial)
        qb_hint = getattr(initial, "Qb", None) or fused_config(3).Qb
        if buckets is None or isinstance(buckets, str):
            self._ladder = bucket_ladder(qb_hint, buckets)
        else:
            self._ladder = bucket_ladder(
                qb_hint, ",".join(str(int(b)) for b in buckets))
        if flush_interval_s is None:
            flush_interval_s = env.get(FLUSH_MS_ENV) / 1e3
        self._flush_interval_s = max(1e-4, float(flush_interval_s))
        if max_queue_rows is None:
            max_queue_rows = env.get(QUEUE_CAP_ENV)
        self._max_queue_rows = max(self._ladder[-1], int(max_queue_rows))
        if default_deadline_s is None:
            default_deadline_s = env.get(DEADLINE_ENV)
        self._default_deadline_s = default_deadline_s

        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._depth_rows = 0
        self._stop = False
        self._busy = False
        self._force_flush = False
        self._thread: Optional[threading.Thread] = None
        self._started = False
        self._latencies: collections.deque = collections.deque(maxlen=4096)
        self._stats = collections.Counter()
        # kernel builds + loads when the last warm-up ended (None: not
        # warmed yet)
        self._builds_at_warmup: Optional[int] = None

    # -- construction helpers --------------------------------------------
    def _build_index(self, y):
        """The plane's index over ``y``, on the engine's device."""
        if not isinstance(y, torch.Tensor):
            y = torch.from_numpy(np.ascontiguousarray(y, np.float32))
        y = y.to(self.device)
        if self._algorithm == "ivf_pq":
            from raft_tpu_torch.ann import build_ivf_pq

            n_lists = self._n_lists or max(
                1, min(1024, int(round(y.shape[0] ** 0.5))))
            return build_ivf_pq(self.res, y, n_lists=n_lists,
                                pq_dim=self._pq_dim, pq_bits=self._pq_bits,
                                n_probes=self._n_probes)
        if self._algorithm == "ivf_flat":
            from raft_tpu_torch.ann import build_ivf_flat

            n_lists = self._n_lists or max(
                1, min(1024, int(round(y.shape[0] ** 0.5))))
            kw = ({"db_dtype": self._db_dtype}
                  if self._db_dtype is not None else {})
            return build_ivf_flat(self.res, y, n_lists=n_lists,
                                  n_probes=self._n_probes, **kw)
        from raft_tpu_torch.distance.knn_fused import prepare_knn_index

        return prepare_knn_index(y, device=self.device, **self._build_kw)

    def _plane(self, snap: IndexSnapshot, xb):
        """The data plane of one padded bucket batch: (vals, ids, n_fail),
        n_fail the queries that paid the exact fixup (brute) or the
        certificate rerun (IVF)."""
        if self._algorithm == "ivf_pq":
            from raft_tpu_torch.ann import search_ivf_pq

            return search_ivf_pq(self.res, snap.index, xb, self.k,
                                 n_probes=self._n_probes, with_stats=True)
        if self._algorithm == "ivf_flat":
            from raft_tpu_torch.ann import search_ivf_flat

            return search_ivf_flat(self.res, snap.index, xb, self.k,
                                   n_probes=self._n_probes, with_stats=True)
        from raft_tpu_torch.runtime import knn_query

        return knn_query(self.res, snap.index, xb, self.k,
                         rescore=self._rescore, certify=self._certify,
                         with_stats=True)

    # -- lifecycle --------------------------------------------------------
    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._ladder

    def start(self) -> "ServingEngine":
        """Warm every bucket against the current snapshot, then start the
        batcher thread. Idempotent."""
        with self._cond:
            if self._started:
                return self
            self._started = True
            self._stop = False
        self._warm_snapshot(self._store.current())
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-batcher", daemon=True)
        self._thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain the queue, then stop the batcher (and wait for a
        background rebuild)."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None
        self._store.wait_for_builds(timeout)
        with self._cond:
            self._started = False

    def _warm_snapshot(self, snap: IndexSnapshot) -> None:
        """One real dispatch per rung against ``snap`` (at start-up, and
        against a rebuilt snapshot before it is swapped in), after loading
        every kernel library the plane can reach: no live request then
        pays a build or a load."""
        b0 = _build.BUILDS + _build.LOADS
        if snap.index.device.type == "cuda":
            for name in _PLANE_LIBS[self._algorithm]:
                _build.load(name)
        for b in self._ladder:
            execute_batch(self._plane, snap,
                          np.zeros((b, self.d), np.float32), b, b,
                          stream=self.res.stream)
            if self._algorithm == "ivf_pq":
                # the ADC scan at every pool depth the widen rung can
                # reach, whichever way the chooser lands on live traffic
                from raft_tpu_torch.ann import warm_pq_scan

                warm_pq_scan(self.res, snap.index, b, self.k,
                             self._n_probes or snap.index.n_probes_default)
        with self._cond:
            self._stats["warmed_buckets"] = len(self._ladder)
            self._stats["warmup_builds"] += _build.BUILDS + _build.LOADS - b0
            self._builds_at_warmup = _build.BUILDS + _build.LOADS

    # -- admission --------------------------------------------------------
    def submit(self, x, deadline_s: Optional[float] = None) -> ServingFuture:
        """Enqueue one request of [n, d] (or [d]) query rows; returns a
        :class:`ServingFuture`. Oversized requests raise
        :class:`RequestTooLargeError`, a full queue
        :class:`OverloadShedError`."""
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x[None]
        expects(x.ndim == 2 and x.shape[1] == self.d,
                "serving: request must be [n, %d] query rows (got %s)",
                self.d, x.shape)
        n = x.shape[0]
        if n == 0:
            fut = ServingFuture()
            fut._complete(np.zeros((0, self.k), np.float32),
                          np.zeros((0, self.k), np.int32))
            return fut
        if n > self._ladder[-1]:
            self._count_request("rejected")
            raise RequestTooLargeError(
                f"serving: request of {n} rows exceeds the largest bucket "
                f"{self._ladder[-1]} — split it client-side or raise the "
                f"ladder (RAFT_TPU_SERVING_BUCKETS)")
        now = self._clock()
        budget = (deadline_s if deadline_s is not None
                  else self._default_deadline_s)
        req = _Request(x, n, now, now + budget if budget else None,
                       ServingFuture())
        with self._cond:
            if self._depth_rows + n > self._max_queue_rows:
                self._stats["requests_shed"] += 1
                self._stats["shed"] += 1
                raise OverloadShedError(
                    f"serving: queue at capacity ({self._depth_rows}/"
                    f"{self._max_queue_rows} rows) — request shed; back "
                    f"off and retry")
            self._queue.append(req)
            self._depth_rows += n
            self._cond.notify_all()
        return req.future

    def query(self, x, deadline_s: Optional[float] = None,
              timeout: Optional[float] = 60.0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience: submit + wait."""
        return self.submit(x, deadline_s=deadline_s).result(timeout)

    def upsert(self, ids, rows, deadline_s: Optional[float] = None):
        """The mutable plane's write path: not ported."""
        _not_ported("mutable")

    def delete(self, ids, deadline_s: Optional[float] = None):
        """The mutable plane's write path: not ported."""
        _not_ported("mutable")

    # -- index updates ----------------------------------------------------
    def update_index(self, y, block: bool = False):
        """Rebuild the index from ``y`` and swap it in — on a background
        thread by default. Queries keep hitting the current snapshot until
        the new one is built, complete on the card and warmed (every rung
        dispatched against it), so readers never block and never pay a
        kernel build. ``y`` is numpy or a tensor (moved to the engine's
        device by the build)."""
        if not isinstance(y, torch.Tensor):
            y = np.asarray(y, np.float32)
        expects(y.ndim == 2 and y.shape[1] == self.d,
                "serving: replacement index must be [m, %d] (got %s)",
                self.d, y.shape)
        expects(self.k <= y.shape[0],
                "serving: k=%d > replacement index size %d", self.k,
                y.shape[0])
        store = self._store

        def _warmed_build(yy, **kw):
            ctx = (torch.cuda.stream(self._build_stream)
                   if self._build_stream is not None
                   else contextlib.nullcontext())
            with ctx:
                idx = self._build_index(yy)
                wait_built(idx)
            if self._started:
                # pre-swap warm-up on a temporary snapshot (the store
                # stamps the generation when it swaps)
                self._warm_snapshot(IndexSnapshot(idx, -1))
            return idx

        prev_build = store._build
        store._build = _warmed_build
        try:
            return store.update(y, block=block)
        finally:
            if block:
                store._build = prev_build

    @property
    def snapshot(self) -> IndexSnapshot:
        return self._store.current()

    # -- counters ---------------------------------------------------------
    def _count_request(self, status: str) -> None:
        with self._cond:
            self._stats[f"requests_{status}"] += 1

    def stats(self) -> dict:
        """Live counters, latency percentiles (engine-side, interpolated),
        the snapshot store's counters, and ``builds_after_warmup``: kernel
        builds and loads since the last warm-up ended (0 is the
        contract)."""
        with self._cond:
            out = dict(self._stats)
            out["queue_rows"] = self._depth_rows
            lat = list(self._latencies)
            at = self._builds_at_warmup
        if lat:
            out["p50_ms"] = 1e3 * float(np.percentile(lat, 50))
            out["p99_ms"] = 1e3 * float(np.percentile(lat, 99))
        out["generation"] = self._store.generation
        out["snapshot"] = self._store.stats()
        out["buckets"] = self._ladder
        out["builds_after_warmup"] = (None if at is None else
                                      _build.BUILDS + _build.LOADS - at)
        return out

    # -- the batcher ------------------------------------------------------
    def flush(self, timeout: float = 30.0) -> bool:
        """Force-drain the queue; True once it is empty and idle."""
        t_end = time.monotonic() + timeout
        with self._cond:
            self._force_flush = True
            self._cond.notify_all()
            while ((self._queue or self._busy)
                   and time.monotonic() < t_end):
                self._cond.wait(0.01)
            drained = not self._queue and not self._busy
            self._force_flush = False
            return drained

    def _pop_batch_locked(self):
        """Greedy pops up to the top bucket, failing queue-expired
        requests on the way (they never cost a dispatch)."""
        now = self._clock()
        batch, expired, total = [], [], 0
        while self._queue:
            req = self._queue[0]
            if req.deadline_at is not None and req.deadline_at <= now:
                self._queue.popleft()
                self._depth_rows -= req.n
                expired.append(req)
                continue
            if total + req.n > self._ladder[-1]:
                break
            self._queue.popleft()
            self._depth_rows -= req.n
            batch.append(req)
            total += req.n
        return batch, total, expired

    def _fail_expired(self, expired) -> None:
        for req in expired:
            self._count_request("deadline")
            with self._cond:
                self._stats["expired_in_queue"] += 1
            req.future._fail(DeadlineExceededError(
                "serving: request deadline expired while queued",
                seconds=(req.deadline_at - req.enqueued_at
                         if req.deadline_at else None)))

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stop:
                    if self._queue:
                        total = sum(r.n for r in self._queue)
                        if (self._force_flush
                                or total >= self._ladder[-1]
                                or self._clock() - self._queue[0].enqueued_at
                                >= self._flush_interval_s):
                            break
                        self._cond.wait(self._flush_interval_s / 2)
                    else:
                        self._cond.wait(self._flush_interval_s)
                if self._stop and not self._queue:
                    self._busy = False
                    self._cond.notify_all()
                    return
                batch, total, expired = self._pop_batch_locked()
                self._busy = bool(batch)
            self._fail_expired(expired)
            if batch:
                try:
                    self._run_batch(batch, total)
                finally:
                    with self._cond:
                        self._busy = False
                        self._cond.notify_all()

    def _run_batch(self, batch, total: int) -> None:
        # one snapshot per batch: every rider sees one index
        snap = self._store.current()
        bucket = bucket_for(total, self._ladder)
        x = (batch[0].x if len(batch) == 1
             else np.concatenate([r.x for r in batch], axis=0))
        now = self._clock()
        budgets = [r.deadline_at - now for r in batch
                   if r.deadline_at is not None]
        budget = min(budgets) if budgets else None
        if budget is not None and budget <= 0:
            # raced to expiry between assembly and dispatch
            self._fail_expired([r for r in batch if r.deadline_at is not None
                                and r.deadline_at <= now])
            batch = [r for r in batch
                     if r.deadline_at is None or r.deadline_at > now]
            if batch:
                self._run_batch(batch, sum(r.n for r in batch))
            return
        with self._cond:
            self._stats["batches"] += 1
            self._stats["padded_rows"] += bucket - total
        try:
            vals, ids, n_fail = execute_batch(
                self._plane, snap, x, bucket, total, budget,
                stream=self.res.stream)
        except DeadlineExceededError as e:
            self._on_batch_deadline(batch, e)
            return
        except Exception as e:
            for req in batch:
                self._count_request("error")
                req.future._fail(e)
            return
        done = self._clock()
        with self._cond:
            self._stats["fixups"] += int(n_fail)
        off = 0
        for req in batch:
            req.future._complete(vals[off:off + req.n], ids[off:off + req.n])
            off += req.n
            self._count_request("ok")
            with self._cond:
                self._latencies.append(max(0.0, done - req.enqueued_at))

    def _on_batch_deadline(self, batch, err: DeadlineExceededError) -> None:
        """A batch deadline fired: requests whose own budget expired fail
        with it; riders with budget left are re-queued once (at the head)
        and fail on a second strike."""
        now = self._clock()
        requeue = []
        for req in batch:
            if req.deadline_at is not None and req.deadline_at <= now:
                self._count_request("deadline")
                req.future._fail(err)
            elif req.requeues >= _MAX_REQUEUES:
                self._count_request("error")
                req.future._fail(err)
            else:
                req.requeues += 1
                requeue.append(req)
        if requeue:
            with self._cond:
                self._stats["requeued"] += len(requeue)
                for req in reversed(requeue):
                    self._queue.appendleft(req)
                    self._depth_rows += req.n
                self._cond.notify_all()
