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

**Mutable and durable planes** (``mutable=True``, reference ``:331-404``):
the engine fronts a :class:`~raft_tpu_torch.mutable.MutableIndex` (over
any of the three planes; ``index_ids`` are its external ids,
``compact_threshold`` / ``delta_cap`` its fold watermark and delta
capacity). Each batch searches one ``MutableView``; :meth:`ServingEngine.
upsert` and :meth:`ServingEngine.delete` ride the query queue under the
same admission control, each a strict ordering barrier applied alone on
the batcher thread, so the queries behind it see it and the ones before
do not. ``durable=True`` implies ``mutable=True``: mutations are
write-ahead logged under ``durable_dir`` (or ``RAFT_TPU_DURABLE_DIR``)
with ``wal_sync``, and an engine built over a directory that holds
durable state recovers from it.

**Operations planes** (reference ``:31-56``, ``:455-494``): every
admitted request, flush, shed and swap is a ``serving`` timeline event
and every request a Perfetto flow (``enqueue`` → ``batch`` →
``dispatch`` → ``response``); queue depth is a gauge, request latency a
histogram and every batch, bucket and shed a labeled counter of the
metrics registry (``stats()`` reads its p50/p99 from the engine's own
window, the counters from the registry). The batch dispatch is the
``serving.execute_batch`` span and carries the ``serving_flush`` fault
site; admission carries ``serving_enqueue``. On by default, as in the
reference: the registry, the timeline and the SLO burn-rate engine
(``slo=`` injects one). Off by default, each an option or an env knob:

- ``shadow_frac`` / ``shadow_floor`` — the recall shadow sampler
  re-scores a hash-sampled fraction of served requests against the
  exact oracle of the current snapshot (brute: ``knn_fused`` on the
  same index; IVF-Flat / IVF-PQ: their search at ``n_probes =
  n_lists``), on a thread and, on the card, a CUDA stream of its own,
  up to 16 queued samples to one oracle call;
- ``explain_frac`` — per-batch explain records (plane, parameters,
  certificate margins per query) for hash-sampled requests;
- ``debug_port`` — the debugz HTTP server
  (:class:`raft_tpu_torch.tools.debugz.DebugzServer`);
- ``blackbox_path`` — the crash-durable blackbox; an engine started over
  a prior run's unclean file keeps it as ``<path>.prev`` and serves its
  reconstruction at ``/crashz``;
- ``watchdog_s`` — the hang watchdog, fed by a heartbeat per batcher
  loop.

Telemetry never raises into serving: each write sits in a ``try`` as in
the reference. ``mesh`` (ROADMAP item 7) raises ``NotImplementedError``.

Env knobs: ``RAFT_TPU_SERVING_BUCKETS``, ``RAFT_TPU_SERVING_FLUSH_MS``
(default 2 ms), ``RAFT_TPU_SERVING_QUEUE_CAP`` (4096 rows),
``RAFT_TPU_SERVING_DEADLINE_S`` (none), ``RAFT_TPU_DB_DTYPE``,
``RAFT_TPU_DURABLE_DIR``, ``RAFT_TPU_SERVING_SHADOW_FRAC`` /
``_FLOOR``, ``RAFT_TPU_EXPLAIN_FRAC``, ``RAFT_TPU_DEBUGZ_PORT``,
``RAFT_TPU_BLACKBOX_PATH``, ``RAFT_TPU_WATCHDOG_S``, ``RAFT_TPU_FAULTS``
and ``RAFT_TPU_DISABLE_TRACING``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core import env
from raft_tpu_torch.core.error import (DeadlineExceededError, LogicError,
                                       RaftException, expects)
from raft_tpu_torch.core.logger import log_warn
from raft_tpu_torch.core.resources import DeviceResources, resolve_device
from raft_tpu_torch.observability import explain as explain_mod
from raft_tpu_torch.observability import instrument
from raft_tpu_torch.observability.metrics import percentile
from raft_tpu_torch.observability.quality import (ShadowSampler,
                                                  shadow_floor_default,
                                                  shadow_frac_default)
from raft_tpu_torch.observability.timeline import emit_flow, emit_serving
from raft_tpu_torch.ops import _build
from raft_tpu_torch.resilience import deadline, wait_event
from raft_tpu_torch.resilience.faults import fault_point
from raft_tpu_torch.resilience.policy import record_degradation
from raft_tpu_torch.serving.buckets import bucket_for, bucket_ladder
from raft_tpu_torch.serving.snapshot import (IndexSnapshot, SnapshotStore,
                                             wait_built)

# metric names (the serving slice of the registry vocabulary)
REQUESTS = "raft_tpu_serving_requests_total"
LATENCY = "raft_tpu_serving_latency_seconds"
QUEUE_DEPTH = "raft_tpu_serving_queue_rows"
BATCHES = "raft_tpu_serving_batches_total"
BATCH_PAD_ROWS = "raft_tpu_serving_batch_pad_rows_total"
SHED = "raft_tpu_serving_shed_total"

FLUSH_MS_ENV = "RAFT_TPU_SERVING_FLUSH_MS"
QUEUE_CAP_ENV = "RAFT_TPU_SERVING_QUEUE_CAP"
DEADLINE_ENV = "RAFT_TPU_SERVING_DEADLINE_S"

#: requests bumped out of a batch by a neighbour's deadline (their own
#: budget left) are re-queued once, then fail honestly
_MAX_REQUEUES = 1

#: the kernel libraries each plane can reach (warm-up loads them all)
_PLANE_LIBS = {"brute": ("fused_l2_packed_sm90", "fused_l2_topk"),
               "ivf_flat": ("fine_scan", "fused_l2_packed_sm90",
                            "fused_l2_topk"),
               "ivf_pq": ("pq_scan", "fused_l2_packed_sm90",
                          "fused_l2_topk")}

#: options of the reference engine not in the port yet: (ROADMAP item,
#: what they are)
_NOT_PORTED = {"mesh": (7, "the query-sharded mesh plane")}


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
                 "requeues", "rid", "kind", "ids", "explain")

    def __init__(self, x, n, enqueued_at, deadline_at, future, rid=0,
                 kind: str = "query", ids=None, explain: bool = False):
        self.x = x
        self.n = n
        self.enqueued_at = enqueued_at
        self.deadline_at = deadline_at
        self.future = future
        self.requeues = 0
        self.rid = rid          # monotonic flow-trace id (enqueue order)
        self.kind = kind        # "query" | "upsert" | "delete"
        self.ids = ids          # external row ids of a mutation
        self.explain = explain  # capture an explain record for the batch


@instrument("serving.execute_batch")
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
    results to the host is the wait. Carries the ``serving_flush`` fault
    site, inside the deadline scope, so an injected hang converts like a
    stuck dispatch. Returns (vals [n_valid, k], ids [n_valid, k]) as
    numpy, and n_fail."""
    from raft_tpu_torch.distance.knn_fused import pad_query_rows

    emit_serving("flush", bucket=bucket, rows=n_valid,
                 generation=snap.generation, budget_s=budget_s)
    dev = snap.device

    def _dispatch():
        fault_point("serving_flush")
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

        if mesh is not None:
            _not_ported("mesh")
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
        prepared = isinstance(index, (KnnIndex, IvfFlatIndex))
        if prepared:
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
        # durable=True writes every mutation ahead to durable_dir and
        # recovers from it when it already holds durable state; it
        # implies mutable=True
        self._durable = bool(durable)
        self._recovery = None
        if durable:
            mutable = True
            if durable_dir is None:
                durable_dir = env.raw("RAFT_TPU_DURABLE_DIR")
            expects(durable_dir is not None,
                    "serving: durable=True needs durable_dir= (or "
                    "RAFT_TPU_DURABLE_DIR)")
        # mutable=True: the engine fronts a MutableIndex, whose snapshot
        # store is the engine's
        self._mutable = None
        if mutable:
            self._mutable = self._mutable_index(
                index, prepared, index_ids, durable_dir if durable else None,
                wal_sync, dict(algorithm=algorithm, passes=passes,
                               metric=metric, T=T, Qb=Qb, g=g,
                               db_dtype=db_dtype, n_lists=n_lists,
                               n_probes=n_probes, pq_dim=pq_dim,
                               pq_bits=pq_bits,
                               compact_threshold=compact_threshold,
                               delta_cap=delta_cap))
            expects(self.k <= self._mutable.n_rows,
                    "ServingEngine: k=%d > index size %d", self.k,
                    self._mutable.n_rows)
            self.d = self._mutable.d_orig
            self._store = self._mutable.store
            qb_hint = self._mutable.Qb
        else:
            initial = index if prepared else self._build_index(index)
            expects(self.k <= initial.n_rows,
                    "ServingEngine: k=%d > index size %d", self.k,
                    initial.n_rows)
            self.d = initial.d_orig
            self._store = SnapshotStore(self._build_index,
                                        initial_index=initial)
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
        self._rids = itertools.count(1)     # per-request flow-trace ids
        # the recall shadow sampler: frac 0 = off; the constructor wins
        # over RAFT_TPU_SERVING_SHADOW_FRAC / _FLOOR
        self._shadow_frac = (shadow_frac_default() if shadow_frac is None
                             else max(0.0, min(1.0, float(shadow_frac))))
        self._shadow_floor = (shadow_floor_default() if shadow_floor is None
                              else float(shadow_floor))
        self._shadow: Optional[ShadowSampler] = None
        # the shadow oracle's own stream, so its re-scores do not queue
        # behind (or hold up) the batcher's dispatches
        self._shadow_stream = (torch.cuda.Stream(device=self.device)
                               if self.device.type == "cuda" else None)
        # per-batch explain capture: frac 0 = off; the constructor wins
        # over RAFT_TPU_EXPLAIN_FRAC; submit(explain=True) forces one
        self._explain_frac = (explain_mod.explain_frac_default()
                              if explain_frac is None
                              else max(0.0, min(1.0, float(explain_frac))))
        # the windowed SLO burn-rate engine: always on (one registry
        # snapshot per window interval); injectable
        if slo is None:
            from raft_tpu_torch.observability.slo import SloEngine

            slo = SloEngine(clock=self._clock)
        self._slo = slo
        # debugz server: the constructor wins over RAFT_TPU_DEBUGZ_PORT
        # (0 = ephemeral port; None = no server)
        if debug_port is None:
            debug_port = env.get("RAFT_TPU_DEBUGZ_PORT")
        self._debug_port = debug_port
        self._debugz = None
        # forensics: the crash-durable blackbox and the hang watchdog,
        # both off by default (RAFT_TPU_BLACKBOX_PATH / RAFT_TPU_WATCHDOG_S)
        self._blackbox_path = blackbox_path
        self._watchdog_s = watchdog_s
        self._blackbox = None
        self._owns_blackbox = False
        self._watchdog = None
        self._crash_report: Optional[dict] = None

    # -- construction helpers --------------------------------------------
    def _mutable_index(self, index, prepared: bool, index_ids, durable_dir,
                       wal_sync, mut_kw: dict):
        """The engine's MutableIndex: recovered from ``durable_dir`` when
        it holds durable state, else built over ``index`` (durable when a
        directory is given)."""
        from raft_tpu_torch.mutable import MutableIndex
        from raft_tpu_torch.mutable.checkpoint import (has_durable_state,
                                                       recover)

        if durable_dir is not None and has_durable_state(durable_dir):
            expects(not prepared,
                    "serving: durable recovery rebuilds the index from "
                    "disk — pass the raw matrix (the bootstrap fallback), "
                    "not a prepared index")
            recovered = recover(durable_dir, res=self.res,
                                device=self.device, wal_sync=wal_sync,
                                **mut_kw)
            if recovered is not None:
                mi, self._recovery = recovered
                return mi
        return MutableIndex(index, ids=index_ids, res=self.res,
                            device=self.device, durable_dir=durable_dir,
                            wal_sync=wal_sync, **mut_kw)

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

    def _plane(self, snap, xb):
        """The data plane of one padded bucket batch: (vals, ids, n_fail),
        n_fail the queries that paid the exact fixup (brute) or the
        certificate rerun (IVF). On a mutable engine ``snap`` is a
        ``MutableView`` (or the store's snapshot at warm-up, and then the
        current view is searched)."""
        if self._mutable is not None:
            from raft_tpu_torch.mutable import MutableView, search_view

            view = (snap if isinstance(snap, MutableView)
                    else self._mutable.view())
            vals, ids, st = search_view(self._mutable, xb, self.k, view=view,
                                        n_probes=self._n_probes,
                                        res=self.res, with_stats=True)
            return vals, ids, st["base_fail"] + st["delta_fail"]
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

    def _shadow_oracle(self, x):
        """The exact plane the shadow sampler re-scores against, over the
        current snapshot (reference ``:668``): brute ``knn_fused`` on the
        same index, the IVF planes' search at ``n_probes = n_lists`` (the
        certified exact search over the whole slab), a mutable engine's
        exact view search. Runs on the shadow thread, inside the shadow
        stream on the card; the snapshot is held until the ids are on the
        host, so a swap cannot free its tensors under a running
        re-score."""
        ctx = (torch.cuda.stream(self._shadow_stream)
               if self._shadow_stream is not None
               else contextlib.nullcontext())
        with ctx:
            xt = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            if self._mutable is not None:
                from raft_tpu_torch.mutable import search_view

                vals, ids = search_view(self._mutable, xt, self.k,
                                        exact=True, res=self.res)
            else:
                snap = self._store.current()
                if self._algorithm == "ivf_pq":
                    from raft_tpu_torch.ann import search_ivf_pq

                    vals, ids = search_ivf_pq(self.res, snap.index, xt,
                                              self.k,
                                              n_probes=snap.index.n_lists)
                elif self._algorithm == "ivf_flat":
                    from raft_tpu_torch.ann import search_ivf_flat

                    vals, ids = search_ivf_flat(self.res, snap.index, xt,
                                                self.k,
                                                n_probes=snap.index.n_lists)
                else:
                    from raft_tpu_torch.distance.knn_fused import knn_fused

                    vals, ids = knn_fused(xt, snap.index, self.k)
            return vals, ids.cpu().numpy()

    # -- lifecycle --------------------------------------------------------
    @property
    def buckets(self) -> Tuple[int, ...]:
        return self._ladder

    @property
    def slo(self):
        """The attached :class:`~raft_tpu_torch.observability.slo.
        SloEngine`, or None."""
        return self._slo

    @property
    def shadow(self) -> Optional[ShadowSampler]:
        return self._shadow

    @property
    def debugz(self):
        """The running debugz server, or None."""
        return self._debugz

    def start(self) -> "ServingEngine":
        """Warm every bucket against the current snapshot, then start the
        batcher thread. Idempotent."""
        with self._cond:
            if self._started:
                return self
            self._started = True
            self._stop = False
        self._boot_forensics()
        self._warm_snapshot(self._store.current())
        if self._shadow_frac > 0.0 and self._shadow is None:
            self._shadow = ShadowSampler(
                self._shadow_oracle, self.k, self._shadow_frac,
                floor=self._shadow_floor).start()
        self._thread = threading.Thread(target=self._loop,
                                        name="serving-batcher", daemon=True)
        self._thread.start()
        if self._debug_port is not None and self._debugz is None:
            from raft_tpu_torch.tools.debugz import DebugzServer

            self._debugz = DebugzServer(
                engine=self, port=int(self._debug_port)).start()
        if self._watchdog is not None:
            self._watchdog.start()
        return self

    def _boot_forensics(self) -> None:
        """Open the blackbox, first reconstructing and preserving a prior
        run's unclean file, and build the watchdog (reference ``:599``).
        Never raises: forensics must not block serving."""
        from raft_tpu_torch.observability import blackbox as blackbox_mod
        from raft_tpu_torch.observability.watchdog import Watchdog

        try:
            booted = blackbox_mod.boot(path=self._blackbox_path)
            self._blackbox = booted.recorder
            self._owns_blackbox = booted.created
            prior = booted.prior
            if prior is not None and prior.get("verdict") != "clean":
                # the previous run died violently: keep its evidence
                # (reconstructed, preserved as <path>.prev), serve it at
                # /crashz, and count it
                self._crash_report = prior
                self.res.metrics.counter(
                    blackbox_mod.UNCLEAN_SHUTDOWNS,
                    help="Prior-run blackboxes found without an "
                         "epilogue at engine start").inc()
                log_warn("serving: prior run died unclean (verdict %r, %d "
                         "records) — postmortem at /crashz",
                         prior.get("verdict"), prior.get("records"))
            if self._blackbox is not None:
                # the run-start snapshot: the floor a killed process is
                # sure to leave behind
                self._blackbox.snapshot()
        except Exception:
            self._blackbox, self._owns_blackbox = None, False
        try:
            wd = Watchdog(engine=self, interval_s=self._watchdog_s)
            self._watchdog = wd if wd.enabled else None
        except Exception:
            self._watchdog = None

    def stop(self, timeout: float = 30.0) -> None:
        """Drain the queue, then stop the batcher (and wait for a
        background rebuild). A mutable engine waits for its compactor, and
        a durable one then flushes and closes its WAL: a clean stop is, to
        recovery, a crash after the last fsync."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self._thread = None
        if self._watchdog is not None:
            self._watchdog.stop()
        if self._blackbox is not None and self._owns_blackbox:
            # the epilogue: what tells this stop apart from a kill
            from raft_tpu_torch.observability import blackbox as blackbox_mod

            blackbox_mod.shutdown(reason="clean")
            self._blackbox, self._owns_blackbox = None, False
        if self._debugz is not None:
            self._debugz.stop()
            self._debugz = None
        if self._shadow is not None:
            self._shadow.flush(timeout=min(10.0, timeout))
            self._shadow.stop()
        self._store.wait_for_builds(timeout)
        if self._mutable is not None:
            self._mutable.wait_for_compaction(timeout=min(30.0, timeout))
            if self._durable:
                self._mutable.close()
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
            if self._algorithm == "ivf_pq" and self._mutable is None:
                # the ADC scan at every pool depth the widen rung can
                # reach, whichever way the chooser lands on live traffic
                from raft_tpu_torch.ann import warm_pq_scan

                warm_pq_scan(self.res, snap.index, b, self.k,
                             self._n_probes or snap.index.n_probes_default)
            emit_serving("warmup", bucket=b, generation=snap.generation)
        with self._cond:
            self._stats["warmed_buckets"] = len(self._ladder)
            self._stats["warmup_builds"] += _build.BUILDS + _build.LOADS - b0
            self._builds_at_warmup = _build.BUILDS + _build.LOADS

    # -- admission --------------------------------------------------------
    def submit(self, x, deadline_s: Optional[float] = None,
               explain: bool = False) -> ServingFuture:
        """Enqueue one request of [n, d] (or [d]) query rows; returns a
        :class:`ServingFuture`. Oversized requests raise
        :class:`RequestTooLargeError`, a full queue
        :class:`OverloadShedError` (the ``shed:overload`` degradation).
        Carries the ``serving_enqueue`` fault site. ``explain=True``
        forces an explain record for the batch this request rides
        (otherwise the hash of its id against ``explain_frac``
        decides)."""
        fault_point("serving_enqueue")
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
        rid = self._new_rid()
        emit_flow("enqueue", rid, ph="s", rows=n)
        if n > self._ladder[-1]:
            self._count_request("rejected")
            emit_serving("reject", rows=n, top_bucket=self._ladder[-1],
                         rid=rid)
            emit_flow("reject", rid, ph="f", outcome="reject")
            raise RequestTooLargeError(
                f"serving: request of {n} rows exceeds the largest bucket "
                f"{self._ladder[-1]} — split it client-side or raise the "
                f"ladder (RAFT_TPU_SERVING_BUCKETS)")
        now = self._clock()
        budget = (deadline_s if deadline_s is not None
                  else self._default_deadline_s)
        req = _Request(x, n, now, now + budget if budget else None,
                       ServingFuture(), rid=rid,
                       explain=(bool(explain) or explain_mod.want(
                           rid, self._explain_frac)))
        self._admit(req, budget, "request")
        return req.future

    def _new_rid(self) -> int:
        return next(self._rids)      # atomic: one C call under the GIL

    def _admit(self, req: _Request, budget, what: str) -> None:
        """Queue ``req`` or shed it (the queue at its row cap)."""
        op = {} if req.kind == "query" else {"op": req.kind}
        with self._cond:
            depth = self._depth_rows
            shed = depth + req.n > self._max_queue_rows
            if shed:
                self._stats["shed"] += 1
            else:
                self._queue.append(req)
                self._depth_rows = depth = depth + req.n
                self._cond.notify_all()
        if not shed:
            # the telemetry of an admission runs outside the engine's lock
            self._gauge_depth(depth)
            emit_serving("enqueue", rows=req.n, queue_rows=depth,
                         deadline_s=budget, rid=req.rid, **op)
            return
        self._count_request("shed")
        try:
            self.res.metrics.counter(
                SHED, help="Requests shed by admission control "
                           "(queue at its row cap)").inc()
        except Exception:
            pass
        record_degradation("serving.engine", "shed:overload")
        emit_serving("shed", rows=req.n, queue_rows=depth, rid=req.rid, **op)
        emit_flow("shed", req.rid, ph="f", outcome="shed")
        raise OverloadShedError(
            f"serving: queue at capacity ({depth}/{self._max_queue_rows} "
            f"rows) — {what} shed; back off and retry")

    def query(self, x, deadline_s: Optional[float] = None,
              timeout: Optional[float] = 60.0
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking convenience: submit + wait."""
        return self.submit(x, deadline_s=deadline_s).result(timeout)

    # -- mutations (mutable=True) ----------------------------------------
    def _submit_mutation(self, kind: str, ids, rows,
                         deadline_s: Optional[float]) -> ServingFuture:
        """Enqueue one mutation on the query queue (reference ``:823``):
        the same admission control (the queue's row cap sheds; an upsert
        past the delta capacity is rejected), FIFO order with the queries
        around it and a deadline scope on the batcher thread."""
        expects(self._mutable is not None,
                "serving: %s() needs a mutable engine "
                "(ServingEngine(..., mutable=True))", kind)
        fault_point("serving_enqueue")
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        if rows is not None:
            rows = np.asarray(rows, np.float32)
            if rows.ndim == 1:
                rows = rows[None]
            expects(rows.ndim == 2 and rows.shape[1] == self.d,
                    "serving: %s rows must be [n, %d] (got %s)", kind,
                    self.d, rows.shape)
            expects(ids.shape[0] == rows.shape[0],
                    "serving: %s ids/rows length mismatch", kind)
        n = int(ids.shape[0])
        if n == 0:
            fut = ServingFuture()
            fut._complete({"applied": 0, "kind": kind}, None)
            return fut
        rid = self._new_rid()
        emit_flow("enqueue", rid, ph="s", rows=n, op=kind)
        if rows is not None and n > self._mutable.delta_cap:
            self._count_request("rejected")
            emit_serving("reject", rows=n, op=kind, rid=rid,
                         delta_cap=self._mutable.delta_cap)
            emit_flow("reject", rid, ph="f", outcome="reject")
            raise RequestTooLargeError(
                f"serving: upsert of {n} rows exceeds the delta capacity "
                f"{self._mutable.delta_cap} — split it or raise "
                f"RAFT_TPU_DELTA_CAP")
        now = self._clock()
        budget = (deadline_s if deadline_s is not None
                  else self._default_deadline_s)
        req = _Request(rows, n, now, now + budget if budget else None,
                       ServingFuture(), rid=rid, kind=kind, ids=ids)
        self._admit(req, budget, kind)
        return req.future

    def upsert(self, ids, rows, deadline_s: Optional[float] = None
               ) -> ServingFuture:
        """Enqueue an upsert of ``rows`` [n, d] under external ``ids`` [n]
        (mutable engines). The future resolves to a dict with the applied
        count and the index's seq and generation once the batcher applies
        it, in strict order with the queries around it."""
        return self._submit_mutation("upsert", ids, rows, deadline_s)

    def delete(self, ids, deadline_s: Optional[float] = None
               ) -> ServingFuture:
        """Enqueue a delete of external ``ids`` (mutable engines), visible
        to every batch dispatched after it."""
        return self._submit_mutation("delete", ids, None, deadline_s)

    @property
    def mutable(self):
        """The engine's MutableIndex (None on an immutable engine)."""
        return self._mutable

    @property
    def recovery(self):
        """Stats of the recovery this engine ran at construction (None
        when it cold-started)."""
        return dict(self._recovery) if self._recovery else None

    # -- index updates ----------------------------------------------------
    def update_index(self, y, block: bool = False):
        """Rebuild the index from ``y`` and swap it in — on a background
        thread by default. Queries keep hitting the current snapshot until
        the new one is built, complete on the card and warmed (every rung
        dispatched against it), so readers never block and never pay a
        kernel build. ``y`` is numpy or a tensor (moved to the engine's
        device by the build). A mutable engine changes through
        :meth:`upsert` and :meth:`delete` instead."""
        expects(self._mutable is None,
                "serving: a mutable engine updates through upsert()/"
                "delete() (compaction folds the delta in the background) — "
                "update_index is the immutable path")
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
        try:
            self.res.metrics.counter(
                REQUESTS, {"status": status},
                help="Serving requests by terminal status").inc()
        except Exception:
            pass

    def _gauge_depth(self, rows: Optional[int] = None) -> None:
        try:
            self.res.metrics.gauge(
                QUEUE_DEPTH, help="Query rows currently queued"
            ).set(self._depth_rows if rows is None else rows)
        except Exception:
            pass

    def _observe_latency(self, seconds: float) -> None:
        with self._cond:
            self._latencies.append(seconds)
        try:
            self.res.metrics.histogram(
                LATENCY, help="End-to-end request latency (enqueue → "
                              "completion)").observe(seconds)
        except Exception:
            pass

    def stats(self) -> dict:
        """Live counters, latency percentiles (engine-side, interpolated
        by :func:`~raft_tpu_torch.observability.metrics.percentile`), the
        snapshot store's counters, ``builds_after_warmup`` (kernel builds
        and loads since the last warm-up ended; 0 is the contract), the
        registry's request counts by status (``registry_requests``), and
        the state of each operations plane: shadow, SLO, explain, debugz,
        blackbox, watchdog, a prior run's crash."""
        with self._cond:
            out = dict(self._stats)
            out["queue_rows"] = self._depth_rows
            lat = list(self._latencies)
            at = self._builds_at_warmup
        if lat:
            out["p50_ms"] = 1e3 * percentile(lat, 50)
            out["p99_ms"] = 1e3 * percentile(lat, 99)
        out["generation"] = self._store.generation
        out["snapshot"] = self._store.stats()
        out["buckets"] = self._ladder
        try:
            out["registry_requests"] = {
                m.labels.get("status", "?"): int(m.value)
                for m in self.res.metrics.collect()
                if getattr(m, "name", None) == REQUESTS}
        except Exception:
            pass
        if self._mutable is not None:
            out["mutable"] = self._mutable.stats()
            if self._mutable.durability is not None:
                out["durability"] = self._mutable.durability.stats()
        if self._recovery is not None:
            out["recovery"] = dict(self._recovery)
        out["builds_after_warmup"] = (None if at is None else
                                      _build.BUILDS + _build.LOADS - at)
        if self._shadow is not None:
            out.update(self._shadow.snapshot())
        if self._slo is not None:
            try:
                out["slo"] = self._slo.status()
            except Exception:
                pass
        out["explain"] = {"frac": self._explain_frac,
                          "records": len(explain_mod.explain_records())}
        if self._debugz is not None:
            out["debugz_port"] = self._debugz.port
        if self._blackbox is not None:
            out["blackbox"] = self._blackbox.stats()
        if self._watchdog is not None:
            out["watchdog"] = self._watchdog.stats()
        if self._crash_report is not None:
            out["prior_crash"] = {
                "verdict": self._crash_report.get("verdict"),
                "records": self._crash_report.get("records"),
                "preserved_path": self._crash_report.get("preserved_path")}
        return out

    # the name statusz reads; the same snapshot
    snapshot_stats = stats

    @property
    def crash_report(self) -> Optional[dict]:
        """The prior run's postmortem reconstruction when :meth:`start`
        found an epilogue-less blackbox (else None): the ``/crashz``
        body."""
        return self._crash_report

    @property
    def blackbox(self):
        """The installed crash-durable recorder, or None."""
        return self._blackbox

    def inflight_requests(self) -> List[dict]:
        """The queued requests (age, remaining deadline), plus a
        ``dispatch`` row while a batch runs: the watchdog's stall
        evidence and the blackbox's in-flight table. Holds the lock only
        to copy the queue."""
        with self._cond:
            reqs = list(self._queue)
            busy = self._busy
        now = self._clock()
        out = [{"rid": r.rid, "kind": r.kind, "rows": r.n,
                "age_s": round(now - r.enqueued_at, 6),
                "deadline_in_s": (round(r.deadline_at - now, 6)
                                  if r.deadline_at is not None else None)}
               for r in reqs]
        if busy:
            out.append({"rid": None, "kind": "dispatch", "rows": 0,
                        "age_s": 0.0, "deadline_in_s": None})
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
        requests on the way (they never cost a dispatch). A mutation is a
        strict ordering barrier: the queries ahead of it form this batch,
        it runs alone next, the queries behind it see it."""
        now = self._clock()
        batch, expired, total, mutation = [], [], 0, None
        while self._queue:
            req = self._queue[0]
            if req.deadline_at is not None and req.deadline_at <= now:
                self._queue.popleft()
                self._depth_rows -= req.n
                expired.append(req)
                continue
            if req.kind != "query":
                if batch:
                    break
                self._queue.popleft()
                self._depth_rows -= req.n
                mutation = req
                break
            if total + req.n > self._ladder[-1]:
                break
            self._queue.popleft()
            self._depth_rows -= req.n
            batch.append(req)
            total += req.n
        self._gauge_depth()
        return batch, total, expired, mutation

    def _fail_expired(self, expired) -> None:
        for req in expired:
            self._count_request("deadline")
            with self._cond:
                self._stats["expired_in_queue"] += 1
            emit_flow("expire", req.rid, ph="f", outcome="expired")
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
                        # an idle tick: with an SLO engine, leave the
                        # lock so its tick (a registry snapshot) runs
                        # outside it
                        self._cond.wait(self._flush_interval_s)
                        if self._slo is not None:
                            break
                if self._stop and not self._queue:
                    self._busy = False
                    self._cond.notify_all()
                    return
                batch, total, expired, mutation = self._pop_batch_locked()
                self._busy = bool(batch) or mutation is not None
            wd = self._watchdog
            if wd is not None:
                wd.beat()           # liveness heartbeat, outside the lock
            bb = self._blackbox
            if bb is not None:
                bb.maybe_snapshot()  # rate-limited: mostly a clock read
            self._fail_expired(expired)
            if batch or mutation is not None:
                try:
                    if batch:
                        self._run_batch(batch, total)
                    if mutation is not None:
                        self._run_mutation(mutation)
                finally:
                    with self._cond:
                        self._busy = False
                        self._cond.notify_all()
            if self._slo is not None:
                self._slo.tick()     # rate-limited by its window; no raise

    def _run_batch(self, batch, total: int) -> None:
        # one snapshot (or mutable view) per batch: every rider sees one
        # index
        snap = (self._mutable.view() if self._mutable is not None
                else self._store.current())
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
        # flow trace: each rider steps onto the batcher thread, then
        # through the dispatch
        for req in batch:
            emit_flow("batch", req.rid, ph="t", bucket=bucket,
                      riders=len(batch))
        try:
            self.res.metrics.counter(
                BATCHES, {"bucket": str(bucket)},
                help="Dispatched micro-batches by bucket").inc()
            self.res.metrics.counter(
                BATCH_PAD_ROWS,
                help="Pad rows dispatched (bucket − real rows)"
            ).inc(bucket - total)
        except Exception:
            pass
        for req in batch:
            emit_flow("dispatch", req.rid, ph="t",
                      generation=snap.generation)
        # explain capture spans the dispatch: a flagged rider opens one
        # record for the whole batch, which the search path annotates
        cap = (explain_mod.begin_capture([r.rid for r in batch])
               if any(r.explain for r in batch) else None)
        try:
            with explain_mod.stage("execute_batch"):
                vals, ids, n_fail = execute_batch(
                    self._plane, snap, x, bucket, total, budget,
                    stream=self.res.stream)
        except DeadlineExceededError as e:
            explain_mod.end_capture(cap, outcome="deadline", bucket=bucket,
                                    riders=len(batch))
            self._on_batch_deadline(batch, e)
            return
        except Exception as e:
            explain_mod.end_capture(cap, outcome="error", bucket=bucket,
                                    riders=len(batch))
            for req in batch:
                self._count_request("error")
                emit_flow("fail", req.rid, ph="f", outcome="error")
                req.future._fail(e)
            return
        done = self._clock()
        with self._cond:
            self._stats["fixups"] += int(n_fail)
        # every rider is answered before any telemetry of the batch runs
        offs = np.cumsum([0] + [req.n for req in batch])
        for req, off in zip(batch, offs):
            req.future._complete(vals[off:off + req.n], ids[off:off + req.n])
        for req, off in zip(batch, offs):
            emit_flow("response", req.rid, ph="f", outcome="ok")
            if self._shadow is not None and self._shadow.want(req.rid):
                # off the hot path: the oracle re-scores on the shadow
                # thread; a full shadow queue drops the sample
                self._shadow.submit(req.rid, req.x, ids[off:off + req.n])
            self._count_request("ok")
            self._observe_latency(max(0.0, done - req.enqueued_at))
        explain_mod.end_capture(cap, outcome="ok", bucket=bucket, rows=total,
                                riders=len(batch), generation=snap.generation)

    def _run_mutation(self, req) -> None:
        """Apply one mutation on the batcher thread inside its own deadline
        scope (reference ``:1277``): in strict order with the query
        batches, never concurrent with a dispatch."""
        from raft_tpu_torch.mutable import apply_delete, apply_upsert

        now = self._clock()
        budget = (req.deadline_at - now if req.deadline_at is not None
                  else None)
        if budget is not None and budget <= 0:
            self._fail_expired([req])
            return
        emit_flow("dispatch", req.rid, ph="t", op=req.kind)
        emit_serving("mutate", op=req.kind, rows=req.n, rid=req.rid,
                     budget_s=budget)
        with self._cond:
            self._stats[f"{req.kind}s"] += 1

        def _apply():
            if req.kind == "upsert":
                return apply_upsert(self._mutable, req.ids, req.x)
            return apply_delete(self._mutable, req.ids)

        try:
            if budget is not None:
                with deadline(budget, label="serving_mutation"):
                    applied = _apply()
            else:
                applied = _apply()
        except DeadlineExceededError as e:
            self._count_request("deadline")
            emit_flow("fail", req.rid, ph="f", outcome="deadline")
            req.future._fail(e)
            return
        except Exception as e:
            self._count_request("error")
            emit_flow("fail", req.rid, ph="f", outcome="error")
            req.future._fail(e)
            return
        done = self._clock()
        emit_flow("response", req.rid, ph="f", outcome="ok")
        self._count_request("ok")
        self._observe_latency(max(0.0, done - req.enqueued_at))
        req.future._complete({"kind": req.kind, "applied": int(applied),
                              "seq": self._mutable.seq,
                              "generation": self._mutable.generation}, None)

    def _on_batch_deadline(self, batch, err: DeadlineExceededError) -> None:
        """A batch deadline fired: requests whose own budget expired fail
        with it; riders with budget left are re-queued once (at the head)
        and fail on a second strike."""
        now = self._clock()
        requeue = []
        for req in batch:
            if req.deadline_at is not None and req.deadline_at <= now:
                self._count_request("deadline")
                emit_flow("fail", req.rid, ph="f", outcome="deadline")
                req.future._fail(err)
            elif req.requeues >= _MAX_REQUEUES:
                self._count_request("error")
                emit_flow("fail", req.rid, ph="f", outcome="error")
                req.future._fail(err)
            else:
                req.requeues += 1
                emit_flow("requeue", req.rid, ph="t", outcome="requeue",
                          attempt=req.requeues)
                requeue.append(req)
        if requeue:
            with self._cond:
                self._stats["requeued"] += len(requeue)
                for req in reversed(requeue):
                    self._queue.appendleft(req)
                    self._depth_rows += req.n
                self._gauge_depth()
                self._cond.notify_all()
