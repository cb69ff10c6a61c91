"""MutableIndex — streaming upserts and deletes over immutable snapshots.

Counterpart of ``raft_tpu/mutable/index.py``. Every index gets a mutation
plane:

- **Base snapshot**: an immutable prepared index (brute bf16 or int8
  ``KnnIndex``, ``IvfFlatIndex`` or ``IvfPqIndex``) held in a
  :class:`~raft_tpu_torch.serving.snapshot.SnapshotStore`. Readers take a
  :class:`MutableView` and never wait on a writer: the view is published
  as one attribute, read without the lock.
- **Append delta slab**: a fixed-capacity [cap, d] tail (8-row quantum).
  New rows land in the next free slots; the host keeps them in numpy (the
  fold and the checkpoints read them there) and every mutation
  re-prepares the device operands at the fixed cap shape through
  :func:`~raft_tpu_torch.mutable.layout.fused_ops_for_layout` (an int8
  base's delta is quantized on ingest and streams through K2).
- **Tombstones**: a delete (or the old copy under an upsert) clears the
  row's ``rows_valid`` bit and writes the never-wins ``_PACK_PAD`` into
  the base's sentinel carrier ``yyh_k`` (and −1 into ``ids_live`` on an
  IVF base, so the probed scan skips it). Both are **cloned** first and
  the clones published: a tensor a published view holds is never
  written, so a view taken before a delete answers as before. The slab
  itself is untouched; the delete is visible to the next search.
- **Two-slab search**: the masked base and the delta each give a top-k
  pool, merged rank-major (base first, then delta) into the k smallest
  in ``jax.lax.top_k(−v)``'s order (:func:`_merge_pools`; the
  reference's ``distance/knn_sharded.py:327-339``). The result equals a
  from-scratch rebuild over the live rows.
- **Background compaction**: past ``RAFT_TPU_COMPACT_THRESHOLD`` delta
  slots a compactor thread folds (live base + live delta) into a fresh
  snapshot through ``SnapshotStore.update``, on a CUDA stream of its own,
  and publishes it only once that stream's work is complete; it then
  rebases the retained delta tail and the mid-fold tombstones onto the
  new base. A failed fold keeps the old snapshot serving.

Every writer-side device step (tombstone clone and scatter, delta
re-prepare) completes on the card before the view that names its tensors
is published, so a reader never launches K1 on an operand still being
written.

Delta geometry: ``T = 256``, ``g = 2`` (the reference's ``_DELTA_T`` /
``_DELTA_G``). The reference's query block ``_DELTA_QB`` is a TPU term
with no counterpart. The small tiles keep the delta's buckets to a few
rows each, so its certificate almost never fails; ids are exact whatever
the geometry.

Durability (off by default): ``durable_dir=`` attaches a
:class:`~raft_tpu_torch.mutable.checkpoint.DurabilityPlane`. Every
mutation is appended to the WAL before it is applied and fsynced (per
``wal_sync`` / ``RAFT_TPU_WAL_SYNC``) before it returns; the compactor
commits a checkpoint at every swap, and a genesis checkpoint is written at
attach.

Telemetry, as the reference's: ``apply_upsert`` / ``apply_delete`` /
``search_view`` are spans; each search queues its certificate stats at
the ``mutable.search_base`` (certified base scan) and
``mutable.search_delta`` sites; every write and fold step is a
``mutation`` flight event (``emit_mutation``: upsert, delete,
compact_start, compact_swap, compact_abort); and the registry holds the
delta rows, tombstone fraction and compaction debt gauges and the
mutation and compaction counters (the ``raft_tpu_mutable_*`` names).

Env knobs: ``RAFT_TPU_COMPACT_THRESHOLD`` (default 1024),
``RAFT_TPU_DELTA_CAP`` (default twice the threshold, 8-row quantum).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import env
from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import (DeviceResources, as_f32,
                                           resolve_device)
from raft_tpu_torch.mutable.layout import (FusedOps, dense_layout,
                                           fused_ops_for_layout,
                                           run_fused_ops)
from raft_tpu_torch.observability.quality import record_pending
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.observability.timeline import emit_mutation
from raft_tpu_torch.resilience.faults import fault_point
from raft_tpu_torch.serving.snapshot import SnapshotStore, wait_built

COMPACT_THRESHOLD_ENV = "RAFT_TPU_COMPACT_THRESHOLD"
DELTA_CAP_ENV = "RAFT_TPU_DELTA_CAP"
DEFAULT_COMPACT_THRESHOLD = 1024

# the mutation slice of the metric vocabulary
DELTA_ROWS = "raft_tpu_mutable_delta_rows"
TOMBSTONE_FRAC = "raft_tpu_mutable_tombstone_frac"
COMPACTION_DEBT = "raft_tpu_mutable_compaction_debt"
MUTATIONS = "raft_tpu_mutable_mutations_total"
COMPACTIONS = "raft_tpu_mutable_compactions_total"

#: delta-plane tiling (see the module doc)
_DELTA_T = 256
_DELTA_G = 2


def compact_threshold_default() -> int:
    return max(8, env.get(COMPACT_THRESHOLD_ENV, DEFAULT_COMPACT_THRESHOLD))


def delta_cap_default(threshold: int) -> int:
    cap = env.get(DELTA_CAP_ENV)
    if cap is None:
        cap = 2 * threshold
    cap = max(cap, threshold, 8)
    return -(-cap // 8) * 8                       # 8-row quantum


def _gauges(registry, delta_rows: int, tombs: int, base_rows: int,
            threshold: int) -> None:
    try:
        registry.gauge(
            DELTA_ROWS, help="Delta-slab slots written (live + "
                             "tombstoned) awaiting compaction"
        ).set(delta_rows)
        registry.gauge(
            TOMBSTONE_FRAC,
            help="Tombstoned fraction of the base snapshot's rows"
        ).set(tombs / max(1, base_rows))
        registry.gauge(
            COMPACTION_DEBT,
            help="Delta occupancy over the compaction watermark "
                 "(>= 1.0 means a fold is due)"
        ).set(delta_rows / max(1, threshold))
    except Exception:
        pass


def _publish_ready(device: torch.device) -> None:
    """Block until the work this thread queued on its current stream is
    complete on the card (a no-op on the CPU): the tensors it wrote may
    then be read from any stream."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


class _BasePlane:
    """One immutable base snapshot: the prepared index, its external-id
    maps and the certified-fused operands the search drives. Never
    mutated; the tombstone state lives in :class:`MutableIndex`."""

    __slots__ = ("kind", "index", "exts_np", "fops", "ext_slab", "ext_row",
                 "n_rows", "d_orig", "Qb", "lookup")

    def __init__(self, kind: str, index, exts_np: np.ndarray,
                 fops: FusedOps):
        from raft_tpu_torch.distance.knn_fused import fused_config

        self.kind = kind
        self.index = index
        self.exts_np = np.asarray(exts_np, np.int32)
        self.fops = fops
        self.n_rows = int(index.n_rows)
        self.d_orig = int(index.d_orig)
        self.Qb = int(getattr(index, "Qb", None) or fused_config(3).Qb)
        dev = fops.ids.device
        # slab position → external id (pads −1): brute slab positions are
        # row ids, IVF positions map through the layout ids
        ids = fops.ids.cpu().numpy()
        if kind == "brute":
            ext_slab = np.full(ids.shape[0], -1, np.int32)
            ext_slab[:self.n_rows] = self.exts_np
            skeys = np.arange(self.n_rows)
        else:
            ext_slab = np.where(ids >= 0, self.exts_np[np.maximum(ids, 0)],
                                -1).astype(np.int32)
            slab_pos = np.nonzero(ids >= 0)[0]
            skeys = np.empty(self.n_rows, np.int64)
            skeys[ids[slab_pos]] = slab_pos
        self.ext_slab = torch.from_numpy(ext_slab).to(dev)
        # global row id → external id (the IVF probe path returns row ids)
        self.ext_row = torch.from_numpy(self.exts_np).to(dev)
        # external id → slab position; handed to the index at install.
        # Values: a slab position (≥ 0) in the base, ~slot in the delta
        self.lookup = dict(zip(self.exts_np.tolist(), skeys.tolist()))

    @property
    def device(self) -> torch.device:
        return self.ext_row.device


def _brute_fops(idx) -> FusedOps:
    """The operands of an already-prepared dense ``KnnIndex``: the brute
    base reuses the snapshot's operands as they are; only the mask and
    carrier are overridden per generation."""
    M = idx.prepared_rows
    col = torch.arange(M, dtype=torch.int32, device=idx.device)
    return FusedOps(idx, torch.where(col < idx.n_rows, col, -1))


class MutableView:
    """One consistent read view: the base plane, its tombstoned (mask,
    carrier) pair, the delta operands and the live counts. Published
    whole by the writer; nothing it holds is written afterwards, so a
    query sees exactly one generation."""

    __slots__ = ("plane", "base_rv", "base_yyh", "ids_live", "base_live",
                 "delta_fops", "delta_live", "generation", "seq")

    def __init__(self, plane, base_rv, base_yyh, ids_live, base_live,
                 delta_fops, delta_live, generation, seq):
        self.plane = plane
        self.base_rv = base_rv
        self.base_yyh = base_yyh
        self.ids_live = ids_live
        self.base_live = base_live
        self.delta_fops = delta_fops
        self.delta_live = delta_live
        self.generation = generation
        self.seq = seq

    @property
    def n_rows(self) -> int:
        """Live logical rows (base + delta, tombstones excluded)."""
        return self.base_live + self.delta_live

    @property
    def device(self) -> torch.device:
        return self.plane.device


class MutableIndex:
    """A mutation plane over any supported index (see the module doc).

    ``index`` is a raw [m, d] matrix (numpy or tensor, built on
    ``device``: default ``cuda``, ``device="cpu"`` runs the plain twins),
    a prepared ``KnnIndex`` (``algorithm="brute"``; it must store its f32
    rows, the compaction source), an ``IvfFlatIndex``
    (``algorithm="ivf_flat"``, f32 slab) or an ``IvfPqIndex``
    (``algorithm="ivf_pq"``). A prepared index serves on its own device.
    ``ids`` are the external row ids (non-negative int32, unique; default
    ``arange(m)``): searches return them, upserts and deletes address
    them.
    """

    def __init__(self, index, ids=None, *, algorithm: str = "brute",
                 res=None, passes: int = 3, metric: str = "l2",
                 T: Optional[int] = None, Qb: Optional[int] = None,
                 g: Optional[int] = None, db_dtype: Optional[str] = None,
                 n_lists: Optional[int] = None,
                 n_probes: Optional[int] = None,
                 pq_dim: Optional[int] = None,
                 pq_bits: Optional[int] = None,
                 compact_threshold: Optional[int] = None,
                 delta_cap: Optional[int] = None,
                 auto_compact: bool = True,
                 durable_dir: Optional[str] = None,
                 wal_sync: Optional[str] = None, device=None):
        from raft_tpu_torch.ann import IvfFlatIndex, IvfPqIndex
        from raft_tpu_torch.distance.knn_fused import KnnIndex

        expects(algorithm in ("brute", "ivf_flat", "ivf_pq"),
                "MutableIndex: algorithm must be 'brute', 'ivf_flat' or "
                "'ivf_pq', got %r", algorithm)
        expects(metric == "l2",
                "MutableIndex: the mutation plane serves metric='l2' only "
                "(the merge and the rebuild oracle are l2-space)")
        self._algorithm = algorithm
        self._metric = metric
        self._passes = passes
        self._db_dtype = db_dtype
        self._build_kw = dict(passes=passes, metric=metric, T=T, Qb=Qb, g=g)
        self._n_lists, self._n_probes = n_lists, n_probes
        self._pq_dim, self._pq_bits = pq_dim, pq_bits
        self._threshold = (compact_threshold_default()
                           if compact_threshold is None
                           else max(8, int(compact_threshold)))
        self._cap = (delta_cap_default(self._threshold) if delta_cap is None
                     else max(8, -(-int(delta_cap) // 8) * 8,
                              self._threshold))
        self._auto_compact = bool(auto_compact)

        self._cond = threading.Condition(threading.RLock())
        self._seq = 0
        self._tomb_count = 0
        self._folding = False
        self._fold_thread: Optional[threading.Thread] = None
        self._fold_result = None
        self._compactions = 0

        if isinstance(index, KnnIndex):
            expects(algorithm == "brute",
                    "MutableIndex: a KnnIndex serves algorithm='brute'")
            expects(index.yp is not None,
                    "MutableIndex: the brute plane needs the stored f32 "
                    "rows (store_yp=True) — compaction folds from them")
            expects(index.metric == "l2",
                    "MutableIndex: the mutation plane serves metric='l2' "
                    "only")
            plane_idx = index
            self._db_dtype = index.db_dtype
            self._passes = index.passes
            self.device = index.device
            m = index.n_rows
        elif isinstance(index, IvfFlatIndex):
            want = "ivf_pq" if isinstance(index, IvfPqIndex) else "ivf_flat"
            expects(algorithm == want,
                    "MutableIndex: a prepared %s serves algorithm=%r",
                    type(index).__name__, want)
            expects(index.db_dtype == "f32",
                    "MutableIndex: the mutable IVF plane serves the f32 "
                    "slab (int8 IVF stays frozen-index only)")
            plane_idx = index
            self.device = index.device
            m = index.n_rows
        else:
            if device is None and res is not None:
                device = res.device
            self.device = resolve_device(device, index)
            plane_idx = None
            m = int(index.shape[0])
        self.res = res if res is not None else DeviceResources(
            device=self.device)
        # the compactor builds on a stream of its own, so a fold overlaps
        # serving; its snapshot is published only once that stream is done
        self._fold_stream = (torch.cuda.Stream(device=self.device)
                             if self.device.type == "cuda" else None)
        if plane_idx is None:
            plane_idx = self._build_index(index)
        exts = (np.arange(m, dtype=np.int32) if ids is None
                else np.asarray(ids.cpu() if isinstance(ids, torch.Tensor)
                                else ids, np.int32))
        expects(exts.shape == (m,),
                "MutableIndex: ids must be [m] external ids")
        expects(exts.size == 0 or int(exts.min()) >= 0,
                "MutableIndex: external ids must be non-negative")
        expects(np.unique(exts).size == exts.size,
                "MutableIndex: external ids must be unique")
        plane = self._make_plane(plane_idx, exts)
        self.d_orig = plane.d_orig
        self.Qb = plane.Qb

        self._store = SnapshotStore(self._fold_builder, initial_index=plane)
        self._install_base(plane)
        self._reset_delta()
        self._refresh_delta()
        self._publish_locked()

        # durability (off by default: host-side file I/O only)
        self._dur = None
        if durable_dir:
            from raft_tpu_torch.mutable.checkpoint import DurabilityPlane

            self._attach_durability(DurabilityPlane(durable_dir,
                                                    sync=wal_sync))
            # genesis checkpoint: recovery always finds a floor, so a WAL
            # record never exists without a checkpoint under it
            self.checkpoint()

    # -- construction ------------------------------------------------------
    def _build_index(self, y):
        """The plane's index over ``y`` (numpy or tensor) on the index's
        device."""
        y = as_f32(y, self.device)
        n_lists = self._n_lists or max(1, min(1024, int(round(
            y.shape[0] ** 0.5))))
        if self._algorithm == "ivf_pq":
            from raft_tpu_torch.ann import build_ivf_pq

            return build_ivf_pq(self.res, y, n_lists=n_lists,
                                pq_dim=self._pq_dim, pq_bits=self._pq_bits,
                                n_probes=self._n_probes)
        if self._algorithm == "ivf_flat":
            from raft_tpu_torch.ann import build_ivf_flat

            return build_ivf_flat(self.res, y, n_lists=n_lists,
                                  n_probes=self._n_probes)
        from raft_tpu_torch.distance.knn_fused import prepare_knn_index

        kw = dict(self._build_kw)
        if self._db_dtype is not None:
            kw["db_dtype"] = self._db_dtype
        return prepare_knn_index(y, device=self.device, **kw)

    def _make_plane(self, index, exts: np.ndarray) -> _BasePlane:
        if self._algorithm == "brute":
            return _BasePlane("brute", index, exts, _brute_fops(index))
        if self._passes == 3:
            # the degenerate-exact plane's own operands (cached on the
            # index): one prepared copy of the slab serves both
            from raft_tpu_torch.ann.ivf_flat import _slab_fused_geometry

            fops = _slab_fused_geometry(index)
        else:
            fops = fused_ops_for_layout(index.layout(), passes=self._passes,
                                        metric="l2")
        return _BasePlane("ivf", index, exts, fops)

    def _fold_builder(self, payload, **_kw):
        rows, exts = payload
        ctx = (torch.cuda.stream(self._fold_stream)
               if self._fold_stream is not None else contextlib.nullcontext())
        with ctx:
            plane = self._make_plane(self._build_index(rows), exts)
            wait_built(plane)
        self._fold_result = plane
        return plane

    # -- base tombstone state (reset per swap) -----------------------------
    def _install_base(self, plane: _BasePlane) -> None:
        self._plane = plane
        self._base_rv = plane.fops.rv
        self._base_yyh = plane.fops.yyh_k
        self._ids_live = plane.index.ids if plane.kind == "ivf" else None
        self._base_live = plane.n_rows
        self._tomb_count = 0
        self._lookup = plane.lookup
        plane.lookup = None               # the index owns it from here

    def _reset_delta(self) -> None:
        self._d_rows = np.zeros((self._cap, self.d_orig), np.float32)
        self._d_ext = np.full(self._cap, -1, np.int32)
        self._d_valid = np.zeros(self._cap, np.bool_)
        self._d_count = 0

    def _refresh_delta(self) -> None:
        """Re-prepare the delta operands (writer side). The slab shape is
        fixed at the cap, so every generation has the same geometry."""
        layout = dense_layout(self._d_rows, ids=self._d_ext,
                              rows_valid=self._d_valid, device=self.device)
        self._d_fops = fused_ops_for_layout(
            layout, passes=self._passes, metric=self._metric, T=_DELTA_T,
            g=_DELTA_G, db_dtype="int8" if self._db_dtype == "int8" else None)
        self._d_live = int(self._d_valid.sum())

    def _publish_locked(self) -> None:
        """Publish the current state as the readers' view, once every
        tensor it names is complete on the card."""
        _publish_ready(self.device)
        self._view = MutableView(
            plane=self._plane, base_rv=self._base_rv,
            base_yyh=self._base_yyh, ids_live=self._ids_live,
            base_live=self._base_live, delta_fops=self._d_fops,
            delta_live=self._d_live, generation=self._store.generation,
            seq=self._seq)

    # -- introspection -----------------------------------------------------
    @property
    def store(self):
        return self._store

    @property
    def generation(self) -> int:
        return self._store.generation

    @property
    def seq(self) -> int:
        return self._seq

    @property
    def n_rows(self) -> int:
        with self._cond:
            return self._base_live + self._d_live

    @property
    def delta_rows(self) -> int:
        with self._cond:
            return self._d_count

    @property
    def delta_cap(self) -> int:
        return self._cap

    @property
    def compact_threshold(self) -> int:
        return self._threshold

    @property
    def compactions(self) -> int:
        with self._cond:
            return self._compactions

    @property
    def folding(self) -> bool:
        with self._cond:
            return self._folding

    def view(self) -> MutableView:
        """The current consistent read view: one attribute read, no lock.
        The search path is lock-free."""
        return self._view

    def stats(self) -> dict:
        with self._cond:
            return {
                "generation": self._store.generation,
                "seq": self._seq,
                "base_rows": self._plane.n_rows,
                "base_live": self._base_live,
                "delta_rows": self._d_count,
                "delta_live": self._d_live,
                "delta_cap": self._cap,
                "tombstones": self._tomb_count,
                "compact_threshold": self._threshold,
                "compactions": self._compactions,
                "folding": self._folding,
            }

    # -- mutation internals ------------------------------------------------
    def _tombstone_locked(self, exts: Sequence[int]) -> int:
        """Clear the live bit of every found external id: base rows get
        the never-wins sentinel in clones of the carrier (and of the
        IVF ``ids_live``), delta slots drop their valid bit. Returns how
        many ids were found. Caller holds the lock."""
        from raft_tpu_torch.ops.fused_l2_topk import _PACK_PAD

        base_rows, delta_slots, found = [], [], 0
        for e in exts:
            loc = self._lookup.pop(int(e), None)
            if loc is None:
                continue
            found += 1
            if loc >= 0:
                base_rows.append(loc)
            else:
                delta_slots.append(~loc)
        if base_rows:
            rows = torch.as_tensor(base_rows, dtype=torch.long,
                                   device=self.device)
            # clone, then write: a published view keeps the old tensors
            rv = self._base_rv.clone()
            rv[rows] = False
            yyh = self._base_yyh.clone()
            yyh[rows] = _PACK_PAD
            self._base_rv, self._base_yyh = rv, yyh
            if self._ids_live is not None:
                ids_live = self._ids_live.clone()
                ids_live[rows] = -1
                self._ids_live = ids_live
            self._base_live -= len(base_rows)
            self._tomb_count += len(base_rows)
        for s in delta_slots:
            self._d_valid[s] = False
        return found

    def _ensure_delta_space_locked(self, n: int) -> None:
        """Block the writer until ``n`` delta slots are free: wait for an
        in-flight fold, else fold inline. Readers never wait here."""
        expects(n <= self._cap,
                "MutableIndex: upsert of %d rows exceeds the delta capacity "
                "%d (raise %s)", n, self._cap, DELTA_CAP_ENV)
        while self._cap - self._d_count < n:
            if self._folding:
                self._cond.wait(0.05)
                continue
            # the delta is full and nobody is folding: fold on the writer
            upto = self._begin_fold_locked()
            self._cond.release()
            try:
                self._fold(upto)
            finally:
                self._cond.acquire()

    def _mutation_epilogue_locked(self, kind: str, n: int) -> None:
        self._seq += 1
        self._refresh_delta()
        self._publish_locked()
        try:
            self.res.metrics.counter(
                MUTATIONS, {"kind": kind},
                help="Mutable-index mutations applied").inc(n)
        except Exception:
            pass
        _gauges(self.res.metrics, self._d_count, self._tomb_count,
                self._plane.n_rows, self._threshold)
        emit_mutation(kind, rows=n, seq=self._seq,
                      delta_rows=self._d_count, delta_live=self._d_live,
                      tombstones=self._tomb_count,
                      generation=self._store.generation)

    def _upsert(self, exts: np.ndarray, rows: np.ndarray) -> int:
        n = rows.shape[0]
        with self._cond:
            self._ensure_delta_space_locked(n)
            if self._dur is not None:
                # write-ahead: the record lands before any state changes
                # (a failed append leaves the index untouched; a crash
                # after it replays the whole write, never half)
                self._dur.log_upsert(exts, rows)
            self._tombstone_locked(exts)          # old copies, any plane
            c = self._d_count
            self._d_rows[c:c + n] = rows
            self._d_ext[c:c + n] = exts
            self._d_valid[c:c + n] = True
            for i, e in enumerate(exts.tolist()):
                self._lookup[e] = ~(c + i)
            self._d_count = c + n
            self._mutation_epilogue_locked("upsert", n)
        if self._dur is not None:
            self._dur.commit()       # the fsync horizon: ack after it
        self._maybe_compact()
        return n

    def _delete(self, exts: np.ndarray) -> int:
        with self._cond:
            if self._dur is not None:
                self._dur.log_delete(exts)
            found = self._tombstone_locked(exts)
            self._mutation_epilogue_locked("delete", found)
        if self._dur is not None:
            self._dur.commit()
        self._maybe_compact()
        return found

    # -- durability --------------------------------------------------------
    @property
    def durability(self):
        """The attached DurabilityPlane (None: the in-memory index)."""
        return self._dur

    def _attach_durability(self, plane) -> None:
        self._dur = plane

    def checkpoint(self) -> Optional[str]:
        """Commit one atomic checkpoint of the live state (base + delta,
        and the LSN watermark, taken together under the writer lock; the
        files are written outside it). No-op without a durability plane;
        the compactor calls it at every swap."""
        if self._dur is None:
            return None
        with self._cond:
            rows, exts = self._materialize_locked(self._d_count)
            lsn = self._dur.wal.last_lsn
            gen = self._store.generation
        return self._dur.checkpoint(rows.cpu().numpy(), exts, lsn, gen)

    def close(self) -> None:
        """Flush and close the durability plane (no-op in memory). The
        index stays queryable."""
        if self._dur is not None:
            self._dur.close()
            self._dur = None

    # -- compaction --------------------------------------------------------
    def _begin_fold_locked(self) -> int:
        self._folding = True
        return self._d_count

    def _maybe_compact(self) -> None:
        with self._cond:
            if (not self._auto_compact or self._folding
                    or self._d_count < self._threshold):
                return
            upto = self._begin_fold_locked()
            t = threading.Thread(target=self._fold_guarded, args=(upto,),
                                 name="mutable-compactor", daemon=True)
            self._fold_thread = t
        t.start()

    def compact(self, block: bool = True) -> bool:
        """Fold (live base + live delta) into a fresh base snapshot.
        ``block=True`` folds inline and returns whether a swap landed;
        ``block=False`` starts the background compactor and returns True.
        A fold in flight is waited for (block) or left alone."""
        with self._cond:
            if self._folding:
                if not block:
                    return True
                while self._folding:
                    self._cond.wait(0.05)
                return self._fold_result is not None
            upto = self._begin_fold_locked()
            if not block:
                t = threading.Thread(target=self._fold_guarded, args=(upto,),
                                     name="mutable-compactor", daemon=True)
                self._fold_thread = t
        if not block:
            t.start()
            return True
        self._fold(upto)
        return self._fold_result is not None

    def wait_for_compaction(self, timeout: Optional[float] = None) -> None:
        t = self._fold_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    def _fold_guarded(self, upto: int) -> None:
        """Background wrapper: a failed fold is logged, never raised (the
        old snapshot keeps serving)."""
        try:
            self._fold(upto)
        except Exception as e:
            from raft_tpu_torch.core.logger import log_warn

            log_warn("mutable: background compaction failed (%s: %s) — "
                     "keeping the current snapshot", type(e).__name__,
                     str(e)[:200])

    def _count_compaction(self, status: str) -> None:
        try:
            self.res.metrics.counter(
                COMPACTIONS, {"status": status},
                help="Mutable-index compaction folds by outcome").inc()
        except Exception:
            pass

    def _fold(self, upto: int) -> None:
        """One compaction cycle: materialize the live rows as of entry,
        rebuild through ``SnapshotStore.update``, then rebase the retained
        delta tail and the mid-fold mutations onto the new base. The
        caller has set ``_folding``."""
        self._fold_result = None
        try:
            fault_point("compact_fold")
            with self._cond:
                emit_mutation("compact_start",
                              generation=self._store.generation,
                              delta_rows=upto, tombstones=self._tomb_count)
                rows, exts = self._materialize_locked(upto)
            # the expensive part, outside the lock: readers keep the old
            # view, writers keep appending past `upto`
            self._store.update((rows, exts), block=True)
            plane = self._fold_result
            if plane is None:
                raise RuntimeError(str(self._store.last_error or
                                       "snapshot rebuild failed during "
                                       "compaction"))
            with self._cond:
                self._rebase_locked(plane, upto)
                self._compactions += 1
                _gauges(self.res.metrics, self._d_count, self._tomb_count,
                        self._plane.n_rows, self._threshold)
                emit_mutation("compact_swap",
                              generation=self._store.generation,
                              folded_rows=int(rows.shape[0]),
                              retained_delta=self._d_count)
            if self._dur is not None:
                try:
                    # bound the next recovery's tail at the swap; a failed
                    # checkpoint keeps the older one and a longer tail
                    self.checkpoint()
                except Exception as e:
                    from raft_tpu_torch.core.logger import log_warn

                    log_warn("mutable: post-fold checkpoint failed (%s: %s)"
                             " — WAL tail keeps covering the delta",
                             type(e).__name__, str(e)[:200])
            self._count_compaction("ok")
        except Exception:
            self._count_compaction("failed")
            with self._cond:
                emit_mutation("compact_abort",
                              generation=self._store.generation)
            raise
        finally:
            with self._cond:
                self._folding = False
                self._cond.notify_all()

    def _materialize_locked(self, upto: int
                            ) -> Tuple[torch.Tensor, np.ndarray]:
        """The fold input: live base rows, then live delta rows of slots
        [0, upto), in base order then append order, as (rows [n, d] f32 on
        the index's device, complete there; external ids int32 on the
        host). The base rows are gathered on the card: the lock is held
        for a gather, not for a copy of the whole base to the host."""
        plane = self._plane
        if plane.kind == "brute":
            n = plane.n_rows
            live = self._base_rv[:n]
            # yp is the d-padded prepared slab: fold the original width
            base_rows = plane.index.yp[:n][live][:, :plane.d_orig]
            base_exts = plane.exts_np[live.cpu().numpy()]
        else:
            ids_live = self._ids_live
            pos = torch.nonzero(ids_live >= 0).squeeze(1)
            order = torch.sort(ids_live[pos], stable=True).indices
            pos = pos[order]                       # original row order
            base_rows = plane.index.slab[pos]
            base_exts = plane.exts_np[ids_live[pos].cpu().numpy()]
        dl = self._d_valid[:upto]
        rows = torch.cat([base_rows, torch.from_numpy(
            self._d_rows[:upto][dl]).to(self.device)]).contiguous()
        exts = np.concatenate([base_exts, self._d_ext[:upto][dl]])
        _publish_ready(self.device)     # the fold reads it on its stream
        return rows, np.ascontiguousarray(exts)

    def _rebase_locked(self, plane: _BasePlane, upto: int) -> None:
        """Install the folded base and replay what happened mid-fold. The
        pre-swap lookup is the single source of truth: a folded copy is
        live only if its external id still pointed at the folded content
        (the old base, or a delta slot below the fold line); anything else
        (deleted, or upserted again into the retained tail) is tombstoned
        in the new base before it ever serves."""
        old_lookup = self._lookup
        retained = [(self._d_rows[s].copy(), int(self._d_ext[s]),
                     bool(self._d_valid[s]))
                    for s in range(upto, self._d_count)]
        self._install_base(plane)                  # fresh lookup and masks
        stale = []
        for e in self._lookup:
            loc = old_lookup.get(e)
            if loc is None or (loc < 0 and ~loc >= upto):
                stale.append(e)
        if stale:
            self._tombstone_locked(stale)
        # the retained delta tail → the front of a fresh delta
        self._reset_delta()
        for row, ext, valid in retained:
            s = self._d_count
            self._d_rows[s] = row
            self._d_ext[s] = ext
            self._d_valid[s] = valid
            if valid:
                self._lookup[ext] = ~s
            self._d_count = s + 1
        self._seq += 1
        self._refresh_delta()
        self._publish_locked()


# ------------------------------------------------------- module entry ops
@instrument("mutable.apply_upsert")
def apply_upsert(index: MutableIndex, ids, rows) -> int:
    """Upsert ``rows`` [n, d] under external ``ids`` [n]: existing copies
    are tombstoned, the new rows land in the delta slab (quantized on
    ingest when the base streams int8), visible to the next search.
    Returns the applied count. The ``mutate_ingest`` site comes before any
    state change."""
    fault_point("mutate_ingest")
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    rows = np.asarray(rows, np.float32)
    if rows.ndim == 1:
        rows = rows[None]
    ids = np.atleast_1d(np.asarray(ids, np.int32))
    expects(rows.ndim == 2 and rows.shape[1] == index.d_orig,
            "apply_upsert: rows must be [n, %d] (got %s)", index.d_orig,
            rows.shape)
    expects(ids.shape[0] == rows.shape[0],
            "apply_upsert: ids/rows length mismatch (%d vs %d)",
            ids.shape[0], rows.shape[0])
    expects(ids.size == 0 or int(ids.min()) >= 0,
            "apply_upsert: external ids must be non-negative")
    expects(np.unique(ids).size == ids.size,
            "apply_upsert: duplicate external ids in one batch")
    return index._upsert(ids, rows)


@instrument("mutable.apply_delete")
def apply_delete(index: MutableIndex, ids) -> int:
    """Delete the rows under external ``ids``: a live-bit flip and a
    never-wins sentinel in the carrier; the slab is untouched and the
    delete is visible to the next search. Returns how many ids were
    found. The ``tombstone_apply`` site comes first."""
    fault_point("tombstone_apply")
    if isinstance(ids, torch.Tensor):
        ids = ids.cpu().numpy()
    ids = np.atleast_1d(np.asarray(ids, np.int32))
    return index._delete(ids)


def _pad_pool(vals, ids, k: int):
    """Widen a [nq, k'] pool to k columns with (inf, −1): a slab with fewer
    than k live rows searches at k' = live and pads back up for the
    merge."""
    pad = k - vals.shape[1]
    if pad <= 0:
        return vals, ids
    nq = vals.shape[0]
    return (torch.cat([vals, vals.new_full((nq, pad), float("inf"))], 1),
            torch.cat([ids, ids.new_full((nq, pad), -1)], 1))


def _merge_pools(pools, k: int):
    """The rank-major merge of the (base, delta) pools (reference
    ``distance/knn_sharded.py:327-339``): the pools side by side per
    query, then the k smallest in ``jax.lax.top_k(−v)``'s order (IEEE
    total order, ties to the lower pool position, so base before delta and
    a lower position first). Ranked on the sign-flipped bits
    (:func:`~raft_tpu_torch.matrix.select_k_slotted._smallest`), never on
    a negation, with the values gathered as bits."""
    from raft_tpu_torch.matrix.select_k_slotted import _smallest

    pool_v = torch.cat([p[0] for p in pools], 1)
    pool_i = torch.cat([p[1] for p in pools], 1)
    vals, pos = _smallest(pool_v, k)
    return vals, torch.gather(pool_i, 1, pos)


def _mutable_ivf_chunk(base, ids_live, xs, pr, st, ps, k: int, P: int,
                       W: int):
    """One tombstone-masked chunk of the IVF base (reference ``:863``):
    the query-major probe scan with the masked slab ids, or, on a PQ
    base, K5's ADC scan with the same masked ids (a masked row rescores to
    +inf), whose certificate failures rerun through the masked f32 scan.
    Returns (vals, row ids, reruns)."""
    from raft_tpu_torch.ann.ivf_flat import _fine_scan
    from raft_tpu_torch.ann.ivf_pq import IvfPqIndex, pq_scan_chunk

    if isinstance(base, IvfPqIndex):
        vals, gids, ok, _margin = pq_scan_chunk(
            base, xs, pr.cpu().numpy(), pr, st, ps, k, P, W, ids=ids_live)
        bad = (~ok).nonzero().squeeze(1)
        n_fail = int(bad.numel())
        if n_fail:
            # per-query results: rerunning only the failed rows gives the
            # reference's answer for them
            fv, fi = _fine_scan(xs[bad], base.slab, ids_live, base.yy_slab,
                                st[bad], ps[bad], k=k, P=P, W=W)
            vals, gids = vals.clone(), gids.clone()
            vals[bad], gids[bad] = fv, fi
        return vals, gids, n_fail
    vals, gids = _fine_scan(xs, base.slab, ids_live, base.yy_slab, st, ps,
                            k=k, P=P, W=W)
    return vals, gids, 0


def _search_base(view: MutableView, x, k: int, exact: bool,
                 n_probes: Optional[int], res):
    """Top-k over the tombstone-masked base → (vals, external ids,
    n_fail)."""
    plane = view.plane
    k = min(k, view.base_live)
    if plane.kind == "ivf" and not exact:
        base = plane.index
        L = base.n_lists
        P = int(n_probes) if n_probes else base.n_probes_default
        W = base.probe_window
        if P < L and k <= P * W:
            from raft_tpu_torch.ann.ivf_flat import _FINE_TILE, _coarse_probe

            probes = _coarse_probe(res, base.centroids, x, P)
            pl = probes.long()
            starts = base.offsets[:-1][pl]
            psizes = base.padded_sizes[pl]
            chunk = max(8, _FINE_TILE // max(1, P * W * max(x.shape[1], 1)))
            outs = [_mutable_ivf_chunk(base, view.ids_live, x[s:s + chunk],
                                       probes[s:s + chunk],
                                       starts[s:s + chunk],
                                       psizes[s:s + chunk], k, P, W)
                    for s in range(0, x.shape[0], chunk)]
            vals = torch.cat([o[0] for o in outs])
            gids = torch.cat([o[1] for o in outs])
            ext = torch.where(gids >= 0,
                              plane.ext_row[gids.long().clamp_min(0)], -1)
            return vals, ext, sum(o[2] for o in outs)
        # degenerate regime (n_probes ≥ n_lists, or k over the probed
        # capacity): the certified exact scan below
    vals, pos, n_fail = run_fused_ops(plane.fops, x, k,
                                      rows_valid=view.base_rv,
                                      yyh_k=view.base_yyh)
    _pending("mutable.search_base", plane.fops, n_fail, x.shape[0], k,
             view.generation)
    ext = torch.where(pos >= 0, plane.ext_slab[pos.long().clamp_min(0)], -1)
    return vals, ext, n_fail


def _pending(site: str, fops: FusedOps, n_fail, nq: int, k: int,
             generation: int) -> None:
    """One certified plane scan's stats for the certificate counters."""
    from raft_tpu_torch.distance.knn_fused import rescore_pool_width

    record_pending(site, n_fail, n_queries=nq,
                   pool_width=rescore_pool_width(fops.index, k),
                   db_dtype=fops.index.db_dtype, generation=generation)


@instrument("mutable.search_view")
def search_view(index, x, k: int, view: Optional[MutableView] = None,
                n_probes: Optional[int] = None, exact: bool = False,
                res=None, with_stats: bool = False) -> Tuple:
    """Certified top-k over one consistent :class:`MutableView` (taken
    from ``index`` when not given): the tombstone-masked base and the
    delta each give a top-k pool and the two merge rank-major — exact
    values, ids identical to a from-scratch rebuild over the live rows.
    Returns (vals [nq, k] ascending, external ids [nq, k] int32; (inf, −1)
    pads when fewer than k rows are live) on the index's device.
    ``exact=True`` sends an IVF base through the certified exact scan.
    ``with_stats`` appends ``{"base_fail", "delta_fail"}``: the queries
    each plane re-solved past its certificate (K1/K2's exact fixup, or
    the IVF-PQ base's masked f32 reruns)."""
    if view is None:
        view = index.view() if isinstance(index, MutableIndex) else index
    mi = index if isinstance(index, MutableIndex) else None
    if res is None and mi is not None:
        res = mi.res
    dev = view.device
    x = as_f32(x, dev)
    expects(x.ndim == 2 and x.shape[1] == view.plane.d_orig,
            "search_view: queries must be [nq, %d] (got %s)",
            view.plane.d_orig, tuple(x.shape))
    expects(k >= 1, "search_view: k must be >= 1")
    nq = x.shape[0]
    stats = {"base_fail": 0, "delta_fail": 0}
    pools = []
    if nq and view.base_live > 0:
        bv, bi, nf = _search_base(view, x, k, exact, n_probes, res)
        pools.append(_pad_pool(bv, bi, k))
        stats["base_fail"] = int(nf)
    if nq and view.delta_live > 0:
        kd = min(k, view.delta_live)
        dv, dpos, nf = run_fused_ops(view.delta_fops, x, kd)
        _pending("mutable.search_delta", view.delta_fops, nf, nq, kd,
                 view.generation)
        di = torch.where(dpos >= 0,
                         view.delta_fops.ids[dpos.long().clamp_min(0)], -1)
        pools.append(_pad_pool(dv, di, k))
        stats["delta_fail"] = int(nf)
    if not pools:
        out = (torch.full((nq, k), float("inf"), device=dev),
               torch.full((nq, k), -1, dtype=torch.int32, device=dev))
    elif len(pools) == 1:
        out = pools[0]
    else:
        out = _merge_pools(pools, k)
    out = (out[0], out[1].to(torch.int32))
    return (*out, stats) if with_stats else out
