"""Checkpoints and crash recovery of the mutation plane.

Counterpart of ``raft_tpu/mutable/checkpoint.py``: the WAL
(:mod:`raft_tpu_torch.mutable.wal`) bounds what a crash can lose, a
checkpoint bounds how long recovery takes. A checkpoint is one atomic,
self-verifying copy of the live state (rows and external ids) at an LSN
watermark. Its files are the reference's byte for byte for the same
state, so a durable directory written by either package recovers in the
other.

- **Files**: ``ckpt-<gen:08d>-<lsn:016d>/`` holds ``rows.msp`` and
  ``exts.msp`` (framed arrays of :mod:`raft_tpu_torch.core.serialize`)
  and ``manifest.json`` (per-file sha256, the LSN watermark, the
  generation, a schema version), each written by the atomic writer of
  :mod:`raft_tpu_torch.core.diskio`.
- **Two-phase commit**: the ``CURRENT`` pointer is replaced only after
  the manifest is durable, so a crash at any instruction boundary leaves
  the old checkpoint or the new one committed, never a torn pointer
  (sites ``checkpoint_write`` / ``manifest_commit``).
- :meth:`CheckpointStore.load` returns the newest valid checkpoint: the
  pointer's target when it verifies, else a newest-first scan. WAL
  segments are retired only up to the oldest retained checkpoint, so the
  fallback keeps its replay tail.

:func:`recover` loads the newest valid checkpoint and replays the WAL tail
through ``apply_upsert`` / ``apply_delete``; the index it returns holds
every acked write. As the reference's, each committed checkpoint and
each recovery counts in the registry (``raft_tpu_checkpoints_total``,
``raft_tpu_checkpoint_lsn``, ``raft_tpu_recovery_*``) and is a
``mutation`` flight event (``checkpoint``, ``recovery``);
``last_recovery`` keeps the stats of the process's last recovery, which
statusz's durability panel shows.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import shutil
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from raft_tpu_torch.core.diskio import (atomic_write_bytes,
                                        atomic_write_text, fsync_dir,
                                        read_bytes)
from raft_tpu_torch.core.serialize import mdspan_from_bytes, mdspan_to_bytes
from raft_tpu_torch.mutable import wal as _wal
from raft_tpu_torch.observability.timeline import emit_mutation
from raft_tpu_torch.resilience.faults import fault_point

CKPT_SCHEMA = 1
_CURRENT = "CURRENT"
_MANIFEST = "manifest.json"
#: checkpoints kept by a prune: the newest serves, the older one is the
#: fallback a torn newest degrades to
KEEP_CHECKPOINTS = 2

DURABLE_DIR_ENV = "RAFT_TPU_DURABLE_DIR"

# the durability slice of the metric vocabulary
CHECKPOINTS = "raft_tpu_checkpoints_total"
CHECKPOINT_LSN = "raft_tpu_checkpoint_lsn"
RECOVERIES = "raft_tpu_recovery_total"
RECOVERY_SECONDS = "raft_tpu_recovery_seconds"
RECOVERY_REPLAYED = "raft_tpu_recovery_replayed_records"
RECOVERY_TRUNCATED = "raft_tpu_recovery_truncated_bytes"

#: the recovery stats the ``recovery`` flight event carries (the
#: reference's; the port's stage seconds stay in the returned stats)
_RECOVERY_EVENT_KEYS = ("checkpoint_lsn", "checkpoint_generation",
                        "checkpoint_path", "checkpoint_rows",
                        "replayed_records", "truncated_bytes",
                        "wal_last_lsn", "stopped_early", "seconds")

#: the last completed recovery's stats in this process (None until one)
_LAST_RECOVERY: Optional[Dict] = None


def _count(name: str, help: str, **labels) -> None:
    try:
        from raft_tpu_torch.observability.metrics import get_registry

        get_registry().counter(name, labels or None, help=help).inc()
    except Exception:
        pass


def _gauge(name: str, value: float, help: str) -> None:
    try:
        from raft_tpu_torch.observability.metrics import get_registry

        get_registry().gauge(name, help=help).set(value)
    except Exception:
        pass


class CheckpointData(NamedTuple):
    """One loaded and verified checkpoint."""

    rows: np.ndarray
    exts: np.ndarray
    lsn: int
    generation: int
    path: str


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class CheckpointStore:
    """Atomic checkpoint directory manager (see the module doc)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def write(self, rows, exts, lsn: int, generation: int) -> str:
        """Write and commit one checkpoint; returns its directory. The
        ``checkpoint_write`` site comes before any byte lands,
        ``manifest_commit`` between the durable manifest and the pointer
        flip."""
        fault_point("checkpoint_write")
        rows = np.ascontiguousarray(rows, np.float32)
        exts = np.ascontiguousarray(exts, np.int32)
        name = f"ckpt-{int(generation):08d}-{int(lsn):016d}"
        d = os.path.join(self.directory, name)
        os.makedirs(d, exist_ok=True)
        files = {}
        for fname, payload in (("rows.msp", mdspan_to_bytes(rows)),
                               ("exts.msp", mdspan_to_bytes(exts))):
            atomic_write_bytes(os.path.join(d, fname), payload)
            files[fname] = _sha256(payload)
        manifest = {
            "schema": CKPT_SCHEMA,
            "lsn": int(lsn),
            "generation": int(generation),
            "n_rows": int(rows.shape[0]),
            "d": int(rows.shape[1]) if rows.ndim == 2 else 0,
            "files": files,
        }
        atomic_write_text(os.path.join(d, _MANIFEST),
                          json.dumps(manifest, indent=1, sort_keys=True)
                          + "\n")
        fsync_dir(d)
        # phase two: the pointer flip is the one instant the new
        # checkpoint becomes THE checkpoint
        fault_point("manifest_commit")
        atomic_write_text(os.path.join(self.directory, _CURRENT),
                          name + "\n")
        _count(CHECKPOINTS, "Mutation-plane checkpoints committed",
               status="ok")
        _gauge(CHECKPOINT_LSN, lsn,
               "LSN watermark of the newest committed checkpoint")
        emit_mutation("checkpoint", lsn=int(lsn), generation=int(generation),
                      rows=int(rows.shape[0]))
        return d

    def _manifest_of(self, d: str) -> Optional[Dict]:
        """The verified manifest of one checkpoint directory, or None
        (missing or garbage manifest, missing file, sha mismatch)."""
        raw = read_bytes(os.path.join(d, _MANIFEST))
        if raw is None:
            return None
        try:
            m = json.loads(raw.decode("utf-8", errors="replace"))
        except ValueError:
            return None
        if not isinstance(m, dict) or m.get("schema") != CKPT_SCHEMA:
            return None
        files = m.get("files")
        if not isinstance(files, dict) or not files:
            return None
        for fname, digest in files.items():
            payload = read_bytes(os.path.join(d, str(fname)))
            if payload is None or _sha256(payload) != digest:
                return None
        if not isinstance(m.get("lsn"), int) \
                or not isinstance(m.get("generation"), int):
            return None
        return m

    def _dirs(self) -> List[str]:
        """Checkpoint directories, newest (generation, lsn) first."""
        return sorted(glob.glob(os.path.join(self.directory, "ckpt-*")),
                      reverse=True)

    def manifests(self) -> List[Tuple[str, Dict]]:
        """(directory, verified manifest) of every valid checkpoint,
        newest first."""
        out = []
        for d in self._dirs():
            m = self._manifest_of(d)
            if m is not None:
                out.append((d, m))
        return out

    def load(self) -> Optional[CheckpointData]:
        """The newest valid checkpoint, or None when nothing durable
        survives. Never raises."""
        candidates: List[str] = []
        cur = read_bytes(os.path.join(self.directory, _CURRENT))
        if cur is not None:
            name = cur.decode("utf-8", errors="replace").strip()
            if name and os.sep not in name:
                candidates.append(os.path.join(self.directory, name))
        candidates.extend(d for d in self._dirs() if d not in candidates)
        for d in candidates:
            m = self._manifest_of(d)
            if m is None:
                continue
            try:
                rows = mdspan_from_bytes(read_bytes(
                    os.path.join(d, "rows.msp")))
                exts = mdspan_from_bytes(read_bytes(
                    os.path.join(d, "exts.msp")))
            except Exception:
                continue
            return CheckpointData(rows.astype(np.float32, copy=False),
                                  exts.astype(np.int32, copy=False),
                                  int(m["lsn"]), int(m["generation"]), d)
        return None

    def prune(self, keep: int = KEEP_CHECKPOINTS) -> int:
        """Delete all but the newest ``keep`` valid checkpoints (and any
        invalid litter); returns the kept checkpoints' minimum lsn, the
        safe WAL retirement watermark."""
        valid = self.manifests()
        keep_dirs = {d for d, _ in valid[:keep]}
        for d in self._dirs():
            if d in keep_dirs:
                continue
            try:
                shutil.rmtree(d)
            except OSError:
                pass
        retained = [m["lsn"] for d, m in valid[:keep]]
        return min(retained) if retained else 0


class DurabilityPlane:
    """The WAL and checkpoint pair one durable ``MutableIndex`` owns.
    Under ``directory``: ``wal/`` (segments), ``ckpt-*/`` and
    ``CURRENT``."""

    def __init__(self, directory: str, sync: Optional[str] = None,
                 next_lsn: int = 1, segment_bytes: Optional[int] = None):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.checkpoints = CheckpointStore(directory)
        self.wal = _wal.WalWriter(os.path.join(directory, "wal"), sync=sync,
                                  next_lsn=next_lsn,
                                  segment_bytes=segment_bytes)
        self.checkpoints_written = 0

    def log_upsert(self, ids, rows) -> int:
        return self.wal.append(_wal.OP_UPSERT, _wal.encode_upsert(ids, rows))

    def log_delete(self, ids) -> int:
        return self.wal.append(_wal.OP_DELETE, _wal.encode_delete(ids))

    def commit(self) -> int:
        """The fsync horizon an ack waits on."""
        return self.wal.commit()

    def checkpoint(self, rows, exts, lsn: int, generation: int) -> str:
        """Write and commit a checkpoint at ``lsn``, mark it in the WAL,
        rotate the active segment and retire the segments the kept
        checkpoints no longer need."""
        path = self.checkpoints.write(rows, exts, lsn, generation)
        self.checkpoints_written += 1
        self.wal.append(_wal.OP_CHECKPOINT, _wal.encode_checkpoint_mark(
            lsn, generation, os.path.basename(path)))
        self.wal.commit()
        self.wal.rotate()
        watermark = self.checkpoints.prune()
        if watermark:
            self.wal.retire_through(watermark)
        return path

    def stats(self) -> Dict:
        out = {"directory": self.directory}
        out.update(self.wal.stats())
        manifests = self.checkpoints.manifests()
        out["checkpoints"] = len(manifests)
        out["checkpoints_written"] = self.checkpoints_written
        if manifests:
            out["checkpoint_lsn"] = manifests[0][1]["lsn"]
            out["checkpoint_generation"] = manifests[0][1]["generation"]
        return out

    def close(self) -> None:
        self.wal.close()


def has_durable_state(directory: str) -> bool:
    """True when ``directory`` holds anything recoverable (a committed
    pointer, a checkpoint directory or WAL segments)."""
    if not directory or not os.path.isdir(directory):
        return False
    if os.path.exists(os.path.join(directory, _CURRENT)):
        return True
    if glob.glob(os.path.join(directory, "ckpt-*")):
        return True
    return bool(glob.glob(os.path.join(directory, "wal", "wal-*.log")))


def last_recovery() -> Optional[Dict]:
    """The process's most recent recovery stats."""
    return dict(_LAST_RECOVERY) if _LAST_RECOVERY else None


def recover(directory: str, *, res=None, device=None,
            wal_sync: Optional[str] = None, attach: bool = True,
            **mutable_kw):
    """Rebuild a ``MutableIndex`` from the newest valid checkpoint and the
    WAL tail. Returns ``(index, stats)``, or None when nothing durable
    survives (by the genesis-checkpoint invariant nothing was acked).

    The index is built on ``device`` (default ``cuda``; ``device="cpu"``
    runs the plain twins) or the handle's. ``attach=True`` re-attaches a
    live durability plane (appends continue past the recovered tail) and,
    when records were replayed, writes a fresh checkpoint so the next
    recovery starts from there; ``attach=False`` only inspects.
    ``mutable_kw`` carries the index geometry (algorithm, passes, T, g,
    db_dtype, ...). ``stats`` splits the seconds into the checkpoint
    load, the index build and the replay."""
    global _LAST_RECOVERY

    from raft_tpu_torch.mutable.index import (MutableIndex, apply_delete,
                                              apply_upsert)

    t0 = time.perf_counter()
    store = CheckpointStore(directory)
    ck = store.load()
    if ck is None:
        _count(RECOVERIES, "Mutation-plane recoveries by outcome",
               status="empty")
        return None
    t_load = time.perf_counter()
    idx = MutableIndex(ck.rows, ids=ck.exts, res=res, device=device,
                       **mutable_kw)
    t_build = time.perf_counter()
    records, rstats = _wal.replay(os.path.join(directory, "wal"),
                                  from_lsn=ck.lsn, truncate=True)
    replayed = 0
    for rec in records:
        try:
            if rec.op == _wal.OP_UPSERT:
                ids, rows = _wal.decode_upsert(rec.payload)
                apply_upsert(idx, ids, rows)
            elif rec.op == _wal.OP_DELETE:
                apply_delete(idx, _wal.decode_delete(rec.payload))
            replayed += 1
        except Exception as e:
            # a record that decodes or applies no further ends the
            # consistent prefix, as a torn tail does
            from raft_tpu_torch.core.logger import log_warn

            log_warn("recovery: WAL replay stopped at lsn %d (%s: %s) — "
                     "recovered through the preceding record", rec.lsn,
                     type(e).__name__, str(e)[:200])
            rstats["stopped_early"] = True
            rstats["stop_reason"] = f"replay: {type(e).__name__}"
            break
    t_end = time.perf_counter()
    stats = {
        "checkpoint_lsn": ck.lsn,
        "checkpoint_generation": ck.generation,
        "checkpoint_path": os.path.basename(ck.path),
        "checkpoint_rows": int(ck.rows.shape[0]),
        "replayed_records": replayed,
        "truncated_bytes": int(rstats.get("truncated_bytes", 0)),
        "wal_last_lsn": int(rstats.get("last_lsn", 0)),
        "stopped_early": bool(rstats.get("stopped_early")),
        "stop_reason": rstats.get("stop_reason", ""),
        "seconds": t_end - t0,
        "load_seconds": t_load - t0,
        "build_seconds": t_build - t_load,
        "replay_seconds": t_end - t_build,
    }
    if attach:
        next_lsn = max(ck.lsn, stats["wal_last_lsn"]) + 1
        idx._attach_durability(DurabilityPlane(directory, sync=wal_sync,
                                               next_lsn=next_lsn))
        if replayed:
            idx.checkpoint()        # the next recovery replays from here
    _count(RECOVERIES, "Mutation-plane recoveries by outcome", status="ok")
    _gauge(RECOVERY_SECONDS, stats["seconds"],
           "Wall time of the last crash recovery")
    _gauge(RECOVERY_REPLAYED, replayed,
           "WAL records replayed by the last recovery")
    _gauge(RECOVERY_TRUNCATED, stats["truncated_bytes"],
           "Torn-tail bytes truncated by the last recovery")
    emit_mutation("recovery", **{k: stats[k] for k in _RECOVERY_EVENT_KEYS})
    _LAST_RECOVERY = dict(stats)
    return idx, stats
