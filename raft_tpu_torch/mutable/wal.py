"""Segmented write-ahead log of the mutation plane.

Counterpart of ``raft_tpu/mutable/wal.py``; its frames, segment names and
replay rules are the reference's, byte for byte, so a log written by
either package replays in the other. Every mutation is framed,
CRC-protected and (per the sync policy) fsynced before the caller's ack.

Record frame (little-endian)::

    magic   4B  b"RWL1"
    version u16 schema version (1)
    op      u8  1=upsert  2=delete  3=checkpoint-mark
    flags   u8  reserved (0)
    lsn     u64 monotone log sequence number (1-based)
    plen    u32 payload length
    payload plen bytes (framed arrays of ``core.serialize``: an upsert
                carries (ids, rows), a delete its ids, a checkpoint mark
                a small JSON blob)
    crc32   u32 over magic..payload

- **Atomic records.** A frame is written with one ``write``; a torn tail
  (partial frame, bad CRC, bad magic) ends the valid log. :func:`replay`
  stops at the first bad frame and, with ``truncate=True``, truncates the
  file after the last good one. Corruption degrades, never raises.
- **Monotone LSNs.** A duplicate or regressing LSN is a corruption
  boundary too, so replay never applies a record twice.
- **Group commit.** ``RAFT_TPU_WAL_SYNC`` ∈ ``{always, batch, none}``:
  ``always`` fsyncs every record, ``batch`` (default) once per
  :meth:`WalWriter.commit` (the ack horizon), ``none`` never (acked then
  does not mean durable).
- **Segments.** ``wal-<first-lsn>.log`` files capped at
  ``RAFT_TPU_WAL_SEGMENT_MB``; once a checkpoint's watermark covers a
  whole non-active segment, :meth:`WalWriter.retire_through` deletes it.

Fault sites ``wal_append`` and ``wal_fsync``
(:func:`~raft_tpu_torch.resilience.fault_point`). The registry holds the
reference's WAL counters and gauges: appends (by op), fsyncs, bytes, the
durable LSN and the live segment count (``raft_tpu_wal_*``).
Host-only: numpy and files, no tensor.
"""

from __future__ import annotations

import glob
import json
import os
import struct
import threading
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

from raft_tpu_torch.core import env
from raft_tpu_torch.core.serialize import mdspan_to_bytes, read_framed
from raft_tpu_torch.resilience.faults import fault_point

WAL_MAGIC = b"RWL1"
WAL_VERSION = 1
OP_UPSERT, OP_DELETE, OP_CHECKPOINT = 1, 2, 3
_OP_NAMES = {OP_UPSERT: "upsert", OP_DELETE: "delete",
             OP_CHECKPOINT: "checkpoint-mark"}

# the WAL slice of the metric vocabulary
WAL_APPENDS = "raft_tpu_wal_appends_total"
WAL_FSYNCS = "raft_tpu_wal_fsyncs_total"
WAL_BYTES = "raft_tpu_wal_bytes_total"
WAL_DURABLE_LSN = "raft_tpu_wal_durable_lsn"
WAL_SEGMENTS = "raft_tpu_wal_segments"

_HEADER = struct.Struct("<4sHBBQI")
_CRC = struct.Struct("<I")

SYNC_MODES = ("always", "batch", "none")
WAL_SYNC_ENV = "RAFT_TPU_WAL_SYNC"
WAL_SEGMENT_MB_ENV = "RAFT_TPU_WAL_SEGMENT_MB"


def sync_mode_default() -> str:
    """``RAFT_TPU_WAL_SYNC`` as a valid mode (default ``batch``; an unknown
    value degrades to the default with a logged warning, never raises)."""
    raw = (env.raw(WAL_SYNC_ENV) or "").lower()
    if not raw:
        return "batch"
    if raw in SYNC_MODES:
        return raw
    from raft_tpu_torch.core.logger import log_warn

    log_warn("%s=%r is not one of %s — using 'batch'", WAL_SYNC_ENV, raw,
             SYNC_MODES)
    return "batch"


def segment_bytes_default() -> int:
    mb = env.get(WAL_SEGMENT_MB_ENV)
    return max(1 << 16, int(mb * (1 << 20)))


class WalRecord(NamedTuple):
    """One decoded log record."""

    op: int
    lsn: int
    payload: bytes


# ------------------------------------------------------------ payloads
def encode_upsert(ids, rows) -> bytes:
    """Upsert payload: two framed arrays back to back (ids int32, rows
    f32)."""
    return (mdspan_to_bytes(np.asarray(ids, np.int32))
            + mdspan_to_bytes(np.asarray(rows, np.float32)))


def decode_upsert(payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
    ids, off = read_framed(payload)
    rows, _ = read_framed(payload, off)
    return ids, rows


def encode_delete(ids) -> bytes:
    return mdspan_to_bytes(np.asarray(ids, np.int32))


def decode_delete(payload: bytes) -> np.ndarray:
    return read_framed(payload)[0]


def encode_checkpoint_mark(lsn: int, generation: int, name: str = "") -> bytes:
    return json.dumps({"lsn": int(lsn), "generation": int(generation),
                       "name": name}).encode()


# -------------------------------------------------------------- frames
def encode_frame(op: int, lsn: int, payload: bytes) -> bytes:
    """One atomic frame: header, payload and CRC32 trailer."""
    head = _HEADER.pack(WAL_MAGIC, WAL_VERSION, op, 0, lsn, len(payload))
    return head + payload + _CRC.pack(zlib.crc32(head + payload)
                                      & 0xFFFFFFFF)


def _read_frame(data: bytes, off: int):
    """-> ("ok", WalRecord, next_off) | ("eof",) | ("corrupt", reason).
    ``eof`` only at an exact frame boundary; anything else that fails to
    parse is a corruption (torn-tail) boundary."""
    if off == len(data):
        return ("eof",)
    if len(data) - off < _HEADER.size:
        return ("corrupt", "short frame header")
    magic, version, op, _flags, lsn, plen = _HEADER.unpack_from(data, off)
    if magic != WAL_MAGIC:
        return ("corrupt", f"bad magic {magic!r}")
    if version > WAL_VERSION:
        return ("corrupt", f"future schema version {version}")
    body_end = off + _HEADER.size + plen
    if len(data) < body_end + _CRC.size:
        return ("corrupt", "short frame body")
    (crc,) = _CRC.unpack_from(data, body_end)
    if crc != (zlib.crc32(data[off:body_end]) & 0xFFFFFFFF):
        return ("corrupt", "CRC mismatch")
    rec = WalRecord(op, lsn, bytes(data[off + _HEADER.size:body_end]))
    return ("ok", rec, body_end + _CRC.size)


def _segment_paths(directory: str) -> List[str]:
    """Segment files in LSN order (zero-padded names sort)."""
    return sorted(glob.glob(os.path.join(directory, "wal-*.log")))


def _segment_name(first_lsn: int) -> str:
    return f"wal-{first_lsn:016d}.log"


# -------------------------------------------------------------- writer
class WalWriter:
    """Appender over a directory of log segments; thread-safe (the
    mutation path and the compactor both append)."""

    def __init__(self, directory: str, sync: Optional[str] = None,
                 segment_bytes: Optional[int] = None, next_lsn: int = 1):
        self.directory = directory
        self.sync = sync_mode_default() if sync is None else str(sync)
        if self.sync not in SYNC_MODES:
            raise ValueError(f"WalWriter: sync must be one of {SYNC_MODES},"
                             f" got {self.sync!r}")
        self.segment_bytes = (segment_bytes_default() if segment_bytes is None
                              else max(1 << 10, int(segment_bytes)))
        self._lock = threading.Lock()
        self._next_lsn = max(1, int(next_lsn))
        self._durable_lsn = self._next_lsn - 1
        self._dirty = False
        self._f = None
        self._seg_written = 0
        self._fsyncs = 0
        os.makedirs(directory, exist_ok=True)
        self._open_segment_locked()

    def _open_segment_locked(self) -> None:
        path = os.path.join(self.directory, _segment_name(self._next_lsn))
        self._f = open(path, "ab")
        self._seg_written = self._f.tell()

    def _rotate_locked(self) -> None:
        self._fsync_locked(force=self.sync != "none")
        self._f.close()
        self._open_segment_locked()

    def _fsync_locked(self, force: bool = False) -> None:
        if not self._dirty and not force:
            return
        self._f.flush()
        if self.sync != "none" or force:
            fault_point("wal_fsync")
            os.fsync(self._f.fileno())
            self._fsyncs += 1
            self._count(WAL_FSYNCS, 1)
        self._dirty = False
        self._durable_lsn = self._next_lsn - 1
        self._gauge(WAL_DURABLE_LSN, self._durable_lsn,
                    "Highest fsynced WAL log sequence number")

    @staticmethod
    def _count(name: str, n: int, **labels) -> None:
        try:
            from raft_tpu_torch.observability.metrics import get_registry

            get_registry().counter(
                name, labels or None,
                help="Write-ahead-log activity").inc(n)
        except Exception:
            pass

    @staticmethod
    def _gauge(name: str, value: float, help: str) -> None:
        try:
            from raft_tpu_torch.observability.metrics import get_registry

            get_registry().gauge(name, help=help).set(value)
        except Exception:
            pass

    @property
    def last_lsn(self) -> int:
        """Highest assigned lsn (durable only up to :attr:`durable_lsn`
        until the next commit)."""
        with self._lock:
            return self._next_lsn - 1

    @property
    def durable_lsn(self) -> int:
        with self._lock:
            return self._durable_lsn

    def append(self, op: int, payload: bytes) -> int:
        """Append one record; returns its lsn. ``sync="always"`` fsyncs
        inline; otherwise durability waits for :meth:`commit`. The
        ``wal_append`` site comes before any byte is written."""
        fault_point("wal_append")
        with self._lock:
            lsn = self._next_lsn
            frame = encode_frame(op, lsn, payload)
            self._f.write(frame)
            self._next_lsn = lsn + 1
            self._dirty = True
            self._seg_written += len(frame)
            self._count(WAL_APPENDS, 1, op=_OP_NAMES.get(op, str(op)))
            self._count(WAL_BYTES, len(frame))
            if self.sync == "always":
                self._fsync_locked()
            if self._seg_written >= self.segment_bytes:
                self._rotate_locked()
        return lsn

    def commit(self) -> int:
        """Make everything appended so far durable (per the sync mode);
        returns the durable lsn, the ack line. ``sync="none"`` flushes to
        the OS and skips the fsync."""
        with self._lock:
            if self._dirty:
                if self.sync == "none":
                    self._f.flush()
                    self._dirty = False
                    self._durable_lsn = self._next_lsn - 1
                else:
                    self._fsync_locked()
            return self._durable_lsn

    def rotate(self) -> None:
        """Start a new segment (a checkpoint rotates, so the previous
        segment becomes retirable once the watermark covers it)."""
        with self._lock:
            if self._seg_written:
                self._rotate_locked()

    def retire_through(self, watermark_lsn: int) -> int:
        """Delete whole segments whose every record has lsn ≤
        ``watermark_lsn``; the active segment always stays. Runs outside
        the append lock (rotation only adds newer segments, and a lost
        unlink race stops at the OSError). Returns how many went."""
        removed = 0
        paths = _segment_paths(self.directory)
        for i, path in enumerate(paths[:-1]):
            # segment i ends just before segment i+1's first lsn
            nxt = os.path.basename(paths[i + 1])
            try:
                next_first = int(nxt[len("wal-"):-len(".log")])
            except ValueError:
                break
            if next_first - 1 > watermark_lsn:
                break
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                break
        self._gauge(WAL_SEGMENTS, len(_segment_paths(self.directory)),
                    "Live WAL segment files")
        if removed:
            try:
                from raft_tpu_torch.observability.timeline import emit_marker

                emit_marker("wal_retire", segments=removed,
                            watermark_lsn=int(watermark_lsn))
            except Exception:
                pass
        return removed

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._fsync_locked(force=self.sync != "none")
                finally:
                    self._f.close()
                    self._f = None

    def stats(self) -> Dict:
        segments = len(_segment_paths(self.directory))   # outside the lock
        with self._lock:
            return {"sync": self.sync, "last_lsn": self._next_lsn - 1,
                    "durable_lsn": self._durable_lsn, "segments": segments,
                    "segment_bytes": self.segment_bytes,
                    "fsyncs": self._fsyncs}


# -------------------------------------------------------------- replay
def replay(directory: str, from_lsn: int = 0,
           truncate: bool = False) -> Tuple[List[WalRecord], Dict]:
    """Scan the log; returns (records with ``lsn > from_lsn``, checkpoint
    marks left out, stats). Never raises: a bad CRC, a short frame, an
    unreadable segment or a duplicate or regressing lsn ends the scan,
    everything after it counts as ``truncated_bytes``, and with
    ``truncate=True`` (recovery) the torn tail is truncated and later
    segments deleted, so new appends never follow garbage."""
    records: List[WalRecord] = []
    stats = {"records": 0, "last_lsn": 0, "truncated_bytes": 0,
             "segments": 0, "stopped_early": False, "stop_reason": ""}
    paths = _segment_paths(directory) if os.path.isdir(directory) else []
    stats["segments"] = len(paths)
    last_lsn = None
    stopped = False
    for i, path in enumerate(paths):
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as e:
            stopped = True
            stats["stop_reason"] = f"unreadable segment: {e}"
            stats["truncated_bytes"] += sum(_size_of(p) for p in paths[i:])
            break
        off = 0
        while True:
            out = _read_frame(data, off)
            if out[0] == "eof":
                break
            if out[0] == "corrupt":
                stopped = True
                stats["stop_reason"] = out[1]
            else:
                rec, noff = out[1], out[2]
                if last_lsn is not None and rec.lsn <= last_lsn:
                    stopped = True
                    stats["stop_reason"] = (
                        f"lsn {rec.lsn} does not advance past {last_lsn} "
                        f"(duplicate/regressing)")
                else:
                    last_lsn = rec.lsn
                    if rec.lsn > from_lsn and rec.op != OP_CHECKPOINT:
                        records.append(rec)
                    off = noff
                    continue
            # corruption boundary: count (and optionally truncate) the
            # rest of this segment, drop every later one
            stats["truncated_bytes"] += len(data) - off
            if truncate:
                try:
                    with open(path, "r+b") as f:
                        f.truncate(off)
                except OSError:
                    pass
            break
        if stopped:
            for later in paths[i + 1:]:
                stats["truncated_bytes"] += _size_of(later)
                if truncate:
                    try:
                        os.unlink(later)
                    except OSError:
                        pass
            break
    stats["records"] = len(records)
    stats["last_lsn"] = last_lsn or 0
    stats["stopped_early"] = stopped
    return records, stats


def _size_of(path: str) -> int:
    try:
        return os.path.getsize(path)
    except OSError:
        return 0
