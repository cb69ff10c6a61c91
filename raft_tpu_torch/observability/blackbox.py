"""Black-box recorder: a crash-durable mmap ring of forensic records.

Counterpart of ``raft_tpu/observability/blackbox.py``, with its file
format byte for byte: either package reads the other's files. The deaths
that matter most (SIGKILL, an out-of-memory kill, a native crash, a
silent hang) never reach a Python ``except`` handler, so nothing live
survives them. This is the evidence that outlives the process: a
fixed-size memory-mapped ring file that mirrors the flight-recorder
timeline, carries periodic compact metrics snapshots and watchdog stall
dumps, and is readable after any death because the kernel owns the dirty
pages the moment the copy lands.

- **File layout**: a 64-byte run header (magic ``RBB1``, version, ring
  geometry, pid, wall and monotonic start) followed by a fixed
  ``ring_bytes`` region of CRC-framed records.
- **Record frame** (little-endian)::

      magic   4B  b"RBX1"
      version u16 schema version (1)
      rtype   u8  1=event 2=snapshot 3=dump 4=epilogue
      flags   u8  reserved (0)
      seq     u64 monotone record sequence (1-based)
      plen    u32 payload length
      payload plen bytes (compact JSON)
      crc32   u32 over magic..payload

- **Appends are bump-pointer copies into the mmap**: no syscall and no
  fsync on the hot path (page-cache durability survives process death;
  power loss is not in scope).
- **Wraparound**: a record that does not fit in the tail of the ring
  zero-fills the remainder and restarts at offset 0. Recovery scans the
  whole ring for CRC-valid frames and orders them by ``seq``; the torn
  frontier fails its CRC and is skipped.
- **Clean vs violent death**: :meth:`BlackBox.close` emits the
  ``epilogue`` flight event and appends the epilogue record as the
  newest frame. A file whose newest record is not an epilogue was a
  violent death, and :func:`reconstruct` says so (``crash``, or ``hang``
  when the watchdog got a stall dump in first).
- **Nothing when off**: with no blackbox installed the flight mirror is
  one module-attribute read and a ``None`` test per event.

Enable with ``RAFT_TPU_BLACKBOX_PATH`` (+ ``RAFT_TPU_BLACKBOX_BYTES``,
default 1 MiB) or ``ServingEngine(blackbox_path=...)``; a restarted
engine serves the prior run's reconstruction at debugz ``/crashz``.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
import threading
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

from raft_tpu_torch.core import env

BB_FILE_MAGIC = b"RBB1"
BB_MAGIC = b"RBX1"
BB_VERSION = 1

#: record types
REC_EVENT, REC_SNAPSHOT, REC_DUMP, REC_EPILOGUE = 1, 2, 3, 4
_REC_NAMES = {REC_EVENT: "event", REC_SNAPSHOT: "snapshot",
              REC_DUMP: "dump", REC_EPILOGUE: "epilogue"}

# file header: magic, version, flags, ring_off, ring_bytes, pid,
# reserved, wall_start, mono_start — padded to HEADER_SIZE
_FILE_HEADER = struct.Struct("<4sHHIQIIdd")
HEADER_SIZE = 64

# record frame header (the WAL _HEADER shape with rtype in the op slot)
_FRAME = struct.Struct("<4sHBBQI")
_CRC = struct.Struct("<I")

BLACKBOX_PATH_ENV = "RAFT_TPU_BLACKBOX_PATH"
BLACKBOX_BYTES_ENV = "RAFT_TPU_BLACKBOX_BYTES"
DEFAULT_RING_BYTES = 1 << 20
_MIN_RING_BYTES = 1 << 14

#: restart-detected violent deaths (bumped by ServingEngine at boot
#: when the prior run's blackbox has no epilogue)
UNCLEAN_SHUTDOWNS = "raft_tpu_unclean_shutdowns_total"

_VERDICTS = ("clean", "crash", "hang")

#: the compact JSON encoder of every mirrored event (the bytes of
#: ``json.dumps(event, separators=(",", ":"), default=str)``; one
#: instance, since ``json.dumps`` with arguments builds an encoder a call)
_ENCODER = json.JSONEncoder(separators=(",", ":"), default=str)


def ring_bytes_default() -> int:
    n = env.get(BLACKBOX_BYTES_ENV, DEFAULT_RING_BYTES)
    return max(_MIN_RING_BYTES, int(n))


class BlackBox:
    """Writer over one crash-durable ring file.

    ``append()`` frames + CRCs the payload and memcpys it into the
    mmap under a tiny lock — no syscall, no allocation beyond the
    frame bytes. The writer tracks its own overhead
    (``append_seconds``) so a run can report an honest overhead
    fraction into the artifact.
    """

    def __init__(self, path: str, nbytes: Optional[int] = None,
                 snapshot_interval_s: float = 1.0):
        self.path = path
        ring = int(nbytes) if nbytes else ring_bytes_default()
        self.ring_bytes = max(_MIN_RING_BYTES, ring)
        self.snapshot_interval_s = max(0.0, float(snapshot_interval_s))
        self._lock = threading.Lock()
        self._off = 0              # write offset within the ring region
        self._seq = 0
        self._closed = False
        self._last_snapshot = 0.0  # monotonic; 0 = never
        # stats (mutated under _lock)
        self.records = 0
        self.bytes_written = 0
        self.append_seconds = 0.0
        self.dropped_oversize = 0
        parent = os.path.dirname(os.path.abspath(path))
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._file = open(path, "w+b")
        self._file.truncate(HEADER_SIZE + self.ring_bytes)
        self._mm = mmap.mmap(self._file.fileno(),
                             HEADER_SIZE + self.ring_bytes)
        head = _FILE_HEADER.pack(BB_FILE_MAGIC, BB_VERSION, 0,
                                 HEADER_SIZE, self.ring_bytes,
                                 os.getpid(), 0, time.time(),
                                 time.perf_counter())
        self._mm[0:len(head)] = head

    # -- the hot path -----------------------------------------------------
    def append(self, rtype: int, payload: bytes) -> bool:
        """Frame + CRC ``payload`` and memcpy it into the ring. Returns
        False (never raises) when closed or the record exceeds the
        whole ring."""
        t0 = time.perf_counter()
        frame_len = _FRAME.size + len(payload) + _CRC.size
        with self._lock:
            if self._closed:
                return False
            if frame_len > self.ring_bytes:
                self.dropped_oversize += 1
                return False
            self._seq += 1
            head = _FRAME.pack(BB_MAGIC, BB_VERSION, rtype, 0,
                               self._seq, len(payload))
            frame = head + payload + _CRC.pack(
                zlib.crc32(head + payload) & 0xFFFFFFFF)
            if self._off + frame_len > self.ring_bytes:
                # zero the tail so the old frame straddling the wrap
                # point cannot half-parse, then restart at the front
                tail = self.ring_bytes - self._off
                if tail:
                    self._mm[HEADER_SIZE + self._off:
                             HEADER_SIZE + self.ring_bytes] = b"\0" * tail
                self._off = 0
            start = HEADER_SIZE + self._off
            self._mm[start:start + frame_len] = frame
            self._off += frame_len
            self.records += 1
            self.bytes_written += frame_len
            self.append_seconds += time.perf_counter() - t0
        return True

    def append_event(self, event: Dict) -> bool:
        """Mirror one flight event (called by ``FlightRecorder.record``
        for every event when this blackbox is installed). Never raises
        into the emit path."""
        try:
            payload = _ENCODER.encode(event).encode()
        except Exception:
            return False
        return self.append(REC_EVENT, payload)

    # -- periodic snapshots ------------------------------------------------
    def snapshot(self, inflight: Optional[List[Dict]] = None,
                 extra: Optional[Dict] = None) -> Optional[Dict]:
        """Append one compact metrics snapshot (counters/gauges by
        name+labels, histogram count/sum/p50/p99, flight ring seq +
        dropped). Never raises; returns the snapshot dict or None."""
        try:
            snap: Dict = {"ts": time.perf_counter(),
                          "wall": time.time(),
                          "metrics": _compact_metrics()}
            try:
                from raft_tpu_torch.observability.flight import (
                    get_flight_recorder, sync_dropped_metric)

                rec = get_flight_recorder()
                snap["flight"] = {"seq": rec.seq,
                                  "dropped": sync_dropped_metric()}
            except Exception:
                pass
            if inflight is not None:
                snap["inflight"] = inflight
            if extra:
                snap.update(extra)
            payload = json.dumps(snap, separators=(",", ":"),
                                 default=str).encode()
        except Exception:
            return None
        self.append(REC_SNAPSHOT, payload)
        self._last_snapshot = time.monotonic()
        return snap

    def maybe_snapshot(self, inflight: Optional[List[Dict]] = None
                       ) -> Optional[Dict]:
        """Rate-limited :meth:`snapshot` (the watchdog calls this every
        tick; most calls are one clock read)."""
        now = time.monotonic()
        if now - self._last_snapshot < self.snapshot_interval_s:
            return None
        return self.snapshot(inflight=inflight)

    def dump(self, payload: Dict) -> bool:
        """Append one watchdog stall dump (thread stacks, in-flight
        table, blocked-lock sites). Never raises."""
        try:
            data = json.dumps(payload, separators=(",", ":"),
                              default=str).encode()
        except Exception:
            return False
        return self.append(REC_DUMP, data)

    # -- lifecycle ---------------------------------------------------------
    @property
    def seq(self) -> int:
        with self._lock:
            return self._seq

    @property
    def closed(self) -> bool:
        return self._closed

    def stats(self) -> Dict:
        with self._lock:
            return {"path": self.path,
                    "ring_bytes": self.ring_bytes,
                    "records": self.records,
                    "bytes_written": self.bytes_written,
                    "append_seconds": self.append_seconds,
                    "dropped_oversize": self.dropped_oversize,
                    "seq": self._seq}

    def close(self, reason: str = "clean") -> None:
        """Emit the ``epilogue`` flight event, append the epilogue
        record as the final (max-seq) frame, flush and unmap. A process
        that dies before this leaves an epilogue-less file — which is
        the whole point."""
        if self._closed:
            return
        try:
            from raft_tpu_torch.observability.timeline import emit_epilogue

            emit_epilogue(reason, records=self.records,
                          bytes_written=self.bytes_written)
        except Exception:
            pass
        try:
            payload = json.dumps(
                {"reason": reason, "ts": time.perf_counter(),
                 "wall": time.time(), "records": self.records,
                 "bytes_written": self.bytes_written},
                separators=(",", ":")).encode()
            self.append(REC_EPILOGUE, payload)
        except Exception:
            pass
        with self._lock:
            self._closed = True
        # I/O outside the append lock: flush is advisory (the page
        # cache already owns the bytes); never let it mask shutdown
        try:
            self._mm.flush()
        except Exception:
            pass
        try:
            self._mm.close()
            self._file.close()
        except Exception:
            pass


def _compact_metrics() -> Dict:
    """The registry as one flat JSON-friendly dict: counters/gauges by
    ``name{labels}``, histograms as count/sum/p50/p99."""
    from raft_tpu_torch.observability.metrics import Histogram, get_registry

    out: Dict = {}
    for m in get_registry().collect():
        label_s = ",".join(f"{k}={v}"
                           for k, v in sorted(m.labels.items()))
        key = m.name + (f"{{{label_s}}}" if label_s else "")
        if isinstance(m, Histogram):
            out[key] = {"count": m.count, "sum": round(m.sum, 9),
                        "p50": m.percentile(50), "p99": m.percentile(99)}
        else:
            out[key] = m.value
    return out


# ------------------------------------------------------- process global
_active: Optional[BlackBox] = None
_active_lock = threading.Lock()


def active() -> Optional[BlackBox]:
    """The installed process blackbox, or None (the disabled state)."""
    return _active


def install(bb: Optional[BlackBox]) -> Optional[BlackBox]:
    """Install ``bb`` as the process blackbox AND the flight-recorder
    mirror (None uninstalls). Returns the previous one."""
    global _active
    from raft_tpu_torch.observability import flight

    with _active_lock:
        prev, _active = _active, bb
        flight._mirror = bb
        return prev


class BootResult(NamedTuple):
    """What :func:`boot` found and did."""

    recorder: Optional[BlackBox]   # the installed blackbox (None = off)
    prior: Optional[Dict]          # prior run's reconstruction, if any
    created: bool                  # True when boot opened the file


def boot(path: Optional[str] = None,
         nbytes: Optional[int] = None) -> BootResult:
    """Open-and-install the env/arg-configured blackbox, first
    reconstructing (and preserving as ``<path>.prev``) a prior run's
    file when that run died without an epilogue. No-op returning the
    already-installed recorder when one exists; no-op entirely when
    neither ``path`` nor ``RAFT_TPU_BLACKBOX_PATH`` is set (the
    defaults-off contract). Never raises."""
    if _active is not None:
        return BootResult(_active, None, False)
    if path is None:
        path = env.get(BLACKBOX_PATH_ENV)
    if not path:
        return BootResult(None, None, False)
    prior = None
    try:
        if os.path.exists(path):
            prior = reconstruct(path)
            if prior is not None and prior.get("verdict") != "clean":
                prev_path = path + ".prev"
                try:
                    os.replace(path, prev_path)
                    prior["preserved_path"] = prev_path
                except OSError:
                    pass
        bb = BlackBox(path, nbytes=nbytes)
    except Exception as e:
        from raft_tpu_torch.core.logger import log_warn

        log_warn("blackbox: could not open %s: %s — forensics off",
                 path, e)
        return BootResult(None, prior, False)
    install(bb)
    return BootResult(bb, prior, True)


def shutdown(reason: str = "clean") -> None:
    """Close the installed blackbox with an epilogue and uninstall the
    mirror (the clean-shutdown half of the verdict contract)."""
    bb = _active
    if bb is None:
        return
    install(None)
    bb.close(reason=reason)


# --------------------------------------------------------------- reader
def _parse_file_header(data: bytes) -> Dict:
    if len(data) < HEADER_SIZE:
        raise ValueError("blackbox: file shorter than the run header")
    (magic, version, _flags, ring_off, ring_bytes, pid, _res,
     wall_start, mono_start) = _FILE_HEADER.unpack_from(data, 0)
    if magic != BB_FILE_MAGIC:
        raise ValueError(f"blackbox: bad file magic {magic!r}")
    if version > BB_VERSION:
        raise ValueError(f"blackbox: future schema version {version}")
    return {"version": version, "ring_off": ring_off,
            "ring_bytes": ring_bytes, "pid": pid,
            "wall_start": wall_start, "mono_start": mono_start}


def scan_ring(data: bytes) -> Tuple[List[Tuple[int, int, bytes]], int]:
    """Full-ring scan for CRC-valid frames → ([(seq, rtype, payload)]
    in seq order, torn-candidate count). The write frontier's
    half-overwritten frame, zero-fill pads and stale wrap remnants all
    fail magic/CRC and are skipped — the WAL torn-tail contract,
    applied to a ring."""
    recs: Dict[int, Tuple[int, int, bytes]] = {}
    torn = 0
    off, end = 0, len(data)
    min_frame = _FRAME.size + _CRC.size
    while off + min_frame <= end:
        if data[off:off + 4] != BB_MAGIC:
            off += 1
            continue
        _magic, version, rtype, _flags, seq, plen = _FRAME.unpack_from(
            data, off)
        body_end = off + _FRAME.size + plen
        if version > BB_VERSION or body_end + _CRC.size > end:
            torn += 1
            off += 1
            continue
        (crc,) = _CRC.unpack_from(data, body_end)
        if crc != (zlib.crc32(data[off:body_end]) & 0xFFFFFFFF):
            torn += 1
            off += 1
            continue
        recs[seq] = (seq, rtype,
                     bytes(data[off + _FRAME.size:body_end]))
        off = body_end + _CRC.size
    return [recs[s] for s in sorted(recs)], torn


def read_blackbox(path: str) -> Dict:
    """Parse one blackbox file: run header + every recoverable record
    (seq order, JSON-decoded; undecodable payloads counted, not
    raised). Raises only on a missing/um-parseable FILE header — a
    torn ring never raises."""
    with open(path, "rb") as f:
        data = f.read()
    header = _parse_file_header(data)
    ring = data[header["ring_off"]:
                header["ring_off"] + header["ring_bytes"]]
    raw, torn = scan_ring(ring)
    records, undecodable = [], 0
    for seq, rtype, payload in raw:
        try:
            body = json.loads(payload.decode())
        except Exception:
            undecodable += 1
            continue
        records.append({"seq": seq, "rtype": rtype,
                        "type": _REC_NAMES.get(rtype, f"rtype{rtype}"),
                        "body": body})
    return {"path": path, "header": header, "records": records,
            "torn_records": torn, "undecodable_records": undecodable}


def reconstruct(path: str, tail_events: int = 0) -> Optional[Dict]:
    """The postmortem view of one blackbox file, or None when the file
    is missing/unreadable (a restart probe, not an error path).

    The verdict:

    - ``clean`` — the newest record is an epilogue (the process called
      :meth:`BlackBox.close`);
    - ``hang``  — no epilogue, and the watchdog got a stall dump (or
      ``stall`` flight event) into the ring before death;
    - ``crash`` — no epilogue, no stall evidence: the process died
      violently with the batcher still healthy (SIGKILL, OOM, native
      crash).

    Also reconstructs: the flight-event tail (all recovered events, or
    the newest ``tail_events``), the FINAL metrics snapshot, the alert
    transitions still firing at death, and the in-flight request table
    from the newest stall dump / snapshot that carried one."""
    try:
        parsed = read_blackbox(path)
    except (OSError, ValueError):
        return None
    records = parsed["records"]
    events = [r["body"] for r in records if r["rtype"] == REC_EVENT]
    snapshots = [r["body"] for r in records
                 if r["rtype"] == REC_SNAPSHOT]
    dumps = [r["body"] for r in records if r["rtype"] == REC_DUMP]
    epilogue = None
    if records and records[-1]["rtype"] == REC_EPILOGUE:
        epilogue = records[-1]["body"]
    stalls = [e for e in events if e.get("kind") == "stall"]
    if epilogue is not None:
        verdict = "clean"
    elif dumps or stalls:
        verdict = "hang"
    else:
        verdict = "crash"
    # alert transitions: the last state per (slo, severity) wins
    alert_state: Dict[Tuple[str, str], Dict] = {}
    for e in events:
        if e.get("kind") != "alert":
            continue
        key = (str(e.get("name")), str(e.get("severity")))
        alert_state[key] = e
    firing = [e for e in alert_state.values()
              if e.get("state") == "firing"]
    # in-flight at death: newest dump wins, else newest snapshot
    inflight = None
    for source in (dumps, snapshots):
        for body in reversed(source):
            if body.get("inflight") is not None:
                inflight = body["inflight"]
                break
        if inflight is not None:
            break
    if tail_events and len(events) > tail_events:
        events = events[-tail_events:]
    return {
        "path": path,
        "verdict": verdict,
        "pid": parsed["header"]["pid"],
        "wall_start": parsed["header"]["wall_start"],
        "mono_start": parsed["header"]["mono_start"],
        "ring_bytes": parsed["header"]["ring_bytes"],
        "records": len(records),
        "torn_records": parsed["torn_records"],
        "undecodable_records": parsed["undecodable_records"],
        "events": events,
        "snapshots": len(snapshots),
        "final_snapshot": snapshots[-1] if snapshots else None,
        "stall_dumps": dumps,
        "stall_events": stalls,
        "firing_alerts": firing,
        "inflight": inflight,
        "epilogue": epilogue,
    }
