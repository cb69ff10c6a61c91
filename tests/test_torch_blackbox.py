"""The port's crash-durable blackbox and hang watchdog
(raft_tpu_torch.observability.{blackbox,watchdog}) against the
reference's file format on the CPU.

Files are read across both ways: a file the port writes goes through
``raft_tpu.observability.blackbox.reconstruct`` and one the reference
writes through the port's, with equal records and verdicts, for a clean
stop, a torn tail, a wrapped ring and a writer killed with SIGKILL. The
same appends give the same ring bytes in both packages. The watchdog
reports a stall of a heartbeat that stops, as the reference's does.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from raft_tpu.observability import blackbox as jbb
from raft_tpu.observability import watchdog as jwd
from raft_tpu_torch import observability as obs
from raft_tpu_torch.observability import blackbox as bb
from raft_tpu_torch.observability import watchdog as wd
from raft_tpu_torch.resilience import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_planes():
    obs.reset()
    faults.clear()
    yield
    bb.shutdown()
    obs.reset()
    faults.clear()


def _events(seed: int, n: int):
    rng = np.random.default_rng(seed)
    kinds = ("serving", "flow", "fault", "explain", "alert", "marker")
    return [{"kind": kinds[rng.integers(len(kinds))], "name": f"e{i}",
             "ts": float(i) * 1e-3, "ph": "i", "lane": "serving",
             "rows": int(rng.integers(1, 256)),
             "pad": "x" * int(rng.integers(0, 300))} for i in range(n)]


def _write(mod, path, seed: int, n: int, nbytes: int, close: bool,
           snapshot: bool = True):
    box = mod.BlackBox(path, nbytes=nbytes)
    for i, ev in enumerate(_events(seed, n)):
        box.append_event(ev)
        if i % 50 == 25:
            box.dump({"i": i})
    if snapshot:
        box.append(mod.REC_SNAPSHOT, json.dumps(
            {"ts": 1.0, "metrics": {"a": 1}, "inflight": [{"rid": 7}]},
            separators=(",", ":")).encode())
    if close:
        box.close()
    else:
        box._mm.flush()
    return box


def _same_reads(path):
    """Both packages' reconstruction of one file, compared whole."""
    a, b = bb.reconstruct(path), jbb.reconstruct(path)
    assert a is not None and a == b
    assert bb.read_blackbox(path) == jbb.read_blackbox(path)
    return a


CASES = {
    # name: (events, ring bytes, closed)
    "clean": (120, 1 << 16, True),
    "torn_tail": (120, 1 << 16, False),
    "wrapped": (900, 1 << 14, True),
    "wrapped_open": (900, 1 << 14, False),
}


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_files_read_across_both_ways(tmp_path, case, writer):
    n, nbytes, close = CASES[case]
    path = str(tmp_path / "bb.bin")
    mod = bb if writer == "port" else jbb
    box = _write(mod, path, seed=3, n=n, nbytes=nbytes, close=close)
    if case == "torn_tail":
        # tear the newest frame: overwrite its CRC with garbage
        off = bb.HEADER_SIZE + box._off - 4
        with open(path, "r+b") as f:
            f.seek(off)
            f.write(b"\xde\xad\xbe\xef")
    rec = _same_reads(path)
    want = {"clean": "clean", "torn_tail": "hang", "wrapped": "clean",
            "wrapped_open": "hang"}[case]
    assert rec["verdict"] == want
    if case == "torn_tail":
        assert rec["torn_records"] >= 1
    if case.startswith("wrapped"):
        assert rec["records"] < n             # the ring overwrote its head
        seqs = [e["name"] for e in rec["events"]]
        assert seqs == sorted(seqs, key=lambda s: int(s[1:]))
    if not close:
        box.close()


def test_same_appends_give_the_same_ring_bytes(tmp_path):
    paths, boxes = {}, []
    for name, mod in (("port", bb), ("ref", jbb)):
        paths[name] = str(tmp_path / f"{name}.bin")
        # left open: the epilogue carries the closing time
        boxes.append(_write(mod, paths[name], seed=9, n=700,
                            nbytes=1 << 14, close=False))
    data = {k: open(p, "rb").read() for k, p in paths.items()}
    for box in boxes:
        box.close()
    assert data["port"][bb.HEADER_SIZE:] == data["ref"][jbb.HEADER_SIZE:]
    # the headers differ only in pid and the two start clocks
    hp = bb._parse_file_header(data["port"])
    hr = jbb._parse_file_header(data["ref"])
    for key in ("version", "ring_off", "ring_bytes"):
        assert hp[key] == hr[key]
    assert data["port"][:4] == b"RBB1"
    assert (bb._FILE_HEADER.format, bb._FRAME.format) == (
        jbb._FILE_HEADER.format, jbb._FRAME.format) == ("<4sHHIQIIdd",
                                                        "<4sHBBQI")


WRITER = r"""
import sys, time
sys.path.insert(0, sys.argv[2])
from {pkg}.observability import blackbox, timeline
box = blackbox.BlackBox(sys.argv[1], nbytes=1 << 15)
blackbox.install(box)
box.snapshot(inflight=[{{"rid": 1}}])
i = 0
print("READY", flush=True)
while True:
    timeline.emit_serving("flush", bucket=32, rows=i)
    i += 1
    if i % 200 == 0:
        time.sleep(0.001)
"""


@pytest.mark.parametrize("pkg", ["raft_tpu_torch", "raft_tpu"])
def test_sigkilled_writer_reads_crash_both_ways(tmp_path, pkg):
    path = str(tmp_path / "bb.bin")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", WRITER.format(pkg=pkg), path, REPO],
        stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert proc.stdout.readline().strip() == "READY"
        time.sleep(0.3)
        proc.send_signal(signal.SIGKILL)
        proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()
    rec = _same_reads(path)
    assert rec["verdict"] == "crash" and rec["epilogue"] is None
    assert rec["records"] > 10
    assert all(e["kind"] == "serving" for e in rec["events"])


def test_boot_preserves_an_unclean_file_and_the_engine_serves_it(tmp_path):
    from raft_tpu_torch.distance.knn_fused import prepare_knn_index
    from raft_tpu_torch.serving import ServingEngine

    path = str(tmp_path / "bb.bin")
    box = _write(bb, path, seed=1, n=40, nbytes=1 << 15, close=False)
    del box
    rng = np.random.default_rng(0)
    y = rng.normal(size=(1024, 16)).astype(np.float32)
    idx = prepare_knn_index(y, device="cpu", passes=3, T=256, Qb=32, g=2)
    eng = ServingEngine(idx, k=4, buckets=(8,), blackbox_path=path,
                        flush_interval_s=0.002).start()
    try:
        report = eng.crash_report
        assert report["verdict"] == "hang"   # its dumps read as a hang
        assert report["preserved_path"] == path + ".prev"
        assert os.path.exists(path + ".prev")
        assert obs.get_registry().counter(
            bb.UNCLEAN_SHUTDOWNS).value == 1
        assert eng.stats()["prior_crash"]["verdict"] == "hang"
        eng.query(rng.normal(size=(3, 16)).astype(np.float32), timeout=30)
    finally:
        eng.stop()
    assert bb.reconstruct(path)["verdict"] == "clean"
    assert jbb.reconstruct(path + ".prev")["verdict"] == "hang"
    assert bb.active() is None


# ------------------------------------------------------------------
# the watchdog
# ------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 50.0

    def __call__(self):
        return self.t


class _Engine:
    def __init__(self, rows):
        self.rows = rows

    def inflight_requests(self):
        return list(self.rows)


@pytest.mark.parametrize("case", ["silent_beat", "overdue", "healthy"])
def test_watchdog_ticks_as_the_reference(case, tmp_path):
    """The same beats, in-flight tables and clock steps: both watchdogs
    open (and latch) a stall episode on the same ticks."""
    outs = []
    for mod, bmod in ((wd, bb), (jwd, jbb)):
        clock = _Clock()
        rows = ([{"rid": 3, "kind": "query", "rows": 8, "age_s": 9.0,
                  "deadline_in_s": -2.0}] if case == "overdue" else [])
        w = mod.Watchdog(engine=_Engine(rows), interval_s=0.5, clock=clock)
        ticks = []
        for i in range(12):
            if case != "silent_beat" or i < 3:
                w.beat()
            clock.t += 0.5
            d = w.tick()
            ticks.append(None if d is None else (
                d["trigger"]["source"], d["trigger"]["overdue_requests"]))
        outs.append((ticks, w.stalls, w.stats()["stall_active"]))
    assert outs[0] == outs[1]
    assert (outs[0][1] > 0) == (case != "healthy")


def test_dump_stacks_names_blocked_threads():
    import threading

    ev, started = threading.Event(), threading.Event()

    def parked():
        started.set()
        ev.wait(10)

    t = threading.Thread(target=parked, name="parked-thread")
    t.start()
    started.wait(5)
    try:
        d = wd.dump_stacks()
        row = [r for r in d["threads"] if r["name"] == "parked-thread"][0]
        assert row["blocked_at"] and "parked" in row["blocked_at"]
        text = wd.format_stacks(d)
        assert "== parked-thread" in text and "in parked" in text
    finally:
        ev.set()
        t.join(5)


def test_engine_watchdog_reports_a_hang_fault(tmp_path):
    """A ``serving_flush:hang`` fault with ``watchdog_s=0.1``: a stall of
    the batcher's heartbeat, /stackz names the batcher in execute_batch,
    the blackbox holds the stall dump, and the hung batch fails by its
    deadline while the engine keeps serving."""
    import urllib.request

    from raft_tpu_torch.core.error import DeadlineExceededError
    from raft_tpu_torch.distance.knn_fused import prepare_knn_index
    from raft_tpu_torch.serving import ServingEngine

    rng = np.random.default_rng(1)
    y = rng.normal(size=(1024, 16)).astype(np.float32)
    idx = prepare_knn_index(y, device="cpu", passes=3, T=256, Qb=32, g=2)
    path = str(tmp_path / "bb.bin")
    eng = ServingEngine(idx, k=4, buckets=(8,), flush_interval_s=0.002,
                        watchdog_s=0.1, debug_port=0,
                        blackbox_path=path).start()
    try:
        faults.configure("serving_flush:hang@call=2")
        ok = eng.submit(rng.normal(size=(2, 16)).astype(np.float32))
        assert eng.flush(30)
        hung = eng.submit(rng.normal(size=(2, 16)).astype(np.float32),
                          deadline_s=2.0)
        t_end = time.time() + 5
        while not eng.stats()["watchdog"]["stalls"] and time.time() < t_end:
            time.sleep(0.02)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{eng.debugz.port}/stackz",
                timeout=10) as resp:
            stackz = resp.read().decode()
        assert isinstance(hung.exception(timeout=30), DeadlineExceededError)
        ok.result(timeout=30)
        faults.clear()
        eng.query(rng.normal(size=(1, 16)).astype(np.float32), timeout=30)
        assert eng.flush(30)
        st = eng.stats()["watchdog"]
    finally:
        faults.clear()
        eng.stop()
    assert st["stalls"] >= 1
    batcher = stackz.split("== serving-batcher", 1)[1].split("\n== ")[0]
    assert "in execute_batch" in batcher and "in _hang" in batcher
    stalls = [e for e in obs.get_flight_recorder().events()
              if e["kind"] == "stall"]
    assert stalls and stalls[0]["name"] == "serving-batcher"
    rec = jbb.reconstruct(path)
    assert rec["verdict"] == "clean" and rec["stall_dumps"]
    assert rec["stall_dumps"][0]["trigger"]["source"] == "serving-batcher"
