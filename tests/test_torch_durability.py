"""The port's durability plane (raft_tpu_torch.mutable.wal / .checkpoint,
core.diskio / .serialize, the resilience fault seam) on the CPU.

- **Byte identity with the reference**: WAL frames and segment files,
  framed array bytes and checkpoint files (``rows.msp``, ``exts.msp``,
  ``manifest.json``) equal the reference's for the same inputs.
- **Cross-recovery**: a durable directory written by ``raft_tpu``'s
  ``MutableIndex`` is recovered by the port, and the reverse, with the
  same live rows and ids and the same search answers.
- **The reference's tier-1 cases** (tests/test_durability.py:75-500):
  round trips, rotation and retirement, sync modes, the corruption fuzz
  (never raises), the torn tail, checkpoint fallback and prune, recovery
  after compaction and from an empty directory, durable-off writing no
  file, and an injected ``wal_append`` failure leaving the index as it
  was.
- **The SIGKILL crash matrix** at the reference's four tier-1 kill points
  (its further points under ``slow``): a subprocess
  (tests/_torch_crash_worker.py) killed at a durability fault site
  recovers with no acked write lost and no write half applied.
"""

import glob
import io
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import raft_tpu.mutable as jm
from raft_tpu.core import serialize as jser
from raft_tpu.mutable import wal as jwal
from raft_tpu_torch.core.diskio import (atomic_write, atomic_write_bytes,
                                        atomic_write_text, read_bytes)
from raft_tpu_torch.core.serialize import (mdspan_from_bytes,
                                           mdspan_to_bytes, read_framed)
from raft_tpu_torch.mutable import (CheckpointStore, MutableIndex,
                                    apply_delete, apply_upsert,
                                    has_durable_state, last_recovery,
                                    recover, search_view, wal_replay)
from raft_tpu_torch.mutable.wal import (OP_DELETE, OP_UPSERT, WalWriter,
                                        decode_delete, decode_upsert,
                                        encode_checkpoint_mark,
                                        encode_delete, encode_frame,
                                        encode_upsert)
from raft_tpu_torch.resilience import faults

from _torch_threads import one_torch_thread  # noqa: F401

_TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
if _TESTS_DIR not in sys.path:
    sys.path.insert(0, _TESTS_DIR)
import _torch_crash_worker as worker  # noqa: E402

rng = np.random.default_rng(12)

#: the reference tests' shared geometry (Qb is a TPU knob the port keeps)
GEOM = dict(T=256, g=2, passes=3)
COMMON = dict(auto_compact=False, compact_threshold=10_000, **GEOM)
PORT = dict(COMMON, device="cpu")


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def _live_state(idx):
    with idx._cond:
        rows, exts = idx._materialize_locked(idx._d_count)
    if isinstance(rows, torch.Tensor):
        rows = rows.cpu().numpy()
    return {int(e): rows[i].tobytes() for i, e in enumerate(exts)}


def _base(m=64, d=8):
    return rng.normal(size=(m, d)).astype(np.float32)


def _rows(n, d=8):
    return rng.normal(size=(n, d)).astype(np.float32)


def _tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = read_bytes(p)
    return out


# ------------------------------------------------------------------
# byte identity with the reference
ARRAYS = [np.arange(7, dtype=np.int32),
          np.zeros((0,), np.int32),
          np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32),
          np.random.default_rng(1).normal(size=(2, 4, 3)),
          np.array(3.5, np.float32)]


@pytest.mark.parametrize("i", range(len(ARRAYS)))
def test_framed_bytes_equal_reference(i):
    a = ARRAYS[i]
    data = mdspan_to_bytes(a)
    assert data == jser.mdspan_to_bytes(a)
    np.testing.assert_array_equal(
        jser.mdspan_from_bytes(data).as_numpy(), a)
    np.testing.assert_array_equal(mdspan_from_bytes(data), a)


def test_wal_frames_and_segments_equal_reference(tmp_path):
    ids = np.array([3, 5], np.int32)
    rows = _rows(2)
    assert encode_upsert(ids, rows) == jwal.encode_upsert(ids, rows)
    assert encode_delete([9, 1]) == jwal.encode_delete([9, 1])
    assert encode_checkpoint_mark(4, 2, "ckpt-x") == \
        jwal.encode_checkpoint_mark(4, 2, "ckpt-x")
    payload = encode_upsert(ids, rows)
    assert encode_frame(OP_UPSERT, 7, payload) == \
        jwal.encode_frame(jwal.OP_UPSERT, 7, payload)
    # the same records through both writers, with a rotation: the same
    # segment files, byte for byte
    dirs = [str(tmp_path / "port"), str(tmp_path / "ref")]
    for d, W in zip(dirs, (WalWriter, jwal.WalWriter)):
        w = W(d, sync="batch", segment_bytes=1 << 10)
        for n in range(12):
            w.append(OP_UPSERT, encode_upsert([n, 100 + n], _rows(2) * 0
                                              + n))
            w.append(OP_DELETE, encode_delete([n]))
        w.commit()
        w.close()
    port, ref = _tree_bytes(dirs[0]), _tree_bytes(dirs[1])
    assert len(port) > 1 and port == ref


def test_checkpoint_files_equal_reference(tmp_path):
    r = np.random.default_rng(3)
    rows = r.normal(size=(40, 6)).astype(np.float32)
    exts = r.permutation(1000)[:40].astype(np.int32)
    CheckpointStore(str(tmp_path / "port")).write(rows, exts, lsn=17,
                                                  generation=3)
    jm.CheckpointStore(str(tmp_path / "ref")).write(rows, exts, lsn=17,
                                                    generation=3)
    port = _tree_bytes(str(tmp_path / "port"))
    ref = _tree_bytes(str(tmp_path / "ref"))
    names = {"CURRENT", "ckpt-00000003-0000000000000017/rows.msp",
             "ckpt-00000003-0000000000000017/exts.msp",
             "ckpt-00000003-0000000000000017/manifest.json"}
    assert set(port) == names and port == ref


def _ops(idx, apply_u, apply_d, d=8):
    r = np.random.default_rng(9)
    apply_u(idx, [100, 101], r.normal(size=(2, d)).astype(np.float32))
    apply_d(idx, [0, 7])
    apply_u(idx, [7, 3], r.normal(size=(2, d)).astype(np.float32))
    apply_d(idx, [100])


def test_reference_directory_recovers_in_the_port(tmp_path):
    """A durable directory the JAX package wrote (genesis checkpoint, a
    WAL tail, a mid-run checkpoint, more tail) recovers in the port with
    the same live rows and ids and the same answers."""
    d = str(tmp_path / "dur")
    Y = _base()
    j = jm.MutableIndex(Y, durable_dir=d, wal_sync="batch", Qb=32, **COMMON)
    _ops(j, jm.apply_upsert, jm.apply_delete)
    j.checkpoint()
    jm.apply_upsert(j, [200], _rows(1))
    j.close()
    t, stats = recover(d, attach=False, **PORT)
    assert stats["replayed_records"] == 1
    assert _live_state(t) == _live_state(j)
    q = _rows(5)
    tv, ti = search_view(t, q, 6)
    jv, ji = jm.search_view(j, q, 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_port_directory_recovers_in_the_reference(tmp_path):
    d = str(tmp_path / "dur")
    Y = _base()
    t = MutableIndex(Y, durable_dir=d, wal_sync="batch", **PORT)
    _ops(t, apply_upsert, apply_delete)
    assert t.compact(block=True)            # a checkpoint at the swap
    apply_delete(t, [101])
    t.close()
    j, stats = jm.recover(d, attach=False, Qb=32, **COMMON)
    assert stats["replayed_records"] == 1
    assert _live_state(j) == _live_state(t)
    q = _rows(5)
    tv, ti = search_view(t, q, 6)
    jv, ji = jm.search_view(j, q, 6)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


# ------------------------------------------------------------------
# diskio + serialize
def test_atomic_write_replaces_and_leaves_no_litter(tmp_path):
    p = tmp_path / "x.bin"
    atomic_write_bytes(str(p), b"one")
    atomic_write_bytes(str(p), b"two")
    assert p.read_bytes() == b"two"
    assert [f for f in os.listdir(tmp_path) if f.startswith(".atomic-")] \
        == []
    atomic_write_text(str(tmp_path / "t.txt"), "hello\n")
    assert (tmp_path / "t.txt").read_text() == "hello\n"
    assert read_bytes(str(tmp_path / "missing")) is None


def test_atomic_write_failure_cleans_tmp(tmp_path):
    p = tmp_path / "y.bin"
    atomic_write_bytes(str(p), b"keep")

    def boom(f):
        raise RuntimeError("writer failed")

    with pytest.raises(RuntimeError):
        atomic_write(str(p), boom)
    assert p.read_bytes() == b"keep"
    assert [f for f in os.listdir(tmp_path) if f.startswith(".atomic-")] \
        == []


def test_serialize_framed_round_trip_and_truncation():
    arr = rng.normal(size=(5, 3)).astype(np.float32)
    data = mdspan_to_bytes(arr)
    np.testing.assert_array_equal(mdspan_from_bytes(data), arr)
    two = data + mdspan_to_bytes(np.arange(4, dtype=np.int32))
    a, off = read_framed(two)
    b, end = read_framed(two, off)
    np.testing.assert_array_equal(a, arr)
    np.testing.assert_array_equal(b, np.arange(4, dtype=np.int32))
    assert end == len(two)
    with pytest.raises(ValueError, match="truncated framed"):
        mdspan_from_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="truncated framed"):
        mdspan_from_bytes(data[:6])


def test_serialize_unframed_fallback_reads_bare_npy():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    buf = io.BytesIO()
    np.save(buf, arr, allow_pickle=False)
    np.testing.assert_array_equal(mdspan_from_bytes(buf.getvalue()), arr)


# ------------------------------------------------------------------
# WAL
def test_wal_round_trip_and_lsn_order(tmp_path):
    w = WalWriter(str(tmp_path), sync="batch")
    ids = np.array([3, 5], np.int32)
    rows = _rows(2, 4)
    assert w.append(OP_UPSERT, encode_upsert(ids, rows)) == 1
    assert w.append(OP_DELETE, encode_delete(np.array([9], np.int32))) == 2
    assert w.durable_lsn == 0
    assert w.commit() == 2
    w.close()
    records, stats = wal_replay(str(tmp_path))
    assert [r.lsn for r in records] == [1, 2]
    rid, rrows = decode_upsert(records[0].payload)
    np.testing.assert_array_equal(rid, ids)
    np.testing.assert_array_equal(rrows, rows)
    np.testing.assert_array_equal(decode_delete(records[1].payload), [9])
    assert stats["stopped_early"] is False and stats["truncated_bytes"] == 0
    tail, _ = wal_replay(str(tmp_path), from_lsn=1)
    assert [r.lsn for r in tail] == [2]


def test_wal_rotation_and_retirement(tmp_path):
    w = WalWriter(str(tmp_path), sync="none", segment_bytes=1 << 10)
    payload = encode_delete(np.arange(64, dtype=np.int32))
    for _ in range(20):
        w.append(OP_DELETE, payload)
    w.commit()
    segs = [f for f in os.listdir(tmp_path) if f.startswith("wal-")]
    assert len(segs) > 1
    records, _ = wal_replay(str(tmp_path))
    assert [r.lsn for r in records] == list(range(1, 21))
    assert w.retire_through(20) == len(segs) - 1
    w.close()
    lsns = [r.lsn for r in wal_replay(str(tmp_path))[0]]
    assert lsns and lsns[-1] == 20 and lsns[0] > 1
    assert lsns == list(range(lsns[0], 21))


def test_wal_sync_mode_env_and_validation(tmp_path, monkeypatch):
    from raft_tpu_torch.mutable.wal import sync_mode_default

    monkeypatch.delenv("RAFT_TPU_WAL_SYNC", raising=False)
    assert sync_mode_default() == "batch"
    monkeypatch.setenv("RAFT_TPU_WAL_SYNC", "always")
    assert sync_mode_default() == "always"
    monkeypatch.setenv("RAFT_TPU_WAL_SYNC", "bogus")
    assert sync_mode_default() == "batch"
    with pytest.raises(ValueError):
        WalWriter(str(tmp_path), sync="fsync-maybe")


WAL_FUZZ_CASES = ("torn_tail", "truncated_frame", "bitflip_payload",
                  "bitflip_crc", "zeroed_file", "garbage", "duplicate_lsn",
                  "regressing_lsn")


@pytest.mark.parametrize("case", WAL_FUZZ_CASES)
def test_wal_corruption_fuzz_never_raises(tmp_path, case):
    f1 = encode_frame(OP_DELETE, 1, encode_delete(np.array([1])))
    f2 = encode_frame(OP_DELETE, 2, encode_delete(np.array([2])))
    f3 = encode_frame(OP_DELETE, 3, encode_delete(np.array([3])))
    frames, want = {
        "torn_tail": ([f1, f2, f3[:len(f3) // 2]], [1, 2]),
        "truncated_frame": ([f1, f2[:8]], [1]),
        "bitflip_payload": ([f1, bytes(bytearray(f2[:24]) + bytearray(
            [f2[24] ^ 0x40]) + f2[25:]), f3], [1]),
        "bitflip_crc": ([f1, f2[:-1] + bytes([f2[-1] ^ 0x01]), f3], [1]),
        "zeroed_file": ([b"\x00" * 128], []),
        "garbage": ([os.urandom(200)], []),
        "duplicate_lsn": ([f1, f2, f2, f3], [1, 2]),
        "regressing_lsn": ([f1, f2, f1], [1, 2]),
    }[case]
    with open(tmp_path / "wal-0000000000000001.log", "wb") as f:
        for fr in frames:
            f.write(fr)
    records, stats = wal_replay(str(tmp_path), truncate=True)
    assert [r.lsn for r in records] == want
    assert stats["stopped_early"] and stats["truncated_bytes"] > 0
    records2, stats2 = wal_replay(str(tmp_path))
    assert [r.lsn for r in records2] == want
    assert stats2["truncated_bytes"] == 0
    nxt = (want[-1] if want else 0) + 1
    w = WalWriter(str(tmp_path), sync="none", next_lsn=nxt)
    w.append(OP_DELETE, encode_delete(np.array([7])))
    w.commit()
    w.close()
    records3, stats3 = wal_replay(str(tmp_path))
    assert [r.lsn for r in records3] == want + [nxt]
    assert stats3["stopped_early"] is False


def test_wal_corrupt_middle_segment_drops_later_segments(tmp_path):
    w = WalWriter(str(tmp_path), sync="none", segment_bytes=1 << 10)
    payload = encode_delete(np.arange(64, dtype=np.int32))
    for _ in range(20):
        w.append(OP_DELETE, payload)
    w.commit()
    w.close()
    segs = sorted(f for f in os.listdir(tmp_path) if f.startswith("wal-"))
    assert len(segs) >= 3
    mid = os.path.join(str(tmp_path), segs[1])
    size = os.path.getsize(mid)
    with open(mid, "wb") as f:
        f.write(b"\x00" * size)
    records, stats = wal_replay(str(tmp_path), truncate=True)
    assert stats["stopped_early"] and stats["truncated_bytes"] > 0
    lsns = [r.lsn for r in records]
    assert lsns == list(range(1, len(lsns) + 1))


# ------------------------------------------------------------------
# checkpoints
def _ck_write(store, lsn, gen, m=16, d=4, seed=0):
    r = np.random.default_rng(seed)
    rows = r.normal(size=(m, d)).astype(np.float32)
    exts = np.arange(m, dtype=np.int32)
    store.write(rows, exts, lsn=lsn, generation=gen)
    return rows, exts


def test_checkpoint_write_load_round_trip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    rows, exts = _ck_write(store, lsn=5, gen=1)
    ck = store.load()
    assert ck.lsn == 5 and ck.generation == 1
    np.testing.assert_array_equal(ck.rows, rows)
    np.testing.assert_array_equal(ck.exts, exts)


CKPT_FUZZ_CASES = ("bitflip_slab", "missing_slab", "garbage_manifest",
                   "missing_manifest", "stale_pointer", "torn_pointer")


@pytest.mark.parametrize("case", CKPT_FUZZ_CASES)
def test_checkpoint_fuzz_falls_back_to_previous(tmp_path, case):
    store = CheckpointStore(str(tmp_path))
    rows_old, _ = _ck_write(store, lsn=3, gen=1, seed=1)
    _ck_write(store, lsn=9, gen=2, seed=2)
    newest = sorted(glob.glob(str(tmp_path / "ckpt-*")))[-1]
    if case == "bitflip_slab":
        p = os.path.join(newest, "rows.msp")
        data = bytearray(read_bytes(p))
        data[len(data) // 2] ^= 0x10
        with open(p, "wb") as f:
            f.write(bytes(data))
    elif case == "missing_slab":
        os.unlink(os.path.join(newest, "rows.msp"))
    elif case == "garbage_manifest":
        with open(os.path.join(newest, "manifest.json"), "wb") as f:
            f.write(os.urandom(64))
    elif case == "missing_manifest":
        os.unlink(os.path.join(newest, "manifest.json"))
    elif case == "stale_pointer":
        atomic_write_text(str(tmp_path / "CURRENT"), "ckpt-does-not-exist\n")
        os.unlink(os.path.join(newest, "exts.msp"))
    else:                                      # torn_pointer
        with open(tmp_path / "CURRENT", "wb") as f:
            f.write(b"\xff\xfe garbage")
        os.unlink(os.path.join(newest, "rows.msp"))
    ck = store.load()
    assert ck is not None and ck.lsn == 3 and ck.generation == 1
    np.testing.assert_array_equal(ck.rows, rows_old)


def test_checkpoint_all_corrupt_loads_none(tmp_path):
    store = CheckpointStore(str(tmp_path))
    _ck_write(store, lsn=3, gen=1)
    for d in glob.glob(str(tmp_path / "ckpt-*")):
        with open(os.path.join(d, "manifest.json"), "wb") as f:
            f.write(b"not json")
    assert store.load() is None


def test_checkpoint_prune_keeps_fallback_watermark(tmp_path):
    store = CheckpointStore(str(tmp_path))
    for i, lsn in enumerate((2, 5, 9)):
        _ck_write(store, lsn=lsn, gen=i, seed=i)
    assert store.prune(keep=2) == 5
    assert len(store.manifests()) == 2


# ------------------------------------------------------------------
# recover end to end
def test_recover_matches_precrash_index(tmp_path):
    idx = MutableIndex(_base(), durable_dir=str(tmp_path), wal_sync="batch",
                       **PORT)
    apply_upsert(idx, [100, 101], _rows(2))
    apply_delete(idx, [0, 7])
    apply_upsert(idx, [7], _rows(1))
    idx.close()
    assert has_durable_state(str(tmp_path))
    ridx, stats = recover(str(tmp_path), attach=False, **PORT)
    assert stats["replayed_records"] == 3
    assert last_recovery()["replayed_records"] == 3
    assert stats["seconds"] >= stats["replay_seconds"] >= 0
    assert _live_state(ridx) == _live_state(idx)
    q = _rows(3)
    vi, ii = search_view(idx, q, 5)
    vr, ir = search_view(ridx, q, 5)
    assert torch.equal(ii, ir)
    np.testing.assert_allclose(vi.numpy(), vr.numpy(), atol=1e-5)


def test_recover_rebounds_tail_with_fresh_checkpoint(tmp_path):
    idx = MutableIndex(_base(), durable_dir=str(tmp_path), wal_sync="batch",
                       **PORT)
    apply_upsert(idx, [200], _rows(1))
    apply_upsert(idx, [201], _rows(1))
    idx.close()
    r1, st1 = recover(str(tmp_path), wal_sync="batch", **PORT)
    assert st1["replayed_records"] == 2
    apply_delete(r1, [200])
    r1.close()
    r2, st2 = recover(str(tmp_path), attach=False, **PORT)
    assert st2["replayed_records"] == 1
    assert 200 not in r2._lookup and 201 in r2._lookup


def test_recover_after_compaction_checkpoint(tmp_path):
    kw = dict(auto_compact=False, compact_threshold=16, delta_cap=64,
              device="cpu", **GEOM)
    idx = MutableIndex(_base(), durable_dir=str(tmp_path), wal_sync="batch",
                       **kw)
    for i in range(4):
        apply_upsert(idx, [300 + i], _rows(1))
    assert idx.compact(block=True)
    apply_upsert(idx, [400], _rows(1))
    idx.close()
    ridx, stats = recover(str(tmp_path), attach=False, **kw)
    assert stats["replayed_records"] == 1
    assert stats["checkpoint_generation"] >= 1
    assert _live_state(ridx) == _live_state(idx)


def test_recover_empty_dir_returns_none(tmp_path):
    assert not has_durable_state(str(tmp_path))
    assert recover(str(tmp_path), **PORT) is None


def test_recover_torn_wal_tail_truncates_and_serves(tmp_path):
    idx = MutableIndex(_base(), durable_dir=str(tmp_path), wal_sync="batch",
                       **PORT)
    apply_upsert(idx, [500], _rows(1))
    idx.close()
    seg = sorted(glob.glob(str(tmp_path / "wal" / "wal-*.log")))[-1]
    with open(seg, "ab") as f:
        f.write(b"\x01torn-half-frame")
    ridx, stats = recover(str(tmp_path), attach=False, **PORT)
    assert stats["truncated_bytes"] > 0
    assert 500 in ridx._lookup


def test_durable_off_writes_no_file(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    idx = MutableIndex(_base(), **PORT)
    assert idx.durability is None
    apply_upsert(idx, [600], _rows(1))
    apply_delete(idx, [600])
    assert os.listdir(tmp_path) == []


def test_wal_append_fault_leaves_index_unchanged(tmp_path):
    idx = MutableIndex(_base(), durable_dir=str(tmp_path), wal_sync="batch",
                       **PORT)
    before = _live_state(idx)
    seq0 = idx.seq
    faults.configure("wal_append:error")
    try:
        with pytest.raises(faults.InjectedDeviceError):
            apply_upsert(idx, [700], _rows(1))
    finally:
        faults.clear()
    assert _live_state(idx) == before and idx.seq == seq0
    idx.close()
    ridx, _ = recover(str(tmp_path), attach=False, **PORT)
    assert _live_state(ridx) == before


def test_fault_seam_nth_call_and_sites():
    """The seam's ``error@call=N`` fires on exactly the Nth call, passes
    through unarmed, and names the reference's seven durability sites,
    its three serving sites and its three sharded-KNN sites, with the
    reference's kinds; the table is the reference's less the five sites
    of unported modules (the TPU tuners and the sparse plan cache)."""
    from raft_tpu.resilience import KNOWN_SITES as J_SITES

    assert set(faults.KNOWN_SITES) <= set(J_SITES)
    assert {"wal_append", "wal_fsync", "checkpoint_write", "manifest_commit",
            "compact_fold", "mutate_ingest", "tombstone_apply",
            "serving_enqueue", "serving_flush", "serving_snapshot",
            "sharded_dispatch", "merge_allgather", "merge_permute"} <= set(
        faults.KNOWN_SITES)
    assert set(J_SITES) - set(faults.KNOWN_SITES) == {
        "autotune_fused", "autotune_sharded", "autotune_fine_scan",
        "tune_table_read", "plan_cache_read"}
    assert all(faults.KNOWN_SITES[s] == J_SITES[s]
               for s in faults.KNOWN_SITES)
    faults.fault_point("tombstone_apply")              # unarmed
    specs = faults.configure("tombstone_apply:error@call=2")
    faults.fault_point("tombstone_apply")
    with pytest.raises(faults.InjectedDeviceError):
        faults.fault_point("tombstone_apply")
    faults.fault_point("tombstone_apply")
    assert specs[0].fired == 1 and specs[0].calls == 3
    with pytest.raises(ValueError):
        faults.configure("wal_append:melt")


# ------------------------------------------------------------------
# the SIGKILL crash matrix
_WORKER = os.path.join(_TESTS_DIR, "_torch_crash_worker.py")
CRASH_SITES = ("wal_append", "wal_fsync", "checkpoint_write",
               "manifest_commit")
TIER1_CASES = [("wal_append", 3), ("wal_fsync", 4), ("checkpoint_write", 1),
               ("manifest_commit", 2)]
SLOW_CASES = [("wal_append", 1), ("wal_fsync", 1), ("checkpoint_write", 2),
              ("manifest_commit", 1), ("wal_append", 5), ("wal_fsync", 6)]
WKW = dict(device="cpu", auto_compact=False, compact_threshold=10_000,
           **worker.GEOM)


def _read_jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _apply_ops(idx, ops):
    for op in ops:
        if op["kind"] == "upsert":
            apply_upsert(idx, op["ids"],
                         np.stack([worker.row_for(e) for e in op["ids"]]))
        else:
            apply_delete(idx, op["ids"])


def _run_crash_case(tmp_path, site, nth):
    durable, side = tmp_path / "dur", tmp_path / "side"
    durable.mkdir()
    side.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, _WORKER, str(durable), site, str(nth), str(side)],
        env=env, capture_output=True, text=True, timeout=300)
    killed = proc.returncode == -signal.SIGKILL
    assert killed or "COMPLETED" in proc.stdout, (
        f"worker neither completed nor died by SIGKILL "
        f"(rc={proc.returncode}):\n{proc.stderr[-2000:]}")
    acked = _read_jsonl(str(side / "acked.jsonl"))
    submitted = _read_jsonl(str(side / "submitted.jsonl"))
    out = recover(str(durable), attach=False, **WKW)
    if out is None:
        # by the genesis-checkpoint invariant nothing durable means
        # nothing was acked
        assert acked == [], "acked writes lost: no recoverable state"
        return
    ridx, _ = out
    state = _live_state(ridx)
    # the recovered state is the base plus exactly one prefix of the
    # submitted stream (no half-applied op), covering every acked op
    oracle = MutableIndex(worker.base_matrix(), **WKW)
    matched = 0 if state == _live_state(oracle) else None
    for n, op in enumerate(submitted, start=1):
        _apply_ops(oracle, [op])
        if state == _live_state(oracle):
            matched = n
    assert matched is not None, (
        f"recovered state matches no prefix of the submitted stream "
        f"(acked={len(acked)}, submitted={len(submitted)})")
    assert matched >= len(acked), (
        f"acked write lost: recovered prefix {matched} < {len(acked)} "
        f"acked ops (site={site}@{nth})")
    oracle2 = MutableIndex(worker.base_matrix(), **WKW)
    _apply_ops(oracle2, submitted[:matched])
    q = np.random.default_rng(5).normal(size=(3, 8)).astype(np.float32)
    vo, io_ = search_view(oracle2, q, 5)
    vr, ir = search_view(ridx, q, 5)
    assert torch.equal(io_, ir)
    np.testing.assert_allclose(vo.numpy(), vr.numpy(), atol=1e-5)


@pytest.mark.parametrize("site,nth", TIER1_CASES,
                         ids=[f"{s}@{n}" for s, n in TIER1_CASES])
def test_crash_matrix(tmp_path, site, nth):
    """SIGKILL at a durability fault site: recovery loses no acked write
    and half-applies nothing."""
    _run_crash_case(tmp_path, site, nth)


@pytest.mark.slow
@pytest.mark.parametrize("site,nth", SLOW_CASES,
                         ids=[f"{s}@{n}" for s, n in SLOW_CASES])
def test_crash_matrix_extended(tmp_path, site, nth):
    _run_crash_case(tmp_path, site, nth)


def test_crash_sites_are_the_seam_sites():
    for site in CRASH_SITES:
        assert site in faults.KNOWN_SITES
