"""The mutable plane's telemetry against the reference's on the CPU.

The same upsert / delete / search / fold / write / recover script runs
on the reference's ``raft_tpu.mutable`` and the port's
``raft_tpu_torch.mutable``, each with a durable directory of its own and
a fresh registry and flight ring. Then:

- the Prometheus text of the mutable, WAL, checkpoint and recovery
  families (``raft_tpu_mutable_*``, ``raft_tpu_wal_*``,
  ``raft_tpu_checkpoint*``, ``raft_tpu_recovery_*``) is byte-equal, with
  the recovery's wall seconds masked;
- the ``mutation`` flight events (upsert, delete, compact_start,
  compact_swap, checkpoint, recovery) are the same, name and arguments,
  with their timestamps and the recovery's seconds masked;
- both queue their certificate stats at the ``mutable.search_base`` and
  ``mutable.search_delta`` sites;
- statusz's durability panel has the reference's lines, and a failed
  fold counts and emits ``compact_abort`` as the reference's does.
"""

import re

import numpy as np
import pytest
import torch

import raft_tpu.mutable as jm
from raft_tpu import observability as jobs
from raft_tpu.observability import exporters as jexp
from raft_tpu.observability import quality as jquality
from raft_tpu_torch import mutable as pm
from raft_tpu_torch import observability as obs
from raft_tpu_torch.observability import exporters, quality
from raft_tpu_torch.resilience import faults

GEOM = dict(T=256, g=2, passes=3, auto_compact=False,
            compact_threshold=10_000)
FAMILIES = ("raft_tpu_mutable_", "raft_tpu_wal_", "raft_tpu_checkpoint",
            "raft_tpu_recovery_")


@pytest.fixture(autouse=True)
def clean_planes():
    obs.reset()
    jobs.reset()
    faults.clear()
    yield
    obs.reset()
    jobs.reset()
    faults.clear()


def _families(text):
    out, keep = [], False
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else \
            re.split(r"[{ ]", line)[0]
        keep = name.startswith(FAMILIES)
        if keep:
            if name == "raft_tpu_recovery_seconds" and \
                    not line.startswith("#"):
                line = re.sub(r" [^ ]+$", " <s>", line)
            out.append(line)
    return "\n".join(out)


def _mutations(events):
    out = []
    for ev in events:
        if ev["kind"] != "mutation":
            continue
        ev = {k: v for k, v in ev.items() if k not in ("ts", "seconds")}
        out.append(ev)
    return out


def _script(mod, index_kw, d, Y, base):
    rng = np.random.default_rng(4)
    idx = mod.MutableIndex(Y, durable_dir=base, wal_sync="batch",
                           **index_kw)
    q = rng.normal(size=(8, Y.shape[1])).astype(np.float32)
    m = Y.shape[0]
    nxt = m
    for b in range(3):
        ids = np.concatenate([np.arange(b * 5, b * 5 + 5),
                              np.arange(nxt, nxt + 20)]).astype(np.int32)
        nxt += 20
        mod.apply_upsert(idx, ids, rng.normal(
            size=(ids.size, Y.shape[1])).astype(np.float32))
        mod.apply_delete(idx, np.array([100 + b, 101 + b, 10 ** 7],
                                       np.int32))
        mod.search_view(idx, q, 5)
    idx.compact(block=True)
    mod.apply_upsert(idx, np.array([nxt], np.int32),
                     rng.normal(size=(1, Y.shape[1])).astype(np.float32))
    mod.apply_delete(idx, np.array([3], np.int32))
    idx.close()
    return mod.recover(base, attach=False, **index_kw)


def test_metrics_and_events_equal_reference(tmp_path):
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(1500, 16)).astype(np.float32)
    _script(jm, dict(GEOM, Qb=32), 16, Y, str(tmp_path / "ref"))
    _, stats = _script(pm, dict(GEOM, device="cpu"), 16, Y,
                       str(tmp_path / "port"))
    jtext = jexp.export_prometheus(jobs.get_registry())
    text = exporters.export_prometheus(obs.get_registry())
    assert _families(text) == _families(jtext)
    assert "raft_tpu_recovery_total" in text
    assert "raft_tpu_mutable_compactions_total" in text
    jev = _mutations(jobs.get_flight_recorder().events())
    pev = _mutations(obs.get_flight_recorder().events())
    assert [e["name"] for e in pev] == [e["name"] for e in jev]
    assert {"upsert", "delete", "compact_start", "compact_swap",
            "checkpoint", "recovery"} <= {e["name"] for e in pev}
    assert pev == jev
    assert stats["replayed_records"] >= 1


def test_searches_queue_their_certificate_sites():
    rng = np.random.default_rng(1)
    Y = rng.normal(size=(1500, 16)).astype(np.float32)
    sites = {}
    for mod, q_mod, key, kw in ((jm, jquality, "ref", dict(GEOM, Qb=32)),
                                (pm, quality, "port",
                                 dict(GEOM, device="cpu"))):
        q_mod.clear()
        idx = mod.MutableIndex(Y, **kw)
        mod.apply_upsert(idx, np.array([5000, 5001], np.int32),
                         rng.normal(size=(2, 16)).astype(np.float32))
        mod.search_view(idx, Y[:4], 5)
        with q_mod._pending_lock:
            sites[key] = [p[0] for p in q_mod._pending]
        q_mod.clear()
    assert sites["port"] == sites["ref"] == ["mutable.search_base",
                                             "mutable.search_delta"]


def test_failed_fold_counts_and_emits_abort():
    rng = np.random.default_rng(2)
    Y = rng.normal(size=(1200, 16)).astype(np.float32)
    idx = pm.MutableIndex(Y, **dict(GEOM, device="cpu"))
    pm.apply_upsert(idx, np.array([9000], np.int32),
                    rng.normal(size=(1, 16)).astype(np.float32))
    faults.configure("compact_fold:error@call=1")
    with pytest.raises(faults.InjectedDeviceError):
        idx.compact(block=True)
    faults.clear()
    reg = obs.get_registry()
    failed = [m.value for m in reg.collect()
              if m.name == "raft_tpu_mutable_compactions_total"
              and m.labels == {"status": "failed"}]
    assert failed == [1.0]
    names = [e["name"] for e in obs.get_flight_recorder().events()
             if e["kind"] == "mutation"]
    assert names[-1] == "compact_abort"


def test_statusz_durability_panel_has_the_reference_fields(tmp_path):
    from raft_tpu_torch.mutable import checkpoint
    from raft_tpu_torch.serving import ServingEngine
    from raft_tpu_torch.tools.statusz import render_statusz

    rng = np.random.default_rng(3)
    Y = rng.normal(size=(1200, 16)).astype(np.float32)
    none = render_statusz()
    assert "durability (WAL / checkpoints / recovery)" in none
    assert "(no durability plane attached — durable=False)" in none
    eng = ServingEngine(Y, k=4, mutable=True, durable=True,
                        durable_dir=str(tmp_path / "d"), device="cpu",
                        **{k: v for k, v in GEOM.items()
                           if k in ("compact_threshold",)})
    try:
        eng.start()
        eng.upsert(np.array([7000], np.int32),
                   rng.normal(size=(1, 16)).astype(np.float32)).result(30)
        eng.flush(30)
        page = render_statusz(engine=eng)
    finally:
        eng.stop()
        eng.mutable.close()
    lines = [ln for ln in page.splitlines() if ln.startswith(
        ("wal sync=", "checkpoints ", "last recovery"))]
    assert re.fullmatch(r"wal sync=batch  last_lsn=\d+  durable_lsn=\d+  "
                        r"segments=\d+", lines[0])
    assert re.fullmatch(r"checkpoints \d+ \(newest lsn=\d+, gen=\d+\)",
                        lines[1])
    pm.recover(str(tmp_path / "d"), attach=False, device="cpu")
    assert checkpoint.last_recovery() is not None
    page = render_statusz()
    assert re.search(r"last recovery   [0-9.]+ ms: \d+ record\(s\) "
                     r"replayed over checkpoint lsn=\d+, \d+ torn byte\(s\) "
                     r"truncated", page)
