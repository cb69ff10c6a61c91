"""The port's profiler, benchmark Fixture and drift ledger against the
reference's (``raft_tpu.observability.profiler``, ``raft_tpu.benchmark``,
``raft_tpu.observability.timeline``) on the CPU.

- The drift ledger: the same record sequence gives the same entries,
  ratios and file in both packages (the wall-clock ``ts`` of each entry
  masked), and each package loads the other's file.
- ``Fixture.run`` of the same callable on the same numpy inputs leaves
  the reference's Prometheus text, with the measured times masked: the
  benchmark histogram, the drift ratio (which divides by a time) and the
  peak and temporary bytes (XLA's memory analysis against the port's
  allocator read, 0 on the CPU) differ by nature. The operations and
  bytes of a matmul are counted alike (XLA's cost analysis against
  ``FlopCounterMode`` and the bytes in and out).
- ``Profiler.capture_fn`` takes the entry's kernel cost where one is
  registered (``distance.knn``: K1 at the index's shape), memoises by
  signature and writes the predicted half of the drift ledger; its
  ``trace`` window nests the work under the span's range.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from raft_tpu_torch import observability as obs
from raft_tpu_torch.benchmark import BlobsFixture, Fixture
from raft_tpu_torch.core.resources import DeviceResources
from raft_tpu_torch.observability import costmodel, exporters, metrics
from raft_tpu_torch.observability import profiler, timeline


@pytest.fixture(autouse=True)
def clean_planes():
    obs.reset()
    prev_led = timeline.set_drift_ledger(timeline.DriftLedger())
    prev_prof = profiler.set_profiler(None)
    yield
    obs.reset()
    timeline.set_drift_ledger(prev_led)
    profiler.set_profiler(prev_prof)


def _records(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(40):
        kw = dict(measured=bool(rng.integers(2)))
        if rng.random() < 0.8:
            kw["predicted_seconds"] = float(rng.uniform(1e-6, 1.0))
            kw["predicted_bytes"] = float(rng.integers(1, 1 << 30))
        if rng.random() < 0.7:
            kw["measured_seconds"] = float(rng.choice(
                [0.0, rng.uniform(1e-6, 1.0)]))
            kw["measured_bytes"] = float(rng.integers(1, 1 << 30))
        if rng.random() < 0.3:
            kw["platform"] = "cpu"
        out.append((f"site{int(rng.integers(4))}", kw))
    return out


def _no_ts(entries):
    return {s: [{k: v for k, v in e.items() if k != "ts"} for e in h]
            for s, h in entries.items()}


def test_drift_ledger_entries_ratios_and_files_equal_reference(tmp_path):
    from raft_tpu.observability import timeline as jtimeline

    pp, pj = str(tmp_path / "port.json"), str(tmp_path / "ref.json")
    lp = timeline.DriftLedger(path=pp, max_entries=5)
    lj = jtimeline.DriftLedger(path=pj, max_entries=5)
    for site, kw in _records():
        ep, ej = lp.record(site, **kw), lj.record(site, **kw)
        assert {k: v for k, v in ep.items() if k != "ts"} == \
            {k: v for k, v in ej.items() if k != "ts"}
    assert _no_ts(lp.entries()) == _no_ts(lj.entries())
    assert lp.sites() == lj.sites() and len(lp) == len(lj)
    with open(pp) as f:
        fp = json.load(f)
    with open(pj) as f:
        fj = json.load(f)
    assert (fp["schema"], fp["band"]) == (fj["schema"], fj["band"])
    assert _no_ts(fp["entries"]) == _no_ts(fj["entries"])
    # each package loads the other's file
    assert _no_ts(timeline.DriftLedger.load(pj).entries()) == \
        _no_ts(lj.entries())
    assert _no_ts(jtimeline.DriftLedger.load(pp).entries()) == \
        _no_ts(lp.entries())
    # merge, and a torn file degrades to empty with the counter
    m = timeline.DriftLedger(max_entries=5)
    m.merge(lp)
    assert _no_ts(m.entries()) == _no_ts(lp.entries())
    torn = tmp_path / "torn.json"
    torn.write_text("{not json")
    timeline._reset_degraded_warnings()
    assert len(timeline.DriftLedger.load(str(torn))) == 0
    assert any(x.name == timeline.DRIFT_DEGRADED
               for x in obs.get_registry().collect())


def test_record_drift_respects_the_kill_switch_and_env(tmp_path,
                                                       monkeypatch):
    path = str(tmp_path / "env.json")
    monkeypatch.setenv("RAFT_TPU_DRIFT_LEDGER", path)
    timeline.set_drift_ledger(None)
    assert timeline.get_drift_ledger().path == path
    assert timeline.record_drift("s", predicted_seconds=1.0,
                                 measured_seconds=2.0)["drift_seconds_ratio"] \
        == 2.0
    assert os.path.exists(path)
    obs.disable()
    try:
        assert timeline.record_drift("s", predicted_seconds=1.0) is None
    finally:
        obs.enable()
    kinds = {e["kind"] for e in obs.get_flight_recorder().events()}
    assert "drift" in kinds


_MASKED = ("raft_tpu_benchmark_seconds", "raft_tpu_drift_seconds_ratio",
           "raft_tpu_cost_peak_hbm_bytes", "raft_tpu_cost_temp_bytes")


def _mask(text):
    out = []
    for line in text.splitlines():
        if line.startswith(_MASKED):
            line = re.sub(r" [^ ]+$", " <masked>", line)
        out.append(line)
    return "\n".join(out)


def test_fixture_leaves_the_reference_prometheus_text():
    import jax.numpy as jnp

    from raft_tpu import benchmark as jbench
    from raft_tpu.observability import exporters as jexp
    from raft_tpu.observability import metrics as jmetrics
    from raft_tpu.observability import profiler as jprofiler
    from raft_tpu.observability import quality as jquality
    from raft_tpu.observability import timeline as jtimeline

    # the Fixtures drain the quality plane's pending records into their
    # registries: start both planes empty
    jquality.clear()
    rng = np.random.default_rng(3)
    a = rng.normal(size=(64, 48)).astype(np.float32)
    b = rng.normal(size=(48, 32)).astype(np.float32)
    jprev = jmetrics.set_registry(jmetrics.MetricsRegistry())
    jprof = jprofiler.set_profiler(jprofiler.Profiler())
    jled = jtimeline.set_drift_ledger(jtimeline.DriftLedger())
    try:
        jr = jbench.Fixture(reps=2).run(lambda x, y: x @ y, jnp.asarray(a),
                                        jnp.asarray(b), name="matmul")
        jtext = jexp.export_prometheus(jmetrics.get_registry())
        jled_entries = jtimeline.get_drift_ledger().entries()
    finally:
        jmetrics.set_registry(jprev)
        jprofiler.set_profiler(jprof)
        jtimeline.set_drift_ledger(jled)
    res = DeviceResources(device="cpu")
    r = Fixture(res, reps=2).run(lambda x, y: x @ y, torch.from_numpy(a),
                                 torch.from_numpy(b), name="matmul")
    text = exporters.export_prometheus(metrics.get_registry())
    assert _mask(text) == _mask(jtext)
    for key in ("flops", "bytes_accessed", "arithmetic_intensity", "bound"):
        assert r[key] == jr[key], key
    assert r["timer"] == "perf_counter" and r["seconds"] > 0
    assert 0 < r["roofline_frac"] <= 1.0
    # both halves of the ledger, neither measured off the card
    hist = timeline.get_drift_ledger().entries()["matmul"]
    assert [e["measured"] for e in hist] == \
        [e["measured"] for e in jled_entries["matmul"]] == [False, False]
    assert "predicted_seconds" in hist[0] and "measured_seconds" in hist[1]


def test_fixture_model_keys_throughput_and_blobs():
    res = DeviceResources(device="cpu")
    fx = Fixture(res, reps=1)
    x = torch.ones(128, 128)
    r = fx.run(torch.mm, x, x, name="mm", model={"total_bytes": 7.0,
                                                "model_y": 1})
    assert r["model_total_bytes"] == 7.0 and r["model_y"] == 1
    t = fx.throughput(torch.mm, 1e6, x, x, name="mm2")
    assert t["gb_per_s"] == pytest.approx(1e6 / t["seconds"] / 1e9)
    assert set(exporters.bench_results()) == {"mm", "mm2"}
    bf = BlobsFixture(500, 8, n_clusters=3, res=res)
    assert tuple(bf.X.shape) == (500, 8) and tuple(bf.labels.shape) == (500,)


def test_capture_fn_takes_the_kernel_cost_and_memoises():
    from raft_tpu_torch import distance

    res = DeviceResources(device="cpu")
    res.set_profiler(profiler.Profiler())
    prof = res.profiler
    assert res.profiler is prof and profiler.get_profiler() is not prof
    rng = np.random.default_rng(0)
    Y = torch.from_numpy(rng.normal(size=(4096, 32)).astype(np.float32))
    idx = distance.prepare_knn_index(Y, passes=3, T=512)
    Q = Y[:64].clone()
    fn = lambda r, i, q, k: distance.knn(r, i, q, k=k)  # noqa: E731
    rec = prof.capture_fn("distance.knn/p3", fn, res, idx, Q, 8)
    M = idx.prepared_rows
    want = costmodel.kernel_cost(
        "K1", Q=64, M=M, d=idx.stream_width,
        S=-(-(M // idx.T) // idx.g) * 128, passes=3)
    assert (rec.flops, rec.bytes_accessed, rec.rate) == \
        (want.flops, want.bytes_accessed, want.rate)
    assert rec.entry == "distance.knn/p3" and rec.peak_hbm_bytes == 0
    assert prof.capture_fn("distance.knn/p3", fn, res, idx, Q, 8) is rec
    assert prof.get("distance.knn/p3") is rec
    hist = timeline.get_drift_ledger().entries()["distance.knn/p3"]
    assert len(hist) == 1 and hist[0]["measured"] is False
    assert hist[0]["predicted_seconds"] == costmodel.roofline(
        rec, prof.spec).roof_seconds
    # the flop counter for an entry with no cost function
    a, b = torch.ones(16, 8), torch.ones(8, 4)
    mm = prof.capture_fn("mm", torch.mm, a, b)
    assert mm.flops == 2 * 16 * 8 * 4
    assert mm.bytes_accessed == (16 * 8 + 8 * 4 + 16 * 4) * 4
    assert set(prof.records()) == {"distance.knn/p3", "mm"}
    est = prof.roofline("mm", seconds=1e-3)
    assert est.seconds == 1e-3 and est.utilization is not None
    assert "distance.knn/p3" in prof.report()
    gauges = {(m.name, m.labels.get("entry")) for m in
              obs.get_registry().collect()}
    assert ("raft_tpu_cost_flops", "mm") in gauges


def test_trace_window_nests_work_under_the_span_range(tmp_path):
    from raft_tpu_torch.core import nvtx

    prof = profiler.Profiler()
    log_dir = str(tmp_path / "trace")
    x = torch.ones(64, 64)
    with nvtx.annotate("outer.range"):
        with prof.trace(log_dir=log_dir) as p:
            with nvtx.annotate("distance.knn"):
                torch.mm(x, x)
    assert p is not None
    with open(os.path.join(log_dir, "trace.json")) as f:
        ev = json.load(f)["traceEvents"]
    names = {e.get("name") for e in ev if e.get("cat") == "user_annotation"}
    assert {"outer.range", "distance.knn", "raft_tpu.trace"} <= names
    knn = [e for e in ev if e.get("name") == "distance.knn"][0]
    mm = [e for e in ev if e.get("name") == "aten::mm"]
    assert any(knn["ts"] <= e["ts"] <= knn["ts"] + knn["dur"] for e in mm)
    # outside a window a range is no record_function
    assert nvtx._profiling == 0
