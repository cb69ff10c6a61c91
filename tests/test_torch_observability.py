"""The port's metrics, flight, windows, SLO, fault and policy planes
(raft_tpu_torch.observability, raft_tpu_torch.resilience) against the
reference's (raft_tpu.observability, raft_tpu.resilience) on the CPU.

The same calls, made from a seed with numpy, go to both packages: the
Prometheus text of the two registries is byte-equal, windowed reads and
SLO alert transitions at each tick of an injected clock are equal, the
flight events are the same dicts (timestamps aside), and the fault DSL
parses and fires the same schedule. Process-global state is reset before
and after each test (the autouse fixture), so these tests share nothing
with each other or with the reference's tests in the same worker.
"""

import ast
import os
import threading
import time

import numpy as np
import pytest

from raft_tpu.observability import exporters as jexp
from raft_tpu.observability import metrics as jmetrics
from raft_tpu.observability import slo as jslo
from raft_tpu.observability import windows as jwindows
from raft_tpu.resilience import faults as jfaults
from raft_tpu.resilience import policy as jpolicy
from raft_tpu_torch import observability as obs
from raft_tpu_torch.core import interruptible, nvtx
from raft_tpu_torch.core.error import DeadlineExceededError
from raft_tpu_torch.observability import exporters, metrics, slo, windows
from raft_tpu_torch.observability import timeline
from raft_tpu_torch.resilience import deadline, faults, policy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def clean_planes():
    obs.reset()
    faults.clear()
    yield
    obs.reset()
    faults.clear()
    obs.enable()
    obs.enable_flight()


# ------------------------------------------------------------------
# metrics registry: byte-equal Prometheus text on the same calls
# ------------------------------------------------------------------
NAMES = ("raft_tpu_serving_requests_total", "raft_tpu_span_calls_total",
         "raft_tpu_serving_queue_rows", "raft_tpu_serving_latency_seconds",
         "raft_tpu_certificate_margin", "demo_weird_total")
LABEL_VALUES = ("ok", "shed", 'quo"te', "back\\slash", "new\nline", "")


def _calls(seed: int, n: int = 300):
    """A seeded stream of registry calls: (kind, name, labels, help,
    value, buckets)."""
    rng = np.random.default_rng(seed)
    kinds = {"raft_tpu_serving_requests_total": "counter",
             "raft_tpu_span_calls_total": "counter",
             "demo_weird_total": "counter",
             "raft_tpu_serving_queue_rows": "gauge",
             "raft_tpu_serving_latency_seconds": "histogram",
             "raft_tpu_certificate_margin": "histogram"}
    helps = {n: ("" if n == "demo_weird_total" else
                 f"Help of {n}\nsecond line \\ with a backslash")
             for n in NAMES}
    out = []
    for _ in range(n):
        name = NAMES[rng.integers(len(NAMES))]
        nl = int(rng.integers(0, 3))
        labels = {f"l{j}": LABEL_VALUES[rng.integers(len(LABEL_VALUES))]
                  for j in range(nl)} or None
        kind = kinds[name]
        if kind == "counter":
            value = float(rng.choice([1.0, 2.0, 0.5, 1e6, 3.25]))
        elif kind == "gauge":
            value = float(rng.normal() * 10.0 ** int(rng.integers(-3, 7)))
        else:
            value = float(rng.lognormal(-5, 3) * rng.choice([1, -1]))
        buckets = ((-100.0, -1.0, 0.0, 0.01, 1.0, 100.0)
                   if name == "raft_tpu_certificate_margin"
                   else metrics.DEFAULT_TIME_BUCKETS)
        out.append((kind, name, labels, helps[name], value, buckets))
    return out


def _apply(reg, calls):
    for kind, name, labels, help_, value, buckets in calls:
        if kind == "counter":
            reg.counter(name, labels, help=help_).inc(abs(value))
        elif kind == "gauge":
            g = reg.gauge(name, labels, help=help_)
            g.set(value)
            g.inc(1.5)
            g.dec(0.25)
        else:
            reg.histogram(name, labels, help=help_,
                          buckets=buckets).observe(value)


@pytest.mark.parametrize("seed", range(6))
def test_prometheus_text_byte_equal(seed):
    calls = _calls(seed)
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _apply(reg, calls)
    _apply(jreg, calls)
    text = exporters.export_prometheus(reg)
    assert text.encode() == jexp.export_prometheus(jreg).encode()
    assert "# TYPE raft_tpu_serving_latency_seconds histogram" in text
    assert (exporters.export_jsonl(reg, events=False)
            == jexp.export_jsonl(jreg, events=False))
    assert exporters.summary_table(reg) == jexp.summary_table(jreg)


@pytest.mark.parametrize("seed", range(4))
def test_percentiles_equal_reference(seed):
    rng = np.random.default_rng(100 + seed)
    xs = rng.lognormal(-4, 2, int(rng.integers(1, 400))).tolist()
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert metrics.percentile(xs, q) == jmetrics.percentile(xs, q)
        assert metrics.percentile(xs, q) == pytest.approx(
            float(np.percentile(xs, q)), rel=1e-12, abs=1e-15)
    h, jh = (mod.Histogram("h") for mod in (metrics, jmetrics))
    for x in xs:
        h.observe(x)
        jh.observe(x)
    for q in (1, 50, 99):
        assert h.percentile(q) == jh.percentile(q)


def test_disabled_registry_is_null():
    reg = metrics.MetricsRegistry(enabled=False)
    assert reg.counter("x") is metrics.NULL_METRIC
    reg.counter("x").inc()
    assert len(reg) == 0
    obs.disable()
    assert not obs.tracing_enabled()
    obs.get_registry().counter("raft_tpu_y_total").inc()
    assert len(obs.get_registry()) == 0
    obs.enable()
    with pytest.raises(ValueError):
        r = metrics.MetricsRegistry()
        r.counter("same")
        r.gauge("same")


# ------------------------------------------------------------------
# windows and the SLO engine under an injected clock
# ------------------------------------------------------------------
class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


SCENARIOS = {
    "healthy": dict(bad=0.0, slow=0.0, breach=0.0),
    "shed_storm": dict(bad=0.4, slow=0.0, breach=0.0),
    "latency_storm": dict(bad=0.0, slow=0.6, breach=0.0),
    "recall_breaches": dict(bad=0.0, slow=0.0, breach=0.5),
    "flapping": dict(bad=0.3, slow=0.2, breach=0.2, flap=True),
}


def _slo_run(mods, scenario: dict, seed: int):
    """Drive one package's SloEngine through 120 ticks of 1 s on an
    injected clock with the same seeded event stream; returns the
    transitions by tick, the windowed reads and the final status."""
    metrics_mod, windows_mod, slo_mod = mods
    rng = np.random.default_rng(seed)
    reg = metrics_mod.MetricsRegistry()
    clock = _Clock()
    rungs = (slo_mod.BurnWindow("page", fast_s=5.0, slow_s=20.0,
                                factor=2.0),
             slo_mod.BurnWindow("ticket", fast_s=10.0, slow_s=40.0,
                                factor=1.5))
    eng = slo_mod.SloEngine(
        windows=windows_mod.MetricWindows(registry=reg, interval_s=1.0,
                                          capacity=64, clock=clock),
        objectives=slo_mod.default_objectives(windows=rungs),
        registry=reg)
    out, reads = [], []
    for tick in range(120):
        phase_on = (not scenario.get("flap")) or (tick // 20) % 2 == 1
        on = phase_on and tick >= 30
        for _ in range(int(rng.integers(5, 40))):
            bad = on and rng.random() < scenario["bad"]
            status = (("shed", "deadline", "error")[rng.integers(3)]
                      if bad else "ok")
            reg.counter(slo_mod.REQUESTS, {"status": status}).inc()
            slow = on and rng.random() < scenario["slow"]
            reg.histogram(slo_mod.LATENCY).observe(
                float(rng.uniform(0.3, 2.0) if slow
                      else rng.uniform(1e-4, 0.05)))
            if rng.random() < 0.2:
                reg.counter(slo_mod.SHADOW_SAMPLES).inc()
                if on and rng.random() < scenario["breach"]:
                    reg.counter(slo_mod.SHADOW_BREACHES).inc()
        clock.t += 1.0
        out.append((tick, eng.tick()))
        w = eng.windows
        reads.append((w.delta(slo_mod.REQUESTS, window_s=5.0),
                       w.delta(slo_mod.REQUESTS, {"status": "shed"},
                               window_s=10.0),
                       w.rate(slo_mod.REQUESTS, window_s=7.0),
                       w.percentile(slo_mod.LATENCY, 99, window_s=5.0),
                       w.gauge(slo_mod.REQUESTS, {"status": "ok"}),
                       w.covered_s()))
    return out, reads, eng.status(), exporters_for(metrics_mod).\
        export_prometheus(reg)


def exporters_for(metrics_mod):
    return exporters if metrics_mod is metrics else jexp


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_slo_alerts_equal_reference(name):
    port = _slo_run((metrics, windows, slo), SCENARIOS[name], seed=5)
    ref = _slo_run((jmetrics, jwindows, jslo), SCENARIOS[name], seed=5)
    assert port[0] == ref[0]          # the same transitions at each tick
    assert port[1] == ref[1]          # the same windowed reads
    assert port[2] == ref[2]
    assert port[3] == ref[3]          # incl. raft_tpu_slo_burn_alerts_total
    fired = [t for _, ts in port[0] for t in ts if t["state"] == "firing"]
    assert bool(fired) == (name != "healthy")


def test_slo_names_match_the_engine():
    from raft_tpu_torch.serving import engine as seng

    assert (slo.REQUESTS, slo.LATENCY) == (seng.REQUESTS, seng.LATENCY)
    from raft_tpu_torch.observability import quality

    assert slo.SHADOW_SAMPLES == quality.SHADOW_SAMPLES
    assert slo.SHADOW_BREACHES == quality.SHADOW_BREACHES


# ------------------------------------------------------------------
# flight recorder and timeline emitters
# ------------------------------------------------------------------
def _emit_all(tl):
    tl.emit_fault("serving_flush", "hang")
    tl.emit_retry("runtime.knn_query", 2, "DeviceError: boom")
    tl.emit_degradation("serving.engine", "shed:overload")
    tl.emit_deadline("serving_flush", 0.25, fired=True, stack=["a", "b"])
    tl.emit_marker("phase", n=3)
    tl.emit_quality("runtime.knn_query", n_fail=2, n_queries=8)
    tl.emit_flow("enqueue", 7, ph="s", rows=3)
    tl.emit_flow("response", 7, ph="f", outcome="ok")
    tl.emit_serving("flush", bucket=32, rows=21, generation=0)
    tl.emit_explain("brute", rid=7, outcome="ok", riders=2)
    tl.emit_alert("availability", "page", "firing", burn_fast=20.0)
    tl.emit_stall("serving-batcher", age_s=2.5)
    tl.emit_epilogue("clean", records=10)
    tl.emit_span("serving.execute_batch", "", 0.001, 128, 64, False,
                 stack=["x"])


def test_timeline_events_equal_reference():
    from raft_tpu.observability import flight as jflight
    from raft_tpu.observability import timeline as jtimeline
    from raft_tpu_torch.observability import flight

    rec, jrec = flight.FlightRecorder(64), jflight.FlightRecorder(64)
    prev = flight.set_flight_recorder(rec)
    jprev = jflight.set_flight_recorder(jrec)
    try:
        _emit_all(timeline)
        _emit_all(jtimeline)
    finally:
        flight.set_flight_recorder(prev)
        jflight.set_flight_recorder(jprev)

    def strip(evs):
        return [{k: v for k, v in e.items() if k != "ts"} for e in evs]

    assert strip(rec.events()) == strip(jrec.events())
    assert {e["kind"] for e in rec.events()} <= set(flight.KNOWN_EVENT_KINDS)
    assert flight.KNOWN_EVENT_KINDS == jflight.KNOWN_EVENT_KINDS
    tr, jtr = exporters.export_perfetto(rec), jexp.export_perfetto(jrec)

    def shape(t):
        return [{k: v for k, v in e.items() if k not in ("ts", "pid")}
                for e in t["traceEvents"]]

    assert shape(tr) == shape(jtr)


def test_flight_ring_wraps_and_counts_drops():
    from raft_tpu_torch.observability import flight

    rec = flight.FlightRecorder(capacity=16)
    prev = flight.set_flight_recorder(rec)
    try:
        for i in range(40):
            timeline.emit_marker("m", i=i)
        assert len(rec) == 16 and rec.dropped == 24 and rec.seq == 40
        assert [e["i"] for e in rec.tail(3)] == [37, 38, 39]
        assert flight.sync_dropped_metric(rec) == 24
        assert obs.get_registry().counter(
            flight.FLIGHT_DROPPED).value == 24
        flight.disable_flight()
        timeline.emit_marker("off")
        assert rec.seq == 40
    finally:
        flight.enable_flight()
        flight.set_flight_recorder(prev)


def test_post_mortem_writes_perfetto(tmp_path):
    from raft_tpu_torch.observability import flight

    timeline.emit_marker("before")
    path = flight.post_mortem("unit", error=RuntimeError("x"),
                              directory=str(tmp_path))
    import json

    with open(path) as f:
        trace = json.load(f)
    assert trace["raft_tpu"]["trigger"] == "unit"
    assert any(e["name"] == "before" for e in trace["traceEvents"])


# ------------------------------------------------------------------
# ranges and spans
# ------------------------------------------------------------------
def test_spans_attribute_to_the_enclosing_range():
    @obs.instrument("unit.inner")
    def inner(a, b=None):
        return a * 2

    with nvtx.annotate("outer"):
        assert nvtx.current_range() == "outer"
        with obs.span("unit.mid"):
            assert nvtx.range_stack() == ["outer", "unit.mid"]
            out = inner(np.ones(4, np.float32), b={"t": np.ones(2)})
    assert nvtx.range_stack() == []
    assert out.nbytes == 16
    reg = obs.get_registry()
    assert reg.counter("raft_tpu_span_calls_total",
                       {"span": "unit.inner", "range": "unit.mid"}).value == 1
    assert reg.counter("raft_tpu_span_bytes_in_total",
                       {"span": "unit.inner",
                        "range": "unit.mid"}).value == 16 + 16
    assert reg.histogram("raft_tpu_span_seconds",
                         {"span": "unit.mid", "range": "outer"}).count == 1
    import torch

    assert obs.tree_nbytes((torch.zeros(3, 5), [torch.zeros(2, dtype=
                                                             torch.int8)],
                            {"a": np.zeros(4)}, "s", 3)) == 60 + 2 + 32
    with pytest.raises(ZeroDivisionError):
        obs.instrument("unit.err")(lambda: 1 / 0)()
    assert reg.counter("raft_tpu_span_errors_total",
                       {"span": "unit.err", "range": ""}).value == 1


# ------------------------------------------------------------------
# fault injection and the retry / degradation records
# ------------------------------------------------------------------
SPECS = ["serving_flush:hang@call=3", "serving_enqueue:error",
         "wal_append:oom:p=0.25", "a:timeout; b:corrupt@call=2 ;c:nan",
         "x:error:call=4", "x:melt", "x", "x:error@cal=2", "x:error:p=2",
         "x:error:q=1", "x:error@call=0"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_dsl_parses_as_reference(spec):
    try:
        want = [(s.site, s.kind, s.nth_call, s.probability)
                for s in jfaults.parse_faults(spec)]
    except ValueError:
        with pytest.raises(ValueError):
            faults.parse_faults(spec)
        return
    got = [(s.site, s.kind, s.nth_call, s.probability)
           for s in faults.parse_faults(spec)]
    assert got == want


def _schedule(mod, spec, seed, n=200):
    mod.configure(spec, seed=seed)
    fired = []
    try:
        for i in range(n):
            try:
                if mod.fault_point("wal_append") is not None:
                    fired.append(i)
            except Exception:
                fired.append(i)
    finally:
        mod.clear()
    return fired


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_probability_schedule_equals_reference(seed):
    spec = "wal_append:corrupt:p=0.1"
    got = _schedule(faults, spec, seed)
    assert got == _schedule(jfaults, spec, seed)
    assert 5 <= len(got) <= 40


def test_fault_kinds_raise_and_count():
    specs = faults.configure("s1:oom;s2:timeout;s3:nan;s4:error@call=2")
    with pytest.raises(faults.InjectedOutOfMemory):
        faults.fault_point("s1")
    with pytest.raises(faults.InjectedTimeout):
        faults.fault_point("s2")
    assert faults.fault_point("s3") == "nan"
    assert faults.fault_point("s4") is None
    with pytest.raises(faults.InjectedDeviceError):
        faults.fault_point("s4")
    assert [s.fired for s in specs] == [1, 1, 1, 1]
    reg = obs.get_registry()
    assert reg.counter(faults.INJECTIONS,
                       {"site": "s2", "kind": "timeout"}).value == 1
    kinds = [e["fault_kind"] for e in obs.get_flight_recorder().events()
             if e["kind"] == "fault"]
    assert kinds == ["oom", "timeout", "nan", "error"]


def test_hang_fault_converts_under_a_deadline():
    faults.configure("serving_flush:hang@call=1")
    t0 = time.perf_counter()
    with pytest.raises(DeadlineExceededError) as ei:
        with nvtx.annotate("serving.execute_batch"):
            with deadline(0.2, label="serving_flush"):
                faults.fault_point("serving_flush")
    assert 0.15 < time.perf_counter() - t0 < 5.0
    assert ei.value.span_stack == ["serving.execute_batch"]
    assert ei.value.flight_tail and ei.value.seconds == 0.2
    assert obs.get_registry().counter(
        "raft_tpu_deadline_exceeded_total",
        {"scope": "serving_flush"}).value == 1
    fired = [e for e in obs.get_flight_recorder().events()
             if e["kind"] == "deadline"]
    assert [e["fired"] for e in fired] == [False, True]


def test_hang_fault_safety_cap(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_FAULT_HANG_MAX_S", "0.05")
    faults.configure("x:hang")
    with pytest.raises(faults.InjectedTimeout):
        faults.fault_point("x")


def test_cancel_reaches_another_thread():
    box = {}

    def worker():
        box["ident"] = threading.get_ident()
        try:
            while True:
                interruptible.yield_()
                time.sleep(0.001)
        except interruptible.InterruptedException:
            box["ok"] = True

    t = threading.Thread(target=worker)
    t.start()
    while "ident" not in box:
        time.sleep(0.001)
    interruptible.cancel(box["ident"])
    t.join(5)
    assert box.get("ok")


def test_retry_policy_and_records_match_reference():
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise faults.InjectedDeviceError("transient")
        return "done"

    assert policy.run_with_policy("runtime.unit", flaky) == "done"
    assert calls == [0, 1, 2]
    reg = obs.get_registry()
    assert reg.counter(policy.RETRIES, {"site": "runtime.unit"}).value == 2
    with pytest.raises(faults.InjectedDeviceError):
        policy.run_with_policy(
            "x", lambda a: (_ for _ in ()).throw(
                faults.InjectedDeviceError("always")),
            policy=policy.RetryPolicy(max_retries=1))
    assert reg.counter(policy.EXHAUSTED, {"site": "x"}).value == 1
    with pytest.raises(DeadlineExceededError):
        policy.run_with_policy("x", lambda a: (_ for _ in ()).throw(
            DeadlineExceededError("budget")))
    with pytest.raises(Exception) as ei:
        policy.run_with_policy(
            "y", lambda a: (_ for _ in ()).throw(
                RuntimeError("CUDA out of memory. Tried")),
            policy=policy.RetryPolicy(max_retries=0))
    assert type(ei.value).__name__ == "OutOfMemoryError"
    # degradation records: the same counters and reasons as the reference
    jreg = jmetrics.MetricsRegistry()
    jprev = jmetrics.set_registry(jreg)
    try:
        for site, action in (("serving.engine", "shed:overload"),
                             ("fine_scan_list", "query"),
                             ("serving.engine", "shed:overload")):
            policy.record_degradation(site, action)
            jpolicy.record_degradation(site, action)
    finally:
        jmetrics.set_registry(jprev)
    assert policy.degradation_count() == jpolicy.degradation_count(jreg) == 3
    assert (policy.degradation_reasons()
            == jpolicy.degradation_reasons(jreg)
            == ["fine_scan_list:query x1", "serving.engine:shed:overload x2"])


def test_policy_table_env_cap(monkeypatch):
    t = policy.PolicyTable({"serving": policy.RetryPolicy(max_retries=5)})
    assert t.policy_for("serving.engine").max_retries == 5
    assert t.policy_for("other").max_retries == 2
    monkeypatch.setenv("RAFT_TPU_RETRY_MAX", "0")
    assert t.policy_for("serving.engine").max_retries == 0


# ------------------------------------------------------------------
# quality plane: deferred records and the certificate counters
# ------------------------------------------------------------------
def test_record_pending_drains_into_the_registry():
    from raft_tpu_torch.observability import quality

    quality.record_pending("runtime.knn_query", 3, n_queries=32,
                           pool_width=96, db_dtype="bf16")
    quality.record_pending("runtime.knn_query", 0, n_queries=32,
                           pool_width=96)
    assert quality.pending_count() == 2
    block = quality.quality_block()
    assert quality.pending_count() == 0
    site = block["sites"]["runtime.knn_query"]
    assert (site["checks"], site["fixups"]) == (64, 3)
    assert block["fixup_rate"] == pytest.approx(3 / 64)
    assert block["rescore_pool_widths"]["runtime.knn_query"]["count"] == 2
    assert quality.certificate_counts("runtime.knn_query")["fails"] == 3
    h = obs.get_registry().histogram(quality.FIXUP_ROWS,
                                     {"site": "runtime.knn_query"},
                                     buckets=quality.COUNT_BUCKETS)
    assert (h.count, h.sum) == (1, 3.0)
    ev = [e for e in obs.get_flight_recorder().events()
          if e["kind"] == "quality"]
    assert ev and ev[0]["n_fail"] == 3


def test_quality_plane_off_keeps_the_plain_counters(monkeypatch):
    from raft_tpu_torch.observability import quality

    monkeypatch.setenv("RAFT_TPU_DISABLE_QUALITY", "1")
    quality.record_certificate("s", n_queries=10, n_fail=2, rerun=True)
    quality.record_pq_rungs("s", certified=8, widened=1, exact_rerun=1)
    assert quality.certificate_counts("s") == {
        "checks": 10, "fails": 2, "reruns": 1, "certified": 8,
        "widened": 1, "exact_rerun": 1}
    assert len(obs.get_registry()) == 0


@pytest.mark.parametrize("seed", range(3))
def test_recall_and_sample_hash_equal_reference(seed):
    from raft_tpu.observability import quality as jq
    from raft_tpu_torch.observability import quality

    rng = np.random.default_rng(seed)
    served = rng.integers(-1, 50, (6, 8))
    true = rng.integers(0, 50, (6, 8))
    assert quality.recall_at_k(served, true) == jq.recall_at_k(served, true)
    rids = rng.integers(0, 1 << 40, 500)
    assert [quality._sample_hash(r) for r in rids] == [
        jq._sample_hash(r) for r in rids]
    from raft_tpu.observability import explain as jexplain
    from raft_tpu_torch.observability import explain

    for frac in (0.0, 0.02, 0.5, 1.0):
        assert ([explain.want(int(r), frac) for r in rids]
                == [jexplain.want(int(r), frac) for r in rids])


# ------------------------------------------------------------------
# import hygiene: no JAX, no reference package, no root tools package
# ------------------------------------------------------------------
def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.append(node.module)
    return names


def test_port_and_smoke_import_no_reference_or_root_tools():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, fs in os.walk(os.path.join(REPO, "raft_tpu_torch")):
        files += [os.path.join(root, f) for f in fs if f.endswith(".py")]
    bad = [(p, n) for p in files for n in _imports(p)
           if n.split(".")[0] in ("jax", "jaxlib", "raft_tpu", "tools")]
    assert bad == []
    import subprocess
    import sys

    code = ("import sys, raft_tpu_torch.observability, "
            "raft_tpu_torch.tools, raft_tpu_torch.tools.debugz, "
            "raft_tpu_torch.tools.statusz, raft_tpu_torch.resilience.policy,"
            " raft_tpu_torch.core.nvtx, raft_tpu_torch.core.interruptible, "
            "raft_tpu_torch.serving.engine; print(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'raft_tpu', 'tools')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_shadow_sampler_scores_queued_samples_in_one_oracle_call():
    """Queued samples share one oracle call (their rows concatenated),
    each still scored against its own rows' answer, in queue order."""
    from raft_tpu_torch.observability import quality

    calls = []
    truth = np.arange(40 * 3).reshape(40, 3)

    def oracle(x):
        calls.append(x.shape[0])
        return None, truth[x[:, 0].astype(int)]

    s = quality.ShadowSampler(oracle, k=3, frac=1.0, floor=0.5)
    rows = [np.arange(i * 4, i * 4 + 4, dtype=np.float32)[:, None]
            for i in range(10)]
    for rid, x in enumerate(rows):
        served = truth[x[:, 0].astype(int)].copy()
        if rid % 3 == 0:
            served[:, 0] = -1                 # one of three ids missed
        assert s.submit(rid, x, served)
    s.start()
    try:
        assert s.flush(30)
    finally:
        s.stop()
    assert sum(calls) == 40 and len(calls) < 10
    assert list(s._window) == [2 / 3 if r % 3 == 0 else 1.0
                               for r in range(10)]
    snap = s.snapshot()
    assert snap["shadow_samples"] == 10 and snap["shadow_errors"] == 0
