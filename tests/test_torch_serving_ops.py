"""The port's serving engine with its operations planes on the CPU, side by
side with the reference's engine (raft_tpu.serving).

Both engines take the same requests, made from a seed with numpy, one
batch a request (so request ids and batches line up), with
``explain_frac=1.0`` and a shadow fraction: the explain records agree in
every field but the timings (``ts``, ``wall_s``, ``stages``) and the
reference's TPU grid choices (``grid_order``, ``pool_algo``), the
certificate margins by count and sign exactly and by value within
tolerance, and the shadow samples the same request ids with the same
recall. This runs for the brute bf16, brute int8 and IVF-Flat planes. The
debugz routes of both answer with the same JSON keys. Every engine is
stopped in a ``finally`` and every wait has a timeout.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from raft_tpu import observability as jobs
from raft_tpu.observability import explain as jexplain
from raft_tpu_torch import observability as obs
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.distance.knn_fused import prepare_knn_index
from raft_tpu_torch.observability import explain
from raft_tpu_torch.resilience import faults
from raft_tpu_torch.serving import ServingEngine

from _torch_threads import one_torch_thread  # noqa: F401

M, D, K, ROWS = 2048, 16, 5, 4
CFG = dict(passes=3, T=256, Qb=32, g=2)
WAIT = 60
#: explain fields that differ by design: timings, and the reference's
#: TPU grid order and pool-select algorithm (the port has neither)
NOT_COMPARED = {"ts", "wall_s", "stages", "grid_order", "pool_algo"}


@pytest.fixture(autouse=True)
def clean_planes():
    obs.reset()
    faults.clear()
    jobs.reset()
    jexplain.clear_records()
    yield
    obs.reset()
    faults.clear()
    jobs.reset()
    jexplain.clear_records()


def _data(seed=11):
    rng = np.random.default_rng(seed)
    y = rng.normal(size=(M, D)).astype(np.float32)
    xs = [rng.normal(size=(ROWS, D)).astype(np.float32) for _ in range(12)]
    return y, xs


def _record_shadow(eng):
    """Wrap the engine's shadow sampler so the sampled request ids are
    kept in order."""
    seen, submit = [], eng.shadow.submit

    def wrapped(rid, x, ids):
        seen.append(int(rid))
        return submit(rid, x, ids)

    eng.shadow.submit = wrapped
    return seen


def _serve(eng, xs):
    """One batch a request; returns the answers."""
    out = []
    for x in xs:
        fut = eng.submit(x)
        assert eng.flush(WAIT)
        v, i = fut.result(timeout=WAIT)
        out.append((np.asarray(v), np.asarray(i)))
    assert eng.shadow.flush(WAIT)
    return out


def _compare_records(port_recs, ref_recs, margin_rtol=1e-4):
    assert len(port_recs) == len(ref_recs) > 0
    for p, r in zip(port_recs, ref_recs):
        want = {k: v for k, v in r.items() if k not in NOT_COMPARED}
        got = {k: p.get(k) for k in want}
        pm, rm = got.pop("margins", None), want.pop("margins", None)
        assert got == want
        assert (pm is None) == (rm is None)
        if rm is None:
            continue
        assert set(pm) == set(rm)
        for site in rm:
            assert pm[site]["n"] == rm[site]["n"]
            assert pm[site]["n_negative"] == rm[site]["n_negative"]
            assert pm[site]["min"] == pytest.approx(
                rm[site]["min"], rel=margin_rtol, abs=margin_rtol)


def _side_by_side(port_index, ref_index, xs, **kw):
    from raft_tpu.serving import ServingEngine as JaxEngine

    common = dict(k=K, buckets=(8,), flush_interval_s=0.005,
                  explain_frac=1.0, shadow_frac=0.5, **kw)
    jeng = JaxEngine(ref_index, **common).start()
    try:
        jseen = _record_shadow(jeng)
        jout = _serve(jeng, xs)
        jshadow = (list(jeng.shadow._window), jeng.shadow.snapshot())
    finally:
        jeng.stop()
    eng = ServingEngine(port_index, res=DeviceResources(device="cpu"),
                        **common).start()
    try:
        seen = _record_shadow(eng)
        out = _serve(eng, xs)
        shadow = (list(eng.shadow._window), eng.shadow.snapshot())
        st = eng.stats()
    finally:
        eng.stop()
    assert seen == jseen and 0 < len(seen) < len(xs)
    assert shadow[0] == jshadow[0]                  # recall per sample
    for key in ("shadow_samples", "shadow_breaches", "shadow_recall"):
        assert shadow[1][key] == jshadow[1][key]
    assert st["shadow_errors"] == 0 and st["builds_after_warmup"] == 0
    _compare_records(obs.explain_records(), jexplain.explain_records())
    return out, jout


@pytest.mark.parametrize("db_dtype", ["bf16", "int8"])
def test_brute_planes_explain_and_shadow_equal_reference(db_dtype):
    from raft_tpu.distance.knn_fused import prepare_knn_index as jprepare

    y, xs = _data()
    kw = dict(CFG, db_dtype=db_dtype)
    out, jout = _side_by_side(prepare_knn_index(y, device="cpu", **kw),
                              jprepare(y, **kw), xs)
    for (v, i), (jv, ji) in zip(out, jout):
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    rec = obs.explain_records()[0]
    assert rec["plane"] == "brute" and rec["db_dtype"] == db_dtype
    assert rec["margins"]["runtime.knn_query"]["n"] == 8     # the bucket


def test_ivf_flat_plane_explain_and_shadow_equal_reference(monkeypatch):
    monkeypatch.setenv("RAFT_TPU_IVF_FINE_SCAN", "query")
    from raft_tpu.ann import build_ivf_flat as jbuild
    from raft_tpu.core import DeviceResources as JaxResources
    from raft_tpu_torch.ann import IvfFlatIndex
    from test_torch_ivf_flat import _export

    y, xs = _data(5)
    jidx = jbuild(JaxResources(seed=7), y, n_lists=16, max_iter=6, seed=3)
    tidx = IvfFlatIndex.from_numpy(_export(jidx), device="cpu")
    out, jout = _side_by_side(tidx, jidx, xs, algorithm="ivf_flat",
                              n_probes=4)
    for (v, i), (jv, ji) in zip(out, jout):
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
    rec = obs.explain_records()[0]
    assert rec["plane"] == "ivf_flat" and rec["n_probes"] == 4
    assert len(rec["probed_lists"]) == 4


# ------------------------------------------------------------------
# the seven options, each doing what the reference's does
# ------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    y, xs = _data(3)
    return y, xs, prepare_knn_index(y, device="cpu", **CFG)


def _get(port, route):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{route}",
                                    timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_every_debugz_route_answers_with_the_reference_keys(small, tmp_path):
    from raft_tpu.distance.knn_fused import prepare_knn_index as jprepare
    from raft_tpu.serving import ServingEngine as JaxEngine

    y, xs, idx = small
    bodies = {}
    for name, make in (
            ("port", lambda: ServingEngine(
                idx, k=K, buckets=(8,), flush_interval_s=0.005,
                explain_frac=1.0, debug_port=0,
                blackbox_path=str(tmp_path / "p.bin"))),
            ("ref", lambda: JaxEngine(
                jprepare(y, **CFG), k=K, buckets=(8,),
                flush_interval_s=0.005, explain_frac=1.0, debug_port=0,
                blackbox_path=str(tmp_path / "r.bin")))):
        eng = make().start()
        try:
            for x in xs[:3]:
                eng.query(x, timeout=WAIT)
            # the batcher counts a request after answering it
            assert eng.flush(WAIT)
            port = eng.stats()["debugz_port"]
            bodies[name] = {r: _get(port, r) for r in (
                "/healthz", "/statusz", "/metricsz", "/explainz",
                "/explainz?outcome=error", "/explainz?limit=1", "/flightz",
                "/stackz", "/crashz", "/nope")}
        finally:
            eng.stop()
    p, r = bodies["port"], bodies["ref"]
    assert {k: v[0] for k, v in p.items()} == {k: v[0] for k, v in r.items()}
    assert p["/nope"][0] == 404 and p["/healthz"] == (200, "ok\n")
    for route in ("/explainz", "/explainz?limit=1", "/flightz", "/crashz"):
        pj, rj = json.loads(p[route][1]), json.loads(r[route][1])
        assert set(pj) == set(rj)
    pe = json.loads(p["/explainz"][1])["records"]
    re_ = json.loads(r["/explainz"][1])["records"]
    assert len(pe) == len(re_) == 3
    assert set(re_[0]) - NOT_COMPARED <= set(pe[0])
    assert json.loads(p["/explainz?outcome=error"][1]) == {"records": []}
    assert len(json.loads(p["/explainz?limit=1"][1])["records"]) == 1
    series = 'raft_tpu_serving_requests_total{status="ok"} 3'
    assert series in p["/metricsz"][1] and series in r["/metricsz"][1]
    assert json.loads(p["/crashz"][1])["verdict"] == "none"
    assert "== serving-batcher" in p["/stackz"][1]
    assert "SLO burn state" in p["/statusz"][1]
    for section in ("quality", "latency percentiles", "serving engine",
                    "explain ring", "forensics", "flight tail"):
        assert section in p["/statusz"][1] and section in r["/statusz"][1]


def test_options_each_do_their_part(small, tmp_path):
    from raft_tpu_torch.observability import blackbox
    from raft_tpu_torch.observability.slo import SloEngine

    y, xs, idx = small
    slo = SloEngine()
    path = str(tmp_path / "bb.bin")
    eng = ServingEngine(idx, k=K, buckets=(8,), flush_interval_s=0.005,
                        shadow_frac=1.0, shadow_floor=1.5,
                        explain_frac=0.5, debug_port=0, blackbox_path=path,
                        watchdog_s=0.05, slo=slo).start()
    try:
        assert eng.slo is slo and eng.debugz is not None
        for x in xs:
            eng.query(x, timeout=WAIT)
        assert eng.flush(WAIT)
        assert eng.shadow.flush(WAIT)
        st = eng.stats()
    finally:
        eng.stop()
    assert st["shadow_samples"] == len(xs) and st["shadow_recall"] == 1.0
    # the floor above 1.0 breaches on every sample past the minimum
    assert st["shadow_breaches"] == len(xs) - 3
    flagged = [i + 1 for i in range(len(xs)) if explain.want(i + 1, 0.5)]
    assert 0 < len(flagged) < len(xs)
    assert sorted(r["rids"][0] for r in obs.explain_records()) == flagged
    assert st["explain"] == {"frac": 0.5, "records": len(flagged)}
    assert st["watchdog"]["ticks"] > 0 and st["watchdog"]["stalls"] == 0
    assert st["blackbox"]["records"] > 0
    assert "slo" in st and st["slo"]["healthy"]
    rec = blackbox.reconstruct(path)
    assert rec["verdict"] == "clean" and rec["final_snapshot"] is not None
    assert any(e.get("kind") == "flow" for e in rec["events"])
    drift = [e for e in obs.get_flight_recorder().events()
             if e["kind"] == "drift"]
    assert drift and drift[0]["name"] == "serving.shadow"
    _mesh_plane_matches(y, xs, idx)


def _mesh_plane_matches(y, xs, idx):
    """The query-sharded mesh plane: a two-rank engine answers as
    ``knn_query`` does on one device, bit for bit, and with the ids of
    the reference's mesh engine (values there within 1e-5 relative: the
    packages' f32 rescores sum in different orders)."""
    import jax
    import torch

    from raft_tpu.distance.knn_fused import prepare_knn_index as jprepare
    from raft_tpu.parallel import make_mesh as jmake_mesh
    from raft_tpu.serving import ServingEngine as JaxEngine
    from raft_tpu_torch.parallel import make_mesh
    from raft_tpu_torch.runtime import knn_query

    outs = {}
    for name, make in (
            ("port", lambda: ServingEngine(
                idx, k=K, buckets=(8,), flush_interval_s=0.005,
                mesh=make_mesh({"x": 2}, devices=["cpu"] * 2))),
            ("ref", lambda: JaxEngine(
                jprepare(y, **CFG), k=K, buckets=(8,),
                flush_interval_s=0.005,
                mesh=jmake_mesh({"x": 2}, devices=jax.devices()[:2])))):
        eng = make().start()
        try:
            outs[name] = [eng.query(x, timeout=WAIT) for x in xs[:3]]
        finally:
            eng.stop()
    res = DeviceResources(device="cpu")
    for x, (v, i), (jv, ji) in zip(xs[:3], outs["port"], outs["ref"]):
        wv, wi = knn_query(res, idx, torch.from_numpy(x), K)
        np.testing.assert_array_equal(np.asarray(i), wi.numpy())
        np.testing.assert_array_equal(np.asarray(v), wv.numpy())
        np.testing.assert_array_equal(np.asarray(i), np.asarray(ji))
        np.testing.assert_allclose(np.asarray(v), np.asarray(jv),
                                   rtol=1e-5)


def test_env_knobs_turn_the_planes_on(small, tmp_path, monkeypatch):
    y, xs, idx = small
    path = str(tmp_path / "env.bin")
    monkeypatch.setenv("RAFT_TPU_SERVING_SHADOW_FRAC", "1.0")
    monkeypatch.setenv("RAFT_TPU_EXPLAIN_FRAC", "1.0")
    monkeypatch.setenv("RAFT_TPU_DEBUGZ_PORT", "0")
    monkeypatch.setenv("RAFT_TPU_BLACKBOX_PATH", path)
    monkeypatch.setenv("RAFT_TPU_WATCHDOG_S", "0.05")
    eng = ServingEngine(idx, k=K, buckets=(8,),
                        flush_interval_s=0.005).start()
    try:
        eng.query(xs[0], timeout=WAIT)
        assert eng.flush(WAIT)
        assert eng.shadow.flush(WAIT)
        st = eng.stats()
    finally:
        eng.stop()
    assert st["shadow_samples"] == 1 and st["explain"]["records"] == 1
    assert "debugz_port" in st and "watchdog" in st
    assert st["blackbox"]["path"] == path


def test_registry_telemetry_of_a_served_run(small):
    y, xs, idx = small
    eng = ServingEngine(idx, k=K, buckets=(8,),
                        flush_interval_s=0.005).start()
    try:
        futs = [eng.submit(x) for x in xs[:6]]
        assert eng.flush(WAIT)
        for f in futs:
            f.result(timeout=WAIT)
        with pytest.raises(Exception):
            eng.submit(np.zeros((9, D), np.float32))      # > top bucket
        st = eng.stats()
    finally:
        eng.stop()
    reg = obs.get_registry()
    assert st["registry_requests"] == {"ok": 6, "rejected": 1}
    assert reg.histogram("raft_tpu_serving_latency_seconds").count == 6
    assert reg.counter("raft_tpu_span_calls_total",
                       {"span": "serving.execute_batch",
                        "range": ""}).value == st["batches"] + 1  # warm-up
    from raft_tpu_torch.observability import quality

    block = quality.quality_block()
    assert block["sites"]["runtime.knn_query"]["checks"] >= 6 * ROWS
    flows = [e for e in obs.get_flight_recorder().events()
             if e["kind"] == "flow"]
    by_rid = {}
    for e in flows:
        by_rid.setdefault(e["flow_id"], []).append((e["ph"], e["step"]))
    assert by_rid[1] == [("s", "enqueue"), ("t", "batch"),
                         ("t", "dispatch"), ("f", "response")]
    assert by_rid[7][-1] == ("f", "reject")


def test_telemetry_off_serves_and_records_nothing(small):
    y, xs, idx = small
    obs.disable()
    obs.disable_flight()
    try:
        eng = ServingEngine(idx, k=K, buckets=(8,),
                            flush_interval_s=0.005).start()
        try:
            v, i = eng.query(xs[0], timeout=WAIT)
            assert eng.flush(WAIT)
            st = eng.stats()
        finally:
            eng.stop()
    finally:
        obs.enable()
        obs.enable_flight()
    assert st["requests_ok"] == 1 and st["registry_requests"] == {}
    assert len(obs.get_registry()) == 0
    assert len(obs.get_flight_recorder()) == 0


def test_serving_fault_sites(small):
    from raft_tpu_torch.resilience import InjectedDeviceError

    y, xs, idx = small
    eng = ServingEngine(idx, k=K, buckets=(8,),
                        flush_interval_s=0.005).start()
    try:
        faults.configure("serving_enqueue:error@call=2")
        eng.query(xs[0], timeout=WAIT)
        with pytest.raises(InjectedDeviceError):
            eng.submit(xs[1])
        faults.configure("serving_flush:error@call=1")
        fut = eng.submit(xs[2])
        assert isinstance(fut.exception(timeout=WAIT), InjectedDeviceError)
        eng.query(xs[3], timeout=WAIT)
        faults.configure("serving_snapshot:error")
        eng.update_index(y[:1024], block=True)
        assert eng.snapshot.generation == 0
        assert eng.stats()["snapshot"]["failures"] == 1
        faults.clear()
        eng.update_index(y[:1024], block=True)
        assert eng.snapshot.generation == 2
    finally:
        faults.clear()
        eng.stop()
    reg = obs.get_registry()
    assert reg.counter("raft_tpu_serving_snapshot_failures_total").value == 1
    assert reg.counter("raft_tpu_serving_snapshot_swaps_total").value == 1
    assert reg.counter("raft_tpu_span_calls_total",
                       {"span": "serving.build_snapshot",
                        "range": ""}).value == 2
    assert eng.stats()["registry_requests"]["error"] == 1


def test_ivf_pq_and_mutable_shadow_oracles(small):
    from raft_tpu_torch.ann import build_ivf_pq

    y, xs, idx = small
    res = DeviceResources(device="cpu")
    pq = build_ivf_pq(res, y, 16, pq_bits=8, n_probes=4, max_iter=4)
    for make in (lambda: ServingEngine(pq, k=K, algorithm="ivf_pq",
                                       res=res, buckets=(8,),
                                       flush_interval_s=0.005,
                                       shadow_frac=1.0, explain_frac=1.0),
                 lambda: ServingEngine(y, k=K, device="cpu", mutable=True,
                                       buckets=(8,), flush_interval_s=0.005,
                                       shadow_frac=1.0, **CFG)):
        obs.reset()
        eng = make().start()
        try:
            for x in xs[:4]:
                eng.query(x, timeout=WAIT)
            assert eng.flush(WAIT)
            assert eng.shadow.flush(WAIT)
            st = eng.stats()
        finally:
            eng.stop()
        assert st["shadow_samples"] == 4 and st["shadow_errors"] == 0
        assert 0.0 < st["shadow_recall"] <= 1.0
    rec = obs.explain_records()
    assert not rec       # the mutable engine ran last, explain off
