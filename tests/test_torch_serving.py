"""The port's serving engine (raft_tpu_torch.serving) on the CPU, at the
reference's own test shape (tests/test_serving.py: M=4100, D=32, K=7,
passes=3, T=256, Qb=32, g=2, buckets (8, 32)).

The bucket ladder and the env knobs must give the reference's results on
the same specs. Served answers must be bit-identical to the port's own
``knn_fused`` on the same index (one query's answer does not depend on the
batch it rides in), and their ids equal to the JAX engine's on the same
requests (both are certified exact at passes=3; values agree to f32
tolerance, ids may differ only at a proven tie). Every wait has a timeout
and every engine is stopped in a ``finally``: a hang fails one test.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu.serving import buckets as jbuckets
from raft_tpu_torch.core import DeadlineExceededError, DeviceResources, env
from raft_tpu_torch.distance.knn_fused import (knn_fused, pad_query_rows,
                                               prepare_knn_index)
from raft_tpu_torch.ops import _build
from raft_tpu_torch.resilience import deadline, wait_event, yield_
from raft_tpu_torch.serving import (IndexSnapshot, OverloadShedError,
                                    RequestTooLargeError, ServingEngine,
                                    SnapshotStore, bucket_for, bucket_ladder,
                                    default_bucket_ladder, execute_batch)

from _torch_threads import one_torch_thread  # noqa: F401

M, D, K = 4100, 32, 7
CFG = dict(passes=3, T=256, Qb=32, g=2)
WAIT = 30


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    y = rng.normal(size=(M, D)).astype(np.float32)
    return y, prepare_knn_index(y, device="cpu", **CFG)


def _engine(idx, **kw):
    kw.setdefault("buckets", (8, 32))
    kw.setdefault("flush_interval_s", 0.005)
    return ServingEngine(idx, k=K, **kw)


@pytest.fixture()
def engine(data):
    eng = _engine(data[1]).start()
    try:
        yield eng
    finally:
        eng.stop()


def _oracle(x, idx):
    v, i = knn_fused(x, idx, k=K)
    return v.numpy(), i.numpy()


def _queries(seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, D)).astype(np.float32) for n in sizes]


# ------------------------------------------------------------------
# bucket ladder and env knobs: the reference's results on the same specs
# ------------------------------------------------------------------
SPECS = ["8, 32,128", "3,9,9,120", "16;48", "x,y", "-8,16", "0", "",
         ",".join(str(8 * i) for i in range(1, 100)), " 64 "]


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("qb", [256, 32, 5])
def test_bucket_ladder_matches_reference(spec, qb):
    assert default_bucket_ladder(qb) == jbuckets.default_bucket_ladder(qb)
    assert bucket_ladder(qb, spec) == jbuckets.bucket_ladder(qb, spec)


def test_bucket_ladder_env_and_default(monkeypatch):
    assert default_bucket_ladder(256) == (16, 64, 256)
    monkeypatch.setenv("RAFT_TPU_SERVING_BUCKETS", "16,48")
    assert bucket_ladder(256) == jbuckets.bucket_ladder(256) == (16, 48)
    monkeypatch.setenv("RAFT_TPU_SERVING_BUCKETS", "nope")
    assert bucket_ladder(256) == jbuckets.bucket_ladder(256)


@pytest.mark.parametrize("name,value", [
    ("RAFT_TPU_SERVING_FLUSH_MS", None), ("RAFT_TPU_SERVING_FLUSH_MS", "7"),
    ("RAFT_TPU_SERVING_FLUSH_MS", "x"), ("RAFT_TPU_SERVING_QUEUE_CAP", None),
    ("RAFT_TPU_SERVING_QUEUE_CAP", "100"),
    ("RAFT_TPU_SERVING_DEADLINE_S", None),
    ("RAFT_TPU_SERVING_DEADLINE_S", "0.5"), ("RAFT_TPU_DB_DTYPE", "INT8"),
    ("RAFT_TPU_DB_DTYPE", "int4"), ("RAFT_TPU_SERVING_BUCKETS", " 8,16 ")])
def test_env_knobs_match_reference(monkeypatch, name, value):
    from raft_tpu.core import env as jenv

    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    assert env.get(name) == jenv.get(name)
    assert env.raw(name) == jenv.raw(name)


def test_bucket_for():
    assert bucket_for(1, (8, 32)) == 8
    assert bucket_for(8, (8, 32)) == 8
    assert bucket_for(9, (8, 32)) == 32
    assert bucket_for(33, (8, 32)) is None


def test_pad_query_rows_rejects_oversize():
    x = torch.ones((4, D))
    assert pad_query_rows(x, 4) is x
    assert pad_query_rows(x, 8).shape == (8, D)
    assert bool((pad_query_rows(x, 8)[4:] == 0).all())
    with pytest.raises(ValueError):
        pad_query_rows(x, 2)


# ------------------------------------------------------------------
# correctness through the batcher
# ------------------------------------------------------------------
def test_engine_matches_oracle_and_reference_engine(data, engine):
    from raft_tpu.distance.knn_fused import prepare_knn_index as jprepare
    from raft_tpu.serving import ServingEngine as JaxEngine

    y, idx = data
    xs = _queries(1, (1, 5, 8, 3, 12))
    futs = [engine.submit(x) for x in xs]
    assert engine.flush(WAIT)
    got = [f.result(timeout=WAIT) for f in futs]
    for (v, i), x in zip(got, xs):
        ov, oi = _oracle(x, idx)
        assert np.array_equal(v, ov) and np.array_equal(i, oi)
    jeng = JaxEngine(jprepare(y, **CFG), k=K, buckets=(8, 32),
                     flush_interval_s=0.005)
    jeng.start()
    try:
        jfuts = [jeng.submit(x) for x in xs]
        jeng.flush(WAIT)
        ref = [f.result(timeout=WAIT) for f in jfuts]
    finally:
        jeng.stop()
    for (v, i), (jv, ji), x in zip(got, ref, xs):
        np.testing.assert_allclose(v, jv, rtol=1e-5, atol=1e-5)
        for q in range(x.shape[0]):
            for e in set(i[q].tolist()) - set(np.asarray(ji[q]).tolist()):
                d2 = float(((x[q] - y[e]) ** 2).sum())
                assert abs(d2 - jv[q, -1]) <= 1e-5 * jv[q, -1] + 1e-5


def test_empty_queue_flush_timer_is_noop(data):
    _, idx = data
    eng = _engine(idx, flush_interval_s=0.002).start()
    try:
        before = eng.stats().get("batches", 0)
        time.sleep(0.05)                  # ~25 empty flush windows
        assert eng.stats().get("batches", 0) == before
        x = _queries(2, (4,))[0]
        v, i = eng.query(x, timeout=WAIT)
        ov, oi = _oracle(x, idx)
        assert np.array_equal(v, ov) and np.array_equal(i, oi)
    finally:
        eng.stop()


def test_batch_exactly_at_bucket_boundary(data):
    """Requests summing exactly to a bucket coalesce into one batch with
    no pad rows (a long flush window, then one forced flush)."""
    _, idx = data
    eng = _engine(idx, flush_interval_s=60.0).start()
    try:
        xs = _queries(3, (8, 8, 8, 8))
        futs = [eng.submit(x) for x in xs]
        assert eng.flush(WAIT)
        s = eng.stats()
        assert s["batches"] == 1 and s["padded_rows"] == 0
        for fut, x in zip(futs, xs):
            v, i = fut.result(timeout=WAIT)
            ov, oi = _oracle(x, idx)
            assert np.array_equal(v, ov) and np.array_equal(i, oi)
    finally:
        eng.stop()


def test_oversize_request_rejected_classified(engine):
    with pytest.raises(RequestTooLargeError):
        engine.submit(np.ones((33, D), np.float32))
    v, _ = engine.query(np.ones((2, D), np.float32), timeout=WAIT)
    assert v.shape == (2, K)
    assert engine.stats()["requests_rejected"] == 1


def test_overload_shed(data):
    _, idx = data
    eng = _engine(idx, buckets=(8,), max_queue_rows=8)
    # not started: the queue cannot drain, so the cap must trip
    eng.submit(np.ones((8, D), np.float32))
    with pytest.raises(OverloadShedError):
        eng.submit(np.ones((1, D), np.float32))
    assert eng.stats()["shed"] == 1


# ------------------------------------------------------------------
# snapshots
# ------------------------------------------------------------------
def test_snapshot_swap_mid_batch_consistent_ids(data):
    """Requests in flight across a swap each see exactly one snapshot."""
    y, idx = data
    y2 = np.random.default_rng(8).normal(size=(M, D)).astype(np.float32)
    idx2 = prepare_knn_index(y2, device="cpu", **CFG)
    eng = _engine(idx).start()
    try:
        xs = _queries(4, (4,) * 8)
        oracles = [(_oracle(x, idx), _oracle(x, idx2)) for x in xs]
        futs = [eng.submit(x) for x in xs[:4]]
        swapper = threading.Thread(
            target=lambda: eng.update_index(y2, block=True))
        swapper.start()
        futs += [eng.submit(x) for x in xs[4:]]
        swapper.join(WAIT)
        assert not swapper.is_alive()
        assert eng.flush(WAIT)
        for fut, ((ov1, oi1), (ov2, oi2)) in zip(futs, oracles):
            v, i = fut.result(timeout=WAIT)
            old = np.array_equal(v, ov1) and np.array_equal(i, oi1)
            new = np.array_equal(v, ov2) and np.array_equal(i, oi2)
            assert old or new, "response mixes snapshots"
        v, i = eng.query(xs[0], timeout=WAIT)
        assert np.array_equal(i, oracles[0][1][1])
        assert eng.snapshot.generation == 1
        assert eng.stats()["snapshot"]["swaps"] == 1
    finally:
        eng.stop()


def test_snapshot_build_failure_keeps_current(data):
    y, idx = data
    fail = [True]

    def build(yy, **kw):
        if fail[0]:
            raise RuntimeError("build failed")
        return prepare_knn_index(yy, device="cpu", **CFG)

    store = SnapshotStore(build, initial_index=idx)
    cur = store.current()
    store.update(y, block=True)
    assert store.current() is cur
    assert isinstance(store.last_error, RuntimeError)
    assert store.stats()["failures"] == 1
    fail[0] = False
    store.update(y, block=True)
    assert store.current() is not cur
    assert store.current().generation == 2


def test_snapshot_store_coalesces_a_lost_race(data):
    """A build that finishes after a newer generation was installed is
    coalesced away (counted) and never replaces it."""
    _, idx = data
    gate = threading.Event()

    def build(yy, **kw):
        if yy.shape[0] == 64:             # the slow build, held
            assert gate.wait(timeout=WAIT)
        return prepare_knn_index(yy, device="cpu", **CFG)

    store = SnapshotStore(build, initial_index=idx)
    rng = np.random.default_rng(9)
    t = store.update(rng.normal(size=(64, D)).astype(np.float32))
    store.update(rng.normal(size=(72, D)).astype(np.float32), block=True)
    assert store.current().generation == 2
    assert store.stats()["rebuild_inflight"] == 1
    gate.set()
    t.join(WAIT)
    s = store.stats()
    assert store.current().generation == 2
    assert s["coalesced"] == 1 and s["swaps"] == 1
    assert s["rebuild_inflight"] == 0


# ------------------------------------------------------------------
# warm-up: one dispatch per rung, then no kernel build or load
# ------------------------------------------------------------------
class _CountingEngine(ServingEngine):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.dispatched = []

    def _plane(self, snap, xb):
        self.dispatched.append(xb.shape[0])
        return super()._plane(snap, xb)


def test_warmup_dispatches_each_rung_then_no_builds(data):
    y, idx = data
    eng = _CountingEngine(idx, k=K, buckets=(8, 16, 32),
                          flush_interval_s=0.002)
    eng.start()
    try:
        assert eng.dispatched == [8, 16, 32]
        s = eng.stats()
        assert s["warmed_buckets"] == 3 and s["builds_after_warmup"] == 0
        b0 = _build.BUILDS + _build.LOADS
        for x in _queries(5, (1, 3, 8, 8, 2, 12, 32, 5)):
            eng.query(x, timeout=WAIT)
        assert _build.BUILDS + _build.LOADS == b0
        assert eng.stats()["builds_after_warmup"] == 0
        # a rebuilt snapshot is warmed before it is swapped in
        n = len(eng.dispatched)
        eng.update_index(y[::-1].copy(), block=True)
        assert eng.dispatched[n:n + 3] == [8, 16, 32]
        assert eng.snapshot.generation == 1
    finally:
        eng.stop()


# ------------------------------------------------------------------
# deadlines
# ------------------------------------------------------------------
def test_request_deadline_expires_in_queue(data):
    _, idx = data
    fake = [0.0]
    eng = _engine(idx, buckets=(8,), flush_interval_s=60.0,
                  clock=lambda: fake[0]).start()
    try:
        fut = eng.submit(np.ones((2, D), np.float32), deadline_s=0.05)
        fake[0] = 1.0                       # budget long gone
        assert eng.flush(WAIT)
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=WAIT)
        assert eng.stats()["expired_in_queue"] == 1
        assert eng.stats().get("batches", 0) == 0
    finally:
        eng.stop()


class _HangOnce(ServingEngine):
    """A plane whose first live dispatch hangs until cancelled, as a
    stuck kernel would (a completion event that never fires)."""

    hang = False

    def _plane(self, snap, xb):
        if self.hang:
            self.hang = False

            class _Never:
                def query(self):
                    return False

            wait_event(_Never())            # cancellable, never done
        return super()._plane(snap, xb)


def test_hung_dispatch_converts_via_batch_deadline(data):
    _, idx = data
    eng = _HangOnce(idx, k=K, buckets=(8,), flush_interval_s=0.002).start()
    try:
        eng.hang = True
        t0 = time.monotonic()
        fut = eng.submit(np.ones((2, D), np.float32), deadline_s=0.2)
        with pytest.raises(DeadlineExceededError):
            fut.result(timeout=WAIT)
        assert time.monotonic() - t0 < 10.0
        v, _ = eng.query(np.ones((2, D), np.float32), timeout=WAIT)
        assert v.shape == (2, K)
    finally:
        eng.stop()


def test_failed_dispatch_fails_batch_engine_survives(data):
    _, idx = data

    class _FailOnce(ServingEngine):
        fail = True

        def _plane(self, snap, xb):
            if self.fail:
                self.fail = False
                raise RuntimeError("dispatch failed")
            return super()._plane(snap, xb)

    eng = _FailOnce(idx, k=K, buckets=(8,), flush_interval_s=0.002)
    eng._warm_snapshot = lambda snap: None       # the failure is live
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="dispatch failed"):
            eng.submit(np.ones((2, D), np.float32)).result(timeout=WAIT)
        v, _ = eng.query(np.ones((2, D), np.float32), timeout=WAIT)
        assert v.shape == (2, K)
        assert eng.stats()["requests_error"] == 1
    finally:
        eng.stop()


def test_deadline_scope_semantics():
    with pytest.raises(DeadlineExceededError) as e:
        with deadline(0.01, label="outer"):
            time.sleep(0.05)
            yield_()
    assert e.value.seconds == 0.01
    # a scope that ends in time costs nothing and leaves no poison
    with deadline(5.0):
        pass
    yield_()
    # the body ran over: the scope raises at exit
    with pytest.raises(DeadlineExceededError):
        with deadline(0.01):
            time.sleep(0.05)
    # nested: the inner expiry is consumed, the outer stays armed
    with deadline(5.0, label="outer"):
        with pytest.raises(DeadlineExceededError, match="inner"):
            with deadline(0.01, label="inner"):
                time.sleep(0.05)
        yield_()


def test_execute_batch_pads_and_slices(data):
    _, idx = data
    eng = _engine(idx)
    x = _queries(6, (5,))[0]
    v, i, n_fail = execute_batch(eng._plane, IndexSnapshot(idx, 0), x, 8, 5)
    assert v.shape == i.shape == (5, K) and n_fail >= 0
    ov, oi = _oracle(x, idx)
    assert np.array_equal(v, ov) and np.array_equal(i, oi)


@pytest.mark.parametrize("db_dtype", ["bf16", "int8"])
def test_answers_do_not_depend_on_the_batch(data, db_dtype):
    """A served answer must equal the query asked alone: the certified
    path and the exact fixup (every int8 query here) give the same bits
    for a query whatever else is in its batch."""
    rng = np.random.default_rng(14)
    # clustered, norm-offset rows: many queries fail the certificate
    centers = rng.normal(size=(8, D)).astype(np.float32) * 5.0 + 20.0
    y = centers[rng.integers(0, 8, M)] + 0.05 * rng.normal(
        size=(M, D)).astype(np.float32)
    x = centers[rng.integers(0, 8, 40)] + 0.05 * rng.normal(
        size=(40, D)).astype(np.float32)
    idx = prepare_knn_index(y, device="cpu", db_dtype=db_dtype, **CFG)
    vb, ib, n_fail = knn_fused(x, idx, K, with_stats=True)
    assert n_fail > 0
    for q in (0, 7, 39):
        for rows in ((q, q + 1), (q,)):
            lo, hi = rows[0], min(rows[-1] + 1, x.shape[0])
            v, i = knn_fused(x[lo:hi], idx, K)
            assert torch.equal(v[0], vb[q]) and torch.equal(i[0], ib[q])


# ------------------------------------------------------------------
# the other planes
# ------------------------------------------------------------------
def _assert_certified(v, i, x, y):
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    d2 = (x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None] \
        - 2 * x64 @ y64.T
    oi = np.argsort(d2, axis=1, kind="stable")[:, :K]
    ov = np.take_along_axis(d2, oi, 1)
    np.testing.assert_allclose(v, ov, rtol=1e-5, atol=1e-4)
    for q in range(x.shape[0]):
        for e in set(i[q].tolist()) - set(oi[q].tolist()):
            assert abs(d2[q, e] - ov[q, -1]) <= 1e-5 * ov[q, -1] + 1e-4


def test_int8_plane_matches_f32_oracle_through_rebuilds(data, monkeypatch):
    y, _ = data
    monkeypatch.setenv("RAFT_TPU_DB_DTYPE", "int8")
    eng = _engine(y, device="cpu", **CFG).start()
    try:
        assert eng.snapshot.index.db_dtype == "int8"
        xs = _queries(10, (3, 8, 17))
        futs = [eng.submit(x) for x in xs]
        assert eng.flush(WAIT)
        for fut, x in zip(futs, xs):
            v, i = fut.result(timeout=WAIT)
            _assert_certified(v, i, x, y)
        y2 = np.random.default_rng(11).normal(size=(M, D)).astype(
            np.float32)
        eng.update_index(y2, block=True)
        assert eng.snapshot.index.db_dtype == "int8"
        v, i = eng.query(xs[1], timeout=WAIT)
        _assert_certified(v, i, xs[1], y2)
    finally:
        eng.stop()


def test_ivf_flat_plane_matches_search(data):
    from raft_tpu_torch.ann import build_ivf_flat, search_ivf_flat

    y, _ = data
    res = DeviceResources(device="cpu")
    ivf = build_ivf_flat(res, y, 16, n_probes=4, max_iter=4)
    eng = _engine(ivf, algorithm="ivf_flat", res=res).start()
    try:
        xs = _queries(12, (2, 6, 9))
        futs = [eng.submit(x) for x in xs]
        assert eng.flush(WAIT)
        for fut, x in zip(futs, xs):
            v, i = fut.result(timeout=WAIT)
            rv, ri = search_ivf_flat(res, ivf, x, K)
            # the bits of the query asked alone, whatever bucket and
            # schedule the engine's batch took
            np.testing.assert_array_equal(v, rv.numpy())
            np.testing.assert_array_equal(i, ri.numpy())
    finally:
        eng.stop()


def test_ivf_pq_plane_matches_search(data):
    """An ivf_pq engine answers each request with the bits of
    search_ivf_pq asked the same query alone, through a rebuild."""
    from raft_tpu_torch.ann import IvfPqIndex, build_ivf_pq, search_ivf_pq
    from raft_tpu_torch.ops import pq_scan

    y, _ = data
    res = DeviceResources(device="cpu")
    pq = build_ivf_pq(res, y, 16, pq_bits=8, n_probes=4, max_iter=4)
    eng = _engine(pq, algorithm="ivf_pq", res=res).start()
    try:
        assert eng.stats()["warmed_buckets"] == 2
        assert eng.stats()["builds_after_warmup"] == 0
        launches = (pq_scan.LAUNCHES_8BIT, pq_scan.LAUNCHES_4BIT)
        xs = _queries(13, (2, 6, 9, 1, 16))
        futs = [eng.submit(x) for x in xs]
        assert eng.flush(WAIT)
        for fut, x in zip(futs, xs):
            v, i = fut.result(timeout=WAIT)
            rv, ri = search_ivf_pq(res, pq, x, K)
            assert np.array_equal(v, rv.numpy())
            assert np.array_equal(i, ri.numpy())
        assert (pq_scan.LAUNCHES_8BIT, pq_scan.LAUNCHES_4BIT) == launches
        # a rebuild from raw rows keeps the plane: pq_bits and n_probes
        eng.update_index(y[:2000], block=True)
        snap = eng.snapshot.index
        assert isinstance(snap, IvfPqIndex) and snap.pq_bits == 8
        x = xs[2]
        v, i = eng.query(x, timeout=WAIT)
        rv, ri = search_ivf_pq(res, snap, x, K)
        assert np.array_equal(v, rv.numpy()) and np.array_equal(i, ri.numpy())
    finally:
        eng.stop()


def test_ivf_pq_plane_matches_reference_engine(monkeypatch):
    """At the reference test's shape (tests/test_ivf_pq.py:
    test_serving_snapshot_swap), the port's engine over the reference's
    snapshot index, carried across, serves the JAX engine's answers. The
    widen rung is capped at 1 in both engines: the JAX engine's warm-up
    then compiles one ADC program per schedule rung, not three."""
    monkeypatch.setenv("RAFT_TPU_ANN_PQ_WIDEN", "1")
    from raft_tpu.serving import ServingEngine as JaxEngine
    from raft_tpu_torch.ann import IvfPqIndex
    from test_torch_ivf_pq import _assert_same, _dup_data, export

    base, X = _dup_data()
    r = np.random.default_rng(3)
    Q = (base[r.choice(base.shape[0], 16, replace=False)]
         + r.normal(0, 0.02, (16, X.shape[1]))).astype(np.float32)
    k = 5
    jeng = JaxEngine(X, k=k, algorithm="ivf_pq", n_lists=96, n_probes=4,
                     pq_bits=8, buckets=(16,))
    jeng.start()
    try:
        jv, ji = jeng.submit(Q).result(timeout=60)
        jidx = jeng._store.current().index
    finally:
        jeng.stop()
    res = DeviceResources(device="cpu")
    eng = ServingEngine(IvfPqIndex.from_numpy(export(jidx), device="cpu"),
                        k=k, algorithm="ivf_pq", n_probes=4, buckets=(16,),
                        flush_interval_s=0.005, res=res).start()
    try:
        v, i = eng.submit(Q).result(timeout=WAIT)
    finally:
        eng.stop()
    # values to f32 tolerance with the expanded form's cancellation floor,
    # ids equal up to a tie proven from the values (test_torch_ivf_pq.py)
    _assert_same(v, i, np.asarray(jv), np.asarray(ji), Q, X)


@pytest.mark.parametrize("option,value,item", [("mesh", object(), 7)])
def test_left_out_options_raise(data, option, value, item):
    _, idx = data
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        ServingEngine(idx, k=K, **{option: value})


# ------------------------------------------------------------------
# the mutable and durable planes (reference tests/test_mutable.py and
# tests/test_durability.py engine cases)
# ------------------------------------------------------------------
MD = 16
MCFG = dict(CFG, buckets=(8, 32), flush_interval_s=0.002)


def _mut_rows(seed, n=300):
    return np.random.default_rng(seed).normal(size=(n, MD)).astype(
        np.float32)


def _mut_engine(y, **kw):
    return ServingEngine(y, k=5, device="cpu", mutable=True,
                         **dict(MCFG, **kw))


@pytest.mark.parametrize("option", ["mutable", "index_ids",
                                    "compact_threshold", "delta_cap",
                                    "durable", "durable_dir", "wal_sync"])
def test_mutable_options_honoured(tmp_path, option):
    """Each of the seven mutable and durable options is honoured."""
    y = _mut_rows(1)
    kw = {}
    if option == "index_ids":
        kw["index_ids"] = np.arange(1000, 1300)
    elif option == "compact_threshold":
        kw["compact_threshold"] = 16
    elif option == "delta_cap":
        kw.update(delta_cap=60, compact_threshold=16)
    elif option in ("durable", "durable_dir", "wal_sync"):
        kw.update(durable=True, durable_dir=str(tmp_path / "dur"))
        if option == "wal_sync":
            kw["wal_sync"] = "always"
    eng = _mut_engine(y, **kw).start()
    try:
        mi = eng.mutable
        assert mi is not None
        _, ids = eng.query(y[:3] + 1e-3, timeout=WAIT)
        if option == "index_ids":
            assert ids[:, 0].tolist() == [1000, 1001, 1002]
        else:
            assert ids[:, 0].tolist() == [0, 1, 2]
        if option == "compact_threshold":
            assert mi.compact_threshold == 16
            assert mi.delta_cap == 32                 # 2 × the threshold
        if option == "delta_cap":
            assert mi.delta_cap == 64                 # the 8-row quantum
        info, _ = eng.upsert([5000], y[:1] * 2).result(timeout=WAIT)
        assert info["applied"] == 1
        if option in ("durable", "durable_dir", "wal_sync"):
            dur = eng.stats()["durability"]
            assert dur["sync"] == ("always" if option == "wal_sync"
                                   else "batch")
            # lsn 1 marks the genesis checkpoint, lsn 2 is the upsert
            assert dur["checkpoints"] == 1 and dur["durable_lsn"] == 2
            assert os.path.exists(tmp_path / "dur" / "CURRENT")
    finally:
        eng.stop()


def test_mutable_engine_ordered_with_queries_against_jax_engine():
    """Queries, upserts and deletes through the port's engine and the JAX
    engine in the same order: the same answers at every step, a delete
    queued before a query visible to it, one queued after not."""
    from raft_tpu.serving import ServingEngine as JEngine

    y = _mut_rows(2)
    x = _mut_rows(3, 4)
    ups = _mut_rows(4, 3)
    jeng = JEngine(y, k=5, mutable=True, compact_threshold=1000,
                   shadow_frac=0.0, **dict(MCFG, Qb=32))
    eng = _mut_engine(y, compact_threshold=1000)
    jeng.start()
    eng.start()
    try:
        script = [("q", None), ("d", [0, 1]), ("q", None),
                  ("u", ([700, 2, 3], ups)), ("q", None), ("d", [700]),
                  ("q", None)]
        for e in (eng, jeng):
            futs = []
            for kind, arg in script:
                if kind == "q":
                    futs.append(e.submit(x))
                elif kind == "d":
                    futs.append(e.delete(arg))
                else:
                    futs.append(e.upsert(*arg))
            e._res = [f.result(timeout=WAIT) for f in futs]
        for (kind, _), a, b in zip(script, eng._res, jeng._res):
            if kind == "q":
                np.testing.assert_array_equal(a[1], np.asarray(b[1]))
                np.testing.assert_allclose(a[0], np.asarray(b[0]),
                                           rtol=1e-5, atol=1e-5)
            else:
                assert a[0]["applied"] == b[0]["applied"]
        assert not {0, 1, 700} & set(eng._res[-1][1].ravel().tolist())
        st, jst = eng.stats(), jeng.stats()
        assert st["mutable"] == jst["mutable"]
        assert st["upserts"] == 1 and st["deletes"] == 2
    finally:
        eng.stop()
        jeng.stop()


def test_mutable_engine_upsert_past_delta_cap_rejected():
    eng = _mut_engine(_mut_rows(5), compact_threshold=16).start()
    try:
        cap = eng.mutable.delta_cap
        with pytest.raises(RequestTooLargeError):
            eng.upsert(np.arange(10_000, 10_001 + cap),
                       _mut_rows(6, cap + 1))
        assert eng.stats()["requests_rejected"] == 1
    finally:
        eng.stop()


def test_immutable_engine_rejects_mutations(data):
    """An immutable engine refuses upsert/delete, and a mutable one the
    whole-index replace, as the reference's do."""
    from raft_tpu_torch.core import LogicError

    _, idx = data
    eng = _engine(idx)
    for call in (lambda: eng.upsert([1], np.ones((1, D), np.float32)),
                 lambda: eng.delete([1])):
        with pytest.raises(LogicError):
            call()
    y = _mut_rows(7, 64)
    eng2 = _mut_engine(y)
    with pytest.raises(LogicError):
        eng2.update_index(y)


def test_mutable_ivf_pq_engine_masks_deletes():
    """The IVF-PQ plane serves mutably: a deleted id never comes back on
    the probed path, an upserted row is found."""
    y = _mut_rows(8, 400)
    eng = ServingEngine(y, k=5, device="cpu", algorithm="ivf_pq",
                        mutable=True, n_lists=8, n_probes=3, pq_bits=8,
                        buckets=(8, 32), flush_interval_s=0.002).start()
    try:
        eng.delete(np.arange(40)).result(timeout=WAIT)
        eng.upsert([900], y[:1] + 0.5).result(timeout=WAIT)
        _, ids = eng.query(np.concatenate([y[:8], y[:1] + 0.5]),
                           timeout=WAIT)
        assert not set(ids.ravel().tolist()) & set(range(40))
        assert ids[-1, 0] == 900
    finally:
        eng.stop()


def test_durable_engine_restart_recovers(tmp_path):
    y = _mut_rows(9, 64)
    d = str(tmp_path / "dur")
    q = _mut_rows(10, 3)
    e1 = _mut_engine(y, durable=True, durable_dir=d,
                     compact_threshold=10_000).start()
    try:
        e1.upsert([100, 101], _mut_rows(11, 2)).result(timeout=WAIT)
        e1.delete([0]).result(timeout=WAIT)
        v1, i1 = e1.query(q, timeout=WAIT)
    finally:
        e1.stop()
    e2 = _mut_engine(y, durable=True, durable_dir=d,
                     compact_threshold=10_000)
    assert e2.recovery is not None
    assert e2.recovery["replayed_records"] == 2
    e2.start()
    try:
        v2, i2 = e2.query(q, timeout=WAIT)
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, atol=1e-5)
        st = e2.stats()
        assert "recovery" in st and "durability" in st
    finally:
        e2.stop()


def test_durable_engine_requires_dir(monkeypatch):
    from raft_tpu_torch.core import LogicError

    monkeypatch.delenv("RAFT_TPU_DURABLE_DIR", raising=False)
    with pytest.raises(LogicError, match="durable_dir"):
        _mut_engine(_mut_rows(12, 64), durable=True)


def test_durable_dir_from_env(tmp_path, monkeypatch):
    d = str(tmp_path / "envdur")
    monkeypatch.setenv("RAFT_TPU_DURABLE_DIR", d)
    eng = _mut_engine(_mut_rows(13, 64), durable=True)
    try:
        assert eng.mutable.durability.directory == d
    finally:
        eng.stop()


def test_engine_needs_a_card_unless_asked_for_the_cpu(data):
    from raft_tpu_torch.core import DeviceError

    y, _ = data
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(DeviceError):
        ServingEngine(y, k=K, **CFG)
    assert ServingEngine(y, k=K, device="cpu", **CFG).snapshot.index \
        .device.type == "cpu"


# ------------------------------------------------------------------
# closed loop: several clients, every answer the oracle's
# ------------------------------------------------------------------
def test_closed_loop_clients(data):
    _, idx = data
    eng = _engine(idx, flush_interval_s=0.002).start()
    sizes = np.clip(np.random.default_rng(3).poisson(4, 48), 1, 32)
    xs = _queries(13, sizes)
    results, errors = [None] * len(xs), []
    lock = threading.Lock()
    nxt = [0]

    def client():
        while True:
            with lock:
                j = nxt[0]
                if j >= len(xs):
                    return
                nxt[0] += 1
            try:
                results[j] = eng.submit(xs[j]).result(timeout=WAIT)
            except Exception as e:           # pragma: no cover
                errors.append(repr(e))

    try:
        threads = [threading.Thread(target=client) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(2 * WAIT)
        assert not errors and all(r is not None for r in results)
        for (v, i), x in zip(results, xs):
            ov, oi = _oracle(x, idx)
            assert np.array_equal(v, ov) and np.array_equal(i, oi)
        s = eng.stats()
        assert s["requests_ok"] == len(xs) and s["batches"] <= len(xs)
        assert s["p99_ms"] >= s["p50_ms"] > 0
    finally:
        eng.stop()
