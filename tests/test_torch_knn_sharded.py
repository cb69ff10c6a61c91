"""Parity of the port's sharded certified KNN (raft_tpu_torch.distance.
knn_sharded) with the reference's (raft_tpu.distance.knn_sharded), on the
CPU.

Both packages get the same seeded numpy data. The reference runs
``shard_map`` over ``jax.devices()[:p]`` of the 8 virtual CPU devices
(its Pallas kernels in interpret mode); the port runs p in-process ranks
on the CPU through K1's twin. Tolerances:

- against the port's own single-device ``knn_fused``: values bit for bit
  and ids identical in order (a shard's candidates are rescored by the
  same row-wise f32 dot, and every merge ranks as ``jax.lax.top_k``);
- against the reference's sharded function: ids identical in order, and
  values within 1e-5 relative. That is the single-device tolerance of
  tests/test_torch_knn_fused.py: the two packages' f32 rescores sum in
  different orders, so values differ in the last bits by the same
  amounts on one device and on p (the reference's sharded values equal
  its own single-device values bit for bit, as the port's equal the
  port's). The data is N(0, 1), so no two distances tie and the order
  of the ids is the same in both.

The reference's shape (tests/test_knn_sharded.py:24-26): m = 4100,
d = 32, k = 7, nq = 33, T = 256, Qb = 32, g = 2.
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu.distance import knn_sharded as jks
from raft_tpu.distance.knn_fused import prepare_knn_index as jprepare
from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu_torch import observability as obs
from raft_tpu_torch.distance import knn_sharded as tks
from raft_tpu_torch.distance.knn_fused import knn_fused, prepare_knn_index
from raft_tpu_torch.parallel import make_mesh
from raft_tpu_torch.resilience import (PoisonedOutputError,
                                       degradation_reasons, faults)

M, D, K, NQ = 4100, 32, 7, 33
CFG = dict(T=256, Qb=32, g=2)
RTOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    faults.clear()
    yield
    faults.clear()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    y = rng.normal(size=(M, D)).astype(np.float32)
    x = rng.normal(size=(NQ, D)).astype(np.float32)
    ov, oi = knn_fused(torch.from_numpy(x), torch.from_numpy(y), K,
                       passes=3, T=256, g=2)
    return x, y, ov.numpy(), oi.numpy()


def _mesh(p):
    return make_mesh({"x": p}, devices=[CPU] * p)


def _jmesh(p):
    return jmake_mesh({"x": p}, devices=jax.devices()[:p])


def _same_as_reference(v, i, jv, ji):
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_allclose(v.numpy(), jv, rtol=RTOL, atol=0)


def _same_bits(v, i, ov, oi):
    assert np.array_equal(v.numpy().view(np.int32), ov.view(np.int32))
    np.testing.assert_array_equal(i.numpy(), oi)


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("merge", ["allgather", "tournament"])
def test_sharded_matches_reference_and_single_device(data, p, merge):
    x, y, ov, oi = data
    jidx = jks.prepare_knn_index_sharded(y, mesh=_jmesh(p), passes=3, **CFG)
    jv, ji = jks.knn_fused_sharded(x, jidx, K, mesh=_jmesh(p), merge=merge)
    idx = tks.prepare_knn_index_sharded(y, mesh=_mesh(p), passes=3, **CFG)
    assert idx.rows_per == jidx.rows_per and idx.g == jidx.g
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=_mesh(p), merge=merge)
    _same_as_reference(v, i, jv, ji)
    _same_bits(v, i, ov, oi)


def test_host_merge_and_auto_give_the_same_bits(data):
    x, y, ov, oi = data
    m = _mesh(4)
    idx = tks.prepare_knn_index_sharded(y, mesh=m, passes=3, **CFG)
    for merge in ("host", "auto"):
        v, i = tks.knn_fused_sharded(x, idx, K, mesh=m, merge=merge)
        _same_bits(v, i, ov, oi)
    # raw matrix, prepared per call
    v, i = tks.knn_fused_sharded(x, y, K, mesh=m, passes=3, **CFG)
    _same_bits(v, i, ov, oi)


@pytest.mark.parametrize("p", [3, 8])
def test_query_mode_matches_reference(data, p):
    x, y, ov, oi = data
    jv, ji = jks.knn_fused_sharded(x, jprepare(y, passes=3, **CFG), K,
                                   mesh=_jmesh(p), shard_mode="query")
    v, i = tks.knn_fused_sharded(
        x, prepare_knn_index(y, passes=3, T=256, g=2, device="cpu"), K,
        mesh=_mesh(p), shard_mode="query")
    _same_as_reference(v, i, jv, ji)
    _same_bits(v, i, ov, oi)


def test_micro_batches_match_reference(data):
    x, y, ov, oi = data
    jidx = jks.prepare_knn_index_sharded(y, mesh=_jmesh(4), passes=3,
                                         grid_order="db", **CFG)
    idx = tks.prepare_knn_index_sharded(y, mesh=_mesh(4), passes=3,
                                        grid_order="db", **CFG)
    for nb in (1, 3):
        jv, ji = jks.knn_fused_sharded(x, jidx, K, mesh=_jmesh(4),
                                       merge="tournament", micro_batches=nb)
        v, i = tks.knn_fused_sharded(x, idx, K, mesh=_mesh(4),
                                     merge="tournament", micro_batches=nb)
        _same_as_reference(v, i, jv, ji)
        _same_bits(v, i, ov, oi)


@pytest.mark.parametrize("kw", [dict(db_dtype="int8"), dict(metric="ip"),
                                dict(passes=1, certify="f32")],
                         ids=["int8", "ip", "p1_f32"])
def test_options_match_reference(data, kw):
    x, y, _, _ = data
    build = {a: b for a, b in kw.items() if a != "certify"}
    certify = kw.get("certify", "kernel")
    jidx = jks.prepare_knn_index_sharded(y, mesh=_jmesh(4), **CFG, **build)
    jv, ji = jks.knn_fused_sharded(x, jidx, K, mesh=_jmesh(4),
                                   merge="tournament", certify=certify)
    idx = tks.prepare_knn_index_sharded(y, mesh=_mesh(4), **CFG, **build)
    assert idx.db_dtype == jidx.db_dtype
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=_mesh(4),
                                 merge="tournament", certify=certify)
    _same_as_reference(v, i, jv, ji)
    ov, oi = knn_fused(torch.from_numpy(x), torch.from_numpy(y), K,
                       T=256, g=2, certify=certify,
                       passes=build.get("passes", 3),
                       metric=build.get("metric", "l2"),
                       db_dtype=build.get("db_dtype"))
    _same_bits(v, i, ov.numpy(), oi.numpy())


def test_ragged_shards_match_reference():
    """m = 1100 over 8 ranks of 512 rows: ranks 3..7 hold few or no real
    rows; pad rows never win and no pad id leaks."""
    rng = np.random.default_rng(11)
    y = rng.normal(size=(1100, 16)).astype(np.float32)
    x = rng.normal(size=(18, 16)).astype(np.float32)
    jidx = jks.prepare_knn_index_sharded(y, mesh=_jmesh(8), passes=3, **CFG)
    jv, ji = jks.knn_fused_sharded(x, jidx, 5, mesh=_jmesh(8),
                                   merge="tournament")
    idx = tks.prepare_knn_index_sharded(y, mesh=_mesh(8), passes=3, **CFG)
    assert idx.m_valid[-1] == 0
    v, i = tks.knn_fused_sharded(x, idx, 5, mesh=_mesh(8),
                                 merge="tournament")
    _same_as_reference(v, i, jv, ji)
    assert int(i.max()) < 1100


def test_lite_index_matches_reference(data):
    """store_yp=False: the id sets of the lite result agree, values
    within the packed-code perturbation 2^(pbits−23) (reference
    test_sharded_lite_mode_pack_tolerance)."""
    x, y, _, _ = data
    yl = y[:4096]
    kw = dict(passes=1, store_yp=False, grid_order="db", **CFG)
    jv, ji = jks.knn_fused_sharded(
        x, jks.prepare_knn_index_sharded(yl, mesh=_jmesh(4), **kw), K,
        mesh=_jmesh(4))
    idx = tks.prepare_knn_index_sharded(yl, mesh=_mesh(4), **kw)
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=_mesh(4))
    assert np.array_equal(np.sort(i.numpy(), 1), np.sort(np.asarray(ji), 1))
    jv = np.asarray(jv)
    tol = 4.0 * np.abs(jv).max() * 2.0 ** (idx.pbits - 23)
    np.testing.assert_allclose(v.numpy(), jv, atol=tol)


def test_inf_row_follows_the_reference_sharded_function(data):
    """The reference's shard function maps every non-finite candidate to
    (+inf, −1) before the merge, so a row holding ±inf never names a
    result on the sharded path, while the port's single-device path keeps
    it (the F1 repair). The port's sharded path is held to the
    reference's sharded function; the difference from the single-device
    answer is a reference caveat the port keeps (ROADMAP queue 3)."""
    x, y, _, _ = data
    y = y.copy()
    y[5] = np.inf
    y[1000, 3] = -np.inf
    jv, ji = jks.knn_fused_sharded(
        x, jks.prepare_knn_index_sharded(y, mesh=_jmesh(4), **CFG), K,
        mesh=_jmesh(4), merge="allgather")
    v, i = tks.knn_fused_sharded(
        x, tks.prepare_knn_index_sharded(y, mesh=_mesh(4), **CFG), K,
        mesh=_mesh(4), merge="allgather")
    _same_as_reference(v, i, jv, ji)
    assert not np.isin(i.numpy(), [5, 1000]).any()
    _, si = knn_fused(torch.from_numpy(x), torch.from_numpy(y), K, T=256,
                      g=2)
    assert np.isin(si.numpy(), [5, 1000]).any()


def test_ladder_under_injected_faults(data):
    """A collective failure walks tournament → allgather → host; an OOM
    halves the query block; a NaN-poisoned output is retried, and one
    that always poisons exhausts the retries. Every rung gives the
    single-device bits (reference tests/test_resilience.py:625-686)."""
    x, y, ov, oi = data
    m = _mesh(4)
    idx = tks.prepare_knn_index_sharded(y, mesh=m, passes=3, **CFG)
    faults.configure("merge_permute:timeout")
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=m, merge="tournament")
    _same_bits(v, i, ov, oi)
    faults.configure("merge_permute:timeout;merge_allgather:error")
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=m, merge="tournament")
    _same_bits(v, i, ov, oi)
    faults.configure("sharded_dispatch:oom@call=1")
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=m, merge="allgather")
    _same_bits(v, i, ov, oi)
    faults.configure("sharded_dispatch:nan@call=1")
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=m, merge="allgather")
    _same_bits(v, i, ov, oi)
    reasons = " ".join(degradation_reasons())
    assert "merge:tournament->allgather x2" in reasons
    assert "merge:allgather->host x1" in reasons
    assert "fit:Qb:32->16" in reasons
    faults.configure("sharded_dispatch:nan")
    with pytest.raises(PoisonedOutputError):
        tks.knn_fused_sharded(x, idx, K, mesh=m, merge="allgather")


def test_rank_failure_walks_the_ladder(data, monkeypatch):
    """Rank-local (``knn_fused_shard`` over in-process ranks, as a
    process group runs it): a rank that raises a device error inside the
    tournament fails the others' collectives with CollectiveError at once
    (no hang), and the call raises that rank's own error. On the single
    controller, a device error in the tournament merge walks the ladder to
    the allgather with the single-device bits."""
    import time

    from raft_tpu_torch.comms import CollectiveError
    from raft_tpu_torch.core.error import DeviceError
    from raft_tpu_torch.parallel import spmd

    x, y, ov, oi = data
    m = _mesh(4)
    idx = tks.prepare_knn_index_sharded(y, mesh=m, passes=3, **CFG)
    real = tks._merge_tournament
    seen = []

    def failing(comms, p, k, v, i):
        if comms.get_rank() == 2:
            raise DeviceError("rank 2 lost its link")
        try:
            return real(comms, p, k, v, i)
        except CollectiveError:
            seen.append(comms.get_rank())
            raise

    monkeypatch.setitem(tks._RANK_MERGES, "tournament", failing)
    t0 = time.monotonic()
    with pytest.raises(DeviceError, match="rank 2 lost its link"):
        spmd(m, lambda c, sh, off: tks.knn_fused_shard(
            c, x, sh, off, K, merge="tournament"),
            [(sh, r * idx.rows_per) for r, sh in enumerate(idx.shards)],
            timeout_s=30)
    assert time.monotonic() - t0 < 10
    assert sorted(seen) == [0, 1, 3]

    def lost(vs, is_, k, axis):
        raise DeviceError("rank 2's candidates lost on the way")

    monkeypatch.setitem(tks._MERGES, "tournament", lost)
    v, i = tks.knn_fused_sharded(x, idx, K, mesh=m, merge="tournament")
    _same_bits(v, i, ov, oi)
    assert any("merge:tournament->allgather" in r
               for r in degradation_reasons())


@pytest.mark.parametrize("merge", ["allgather", "tournament"])
def test_rank_local_shards_match_the_controller(data, merge):
    """The rank-local path (``prepare_knn_index_shard`` +
    ``knn_fused_shard`` in four in-process rank threads, whose merges
    are the comms collectives) gives every rank the single controller's
    bits, which are the single device's."""
    from raft_tpu_torch.parallel import spmd

    x, y, ov, oi = data

    def rank(c, r):
        shard, off = tks.prepare_knn_index_shard(y, r, 4, device="cpu",
                                                 passes=3, **CFG)
        return tks.knn_fused_shard(c, x, shard, off, K, merge=merge,
                                   micro_batches=2)

    for v, i in spmd(_mesh(4), rank, [(r,) for r in range(4)],
                     timeout_s=60):
        _same_bits(v, i, ov, oi)


def test_merge_rounds_are_counted(data):
    from raft_tpu_torch.comms import COMMS_BYTES, COMMS_CALLS

    x, y, _, _ = data
    m = _mesh(2)
    idx = tks.prepare_knn_index_sharded(y, mesh=m, passes=3, **CFG)
    tks.knn_fused_sharded(x, idx, 9, mesh=m, merge="tournament")
    tks.knn_fused_sharded(x, idx, 10, mesh=m, merge="allgather")
    reg = obs.get_registry()
    got = {(mt.name, mt.labels.get("collective")): mt.value
           for mt in reg.collect() if mt.name in (COMMS_CALLS, COMMS_BYTES)}
    assert got[COMMS_CALLS, "collective_permute"] == 2     # vals + ids
    assert got[COMMS_CALLS, "allgather"] == 2
    assert got[COMMS_BYTES, "collective_permute"] == 2 * NQ * 9 * 4


@pytest.mark.parametrize("nq,Qb", [(16, 256), (33, 32), (2048, 256),
                                   (5 * 2048, 256), (100, 8)])
def test_micro_batch_and_merge_rules_match_reference(nq, Qb):
    assert tks.default_micro_batches(nq, Qb) == \
        jks.default_micro_batches(nq, Qb)
    for merge in ("host", "allgather", "tournament"):
        for p in (2, 3, 4, 8):
            assert tks.resolve_merge_strategy(merge, p, nq, 7) == \
                jks.resolve_merge_strategy(merge, p, nq, 7)
    with pytest.raises(ValueError):
        tks.resolve_merge_strategy("bogus", 4, nq, 8)


def test_envelopes_and_errors(data):
    x, y, _, _ = data
    m = _mesh(8)
    idx = tks.prepare_knn_index_sharded(y, mesh=m, passes=3, **CFG)
    jidx = jks.prepare_knn_index_sharded(y, mesh=_jmesh(8), passes=3, **CFG)
    for fn, ix, mm in ((tks, idx, m), (jks, jidx, _jmesh(8))):
        with pytest.raises(NotImplementedError):
            fn.knn_fused_sharded(x, ix, 520, mesh=mm)
        with pytest.raises(Exception):
            fn.knn_fused_sharded(x, ix, K, mesh=mm, shard_mode="bogus")
        with pytest.raises(ValueError):
            fn.prepare_knn_index_sharded(y, mesh=mm, metric="cosine")
        lite = fn.prepare_knn_index_sharded(y, mesh=mm, passes=1,
                                            store_yp=False, **CFG)
        with pytest.raises(ValueError):
            fn.knn_fused_sharded(x, lite, K, mesh=mm, rescore=True)
    v, i = tks.knn_fused_sharded(np.zeros((0, D), np.float32), idx, K,
                                 mesh=m)
    assert v.shape == i.shape == (0, K)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_data_parallel_knn_matches_reference(metric):
    """fused_l2nn.knn_sharded (queries split, index replicated) and
    knn_index_sharded (index rows split, one allgather of the local
    top-k + pads) against the reference's, on the streamed sweep."""
    from raft_tpu.core import DeviceResources as JRes
    from raft_tpu.distance import fused_l2nn as jl2nn
    from raft_tpu_torch.core import DeviceResources
    from raft_tpu_torch.distance import fused_l2nn as tl2nn

    rng = np.random.default_rng(3)
    y = rng.normal(size=(1001, 16)).astype(np.float32)
    x = rng.normal(size=(37, 16)).astype(np.float32)
    res, jres = DeviceResources(device="cpu"), JRes(seed=0)
    for p in (2, 4):
        jd, ji = jl2nn.knn_sharded(jres, y, x, 5, mesh=_jmesh(p),
                                   metric=metric)
        d, i = tl2nn.knn_sharded(res, y, x, 5, mesh=_mesh(p), metric=metric)
        _same_as_reference(d, i, jd, ji)
        jd, ji = jl2nn.knn_index_sharded(
            jres, jl2nn.prepare_index_sharded(jres, y, _jmesh(p)), x, 5,
            mesh=_jmesh(p), metric=metric)
        idx = tl2nn.prepare_index_sharded(res, y, _mesh(p))
        d, i = tl2nn.knn_index_sharded(res, idx, x, 5, mesh=_mesh(p),
                                       metric=metric)
        _same_as_reference(d, i, jd, ji)
        np.testing.assert_array_equal(idx.rows().numpy(), y)
