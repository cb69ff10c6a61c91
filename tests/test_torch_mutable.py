"""The port's mutable index (raft_tpu_torch.mutable) against the
reference's (raft_tpu.mutable) on the CPU, at the reference test's sizes
(tests/test_mutable.py: D = 16, K = 5, T = 256, g = 2, 320 base rows,
compaction threshold 48).

The same seeded numpy rows and the same operation sequence go through both
packages; the port runs on ``device="cpu"`` with its twins. At every
generation the ids must equal the reference's element for element, the
values agree within 1e-5 (the reference's own ``_assert_parity``
tolerance) and ``stats()`` match key for key. Threads are joined in a
``finally`` and every wait has a timeout.
"""

import threading
import time

import numpy as np
import pytest
import torch

import raft_tpu.mutable as jm
from raft_tpu.ann import build_ivf_flat as j_build_flat
from raft_tpu.ann import build_ivf_pq as j_build_pq
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu_torch.ann import IvfFlatIndex, IvfPqIndex
from raft_tpu_torch.core import LogicError
from raft_tpu_torch.mutable import (MutableIndex, apply_delete, apply_upsert,
                                    dense_layout, fused_ops_for_layout,
                                    run_fused_ops, search_view)

from _torch_threads import one_torch_thread  # noqa: F401

D, K = 16, 5
CFG = dict(passes=3, T=256, Qb=32, g=2)
PLANES = ("brute_f32", "brute_int8", "ivf_flat", "ivf_pq")
WAIT = 60


def _kw(plane):
    if plane == "brute_f32":
        return dict(CFG)
    if plane == "brute_int8":
        return dict(CFG, db_dtype="int8")
    if plane == "ivf_flat":
        return dict(algorithm="ivf_flat", n_lists=8)
    return dict(algorithm="ivf_pq", n_lists=8, pq_bits=8)


def _pair(plane, y, threshold=48, auto=False, **kw):
    """(port, reference) mutable indexes over the same rows."""
    kw = dict(_kw(plane), compact_threshold=threshold, auto_compact=auto,
              **kw)
    return (MutableIndex(y, device="cpu", **kw),
            jm.MutableIndex(y, **kw))


def _same(t, j, x, k=K, exact=False, n_probes=None):
    """The port's answer equals the reference's: ids element for element,
    values within 1e-5; returns the port's (vals, ids) as numpy."""
    tv, ti = search_view(t, x, k, exact=exact, n_probes=n_probes)
    jv, ji = jm.search_view(j, x, k, exact=exact, n_probes=n_probes)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-5, atol=1e-5)
    return tv, ti


def _upsert(pair, ids, rows):
    t, j = pair
    assert apply_upsert(t, ids, rows) == jm.apply_upsert(j, ids, rows)


def _delete(pair, ids):
    t, j = pair
    assert apply_delete(t, ids) == jm.apply_delete(j, ids)


def _stats_equal(t, j):
    assert t.stats() == j.stats()


@pytest.mark.parametrize("plane", PLANES)
def test_every_generation_matches_reference(plane):
    """Upsert, delete, overwrite (a base row, a delta row, a deleted id
    brought back), delete of a delta row, compaction, then churn after it:
    ids, values and stats equal the reference's after every step. The IVF
    planes are held on their exact scan (their rebuilt lists come from
    each package's own k-means)."""
    rng = np.random.default_rng(23)
    y = rng.normal(size=(320, D)).astype(np.float32)
    x = rng.normal(size=(7, D)).astype(np.float32)
    pair = _pair(plane, y)
    t, j = pair
    exact = plane.startswith("ivf")

    def step():
        _same(t, j, x, exact=exact)
        _stats_equal(t, j)

    step()
    _delete(pair, [0, 17, 31, 200])
    step()
    _upsert(pair, np.arange(1000, 1020),
            rng.normal(size=(20, D)).astype(np.float32))
    step()
    _upsert(pair, np.array([5, 1000, 17]),
            rng.normal(size=(3, D)).astype(np.float32))
    step()
    _delete(pair, [1001])
    step()
    g0 = t.generation
    assert t.compact(block=True) and j.compact(block=True)
    assert t.generation > g0
    st = t.stats()
    assert st["delta_rows"] == 0 and st["tombstones"] == 0
    step()
    _upsert(pair, np.array([1000, 2000]),
            rng.normal(size=(2, D)).astype(np.float32))
    _delete(pair, [5])
    step()


def _export_flat(j):
    out = {n: np.asarray(getattr(j, n)) for n in (
        "centroids", "slab", "ids", "yy_slab", "offsets", "sizes",
        "padded_sizes")}
    out.update(n_rows=j.n_rows, d_orig=j.d_orig, row_quantum=j.row_quantum,
               n_probes_default=j.n_probes_default,
               kmeans_iters=j.kmeans_iters, db_dtype=j.db_dtype)
    return out


def _export_pq(j):
    out = _export_flat(j)
    out.update({n: np.asarray(getattr(j, n)) for n in (
        "codebooks", "codes", "yy_pq", "pq_eq_rows", "pq_eq_sub",
        "pq_eq_list", "pq_rhat_list", "pq_eq_qlist")})
    out.update(pq_dim=j.pq_dim, pq_bits=j.pq_bits, pq_mode=j.pq_mode,
               pq_resid_med=j.pq_resid_med,
               pq_rot=None if j.pq_rot is None else np.asarray(j.pq_rot))
    return out


@pytest.fixture(scope="module")
def carried():
    """One reference IVF-Flat and one IVF-PQ index over 400 rows, carried
    into the port: both packages then probe the same lists."""
    rng = np.random.default_rng(31)
    y = rng.normal(size=(400, D)).astype(np.float32)
    jres = JaxResources(seed=4)
    jf = j_build_flat(jres, y, n_lists=8, max_iter=5, seed=1)
    jp = j_build_pq(jres, y, n_lists=8, pq_bits=8, max_iter=5, seed=1)
    return {"ivf_flat": (jf, IvfFlatIndex.from_numpy(_export_flat(jf),
                                                     device="cpu")),
            "ivf_pq": (jp, IvfPqIndex.from_numpy(_export_pq(jp),
                                                 device="cpu"))}


@pytest.mark.parametrize("plane", ("ivf_flat", "ivf_pq"))
def test_probed_path_matches_reference_and_masks_deletes(carried, plane):
    """Over one carried-over index, the probed path (the masked
    query-major scan, or K5's ADC scan with the masked ids and its masked
    f32 reruns) gives the reference's ids element for element, and never
    returns a deleted id; full probing is the exact oracle."""
    jidx, tidx = carried[plane]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(9, D)).astype(np.float32)
    t = MutableIndex(tidx, algorithm=plane, compact_threshold=48,
                     auto_compact=False)
    j = jm.MutableIndex(jidx, algorithm=plane, compact_threshold=48,
                        auto_compact=False)
    pair = (t, j)
    dels = list(range(0, 40))
    _delete(pair, dels)
    _upsert(pair, np.arange(900, 910),
            rng.normal(size=(10, D)).astype(np.float32))
    for P in (3, 6):
        _, ti = _same(t, j, x, n_probes=P)
        assert not set(ti.ravel().tolist()) & set(dels)
    _same(t, j, x, n_probes=8)
    _stats_equal(t, j)


def test_tied_rows_merge_base_first():
    """Duplicated rows in the base and in the delta: every tie in the
    two-slab merge breaks as the reference's does (the base pool before
    the delta pool, a lower position first)."""
    rng = np.random.default_rng(3)
    y = rng.normal(size=(64, D)).astype(np.float32)
    y[10] = y[3]
    y[40] = y[3]                      # three equal base rows
    pair = _pair("brute_f32", y)
    t, j = pair
    # the same row again in the delta, twice, and a copy of another row
    _upsert(pair, np.array([500, 501, 502]),
            np.stack([y[3], y[3], y[7]]).astype(np.float32))
    x = np.stack([y[3], y[7], y[3] + 0.01]).astype(np.float32)
    _, ti = _same(t, j, x, k=8)
    assert ti[0, :3].tolist() == [3, 10, 40]
    assert ti[0, 3:5].tolist() == [500, 501]


def test_old_view_answers_as_before():
    """A view taken before a delete answers as it did: a tombstone clones
    the mask and carrier, never writes into a published tensor."""
    rng = np.random.default_rng(8)
    y = rng.normal(size=(128, D)).astype(np.float32)
    x = y[:4] + 0.001
    t = MutableIndex(y, device="cpu", compact_threshold=48,
                     auto_compact=False, **CFG)
    old = t.view()
    held = (old.base_rv.clone(), old.base_yyh.clone())
    v0, i0 = search_view(t, x, K, view=old)
    apply_delete(t, [0, 1, 2, 3])
    v1, i1 = search_view(t, x, K, view=old)
    assert torch.equal(v0, v1) and torch.equal(i0, i1)
    assert torch.equal(old.base_rv, held[0])
    assert torch.equal(old.base_yyh, held[1])
    _, inew = search_view(t, x, K)
    assert not set(inew.numpy().ravel().tolist()) & {0, 1, 2, 3}


@pytest.mark.parametrize("plane", ("brute_f32", "brute_int8", "ivf_flat"))
def test_short_rows_pad_never_tombstoned(plane):
    """k past the live rows: (inf, −1) pads, never a tombstoned id, as the
    reference gives."""
    rng = np.random.default_rng(11)
    y = rng.normal(size=(16, D)).astype(np.float32)
    kw = dict(_kw(plane), compact_threshold=48, auto_compact=False)
    if plane == "ivf_flat":
        kw["n_lists"] = 2
    t = MutableIndex(y, device="cpu", **kw)
    j = jm.MutableIndex(y, **kw)
    _delete((t, j), list(range(12)))
    _upsert((t, j), np.array([99]),
            rng.normal(size=(1, D)).astype(np.float32))
    x = rng.normal(size=(3, D)).astype(np.float32)
    tv, ti = _same(t, j, x, k=8, exact=plane == "ivf_flat")
    assert (ti[:, 5:] == -1).all() and np.isinf(tv[:, 5:]).all()
    assert not set(ti.ravel().tolist()) & set(range(12))


@pytest.mark.parametrize("inf", (np.inf, -np.inf), ids=("pinf", "ninf"))
@pytest.mark.parametrize("where", ("base_f32", "base_int8", "delta_f32",
                                   "delta_ivf_flat"))
def test_inf_row_answers_as_reference(where, inf):
    """A row that holds ±inf, in the base or upserted into the delta: it
    scores NaN or +inf for every query, fails the certificate, and the
    reference's fixup answers (−1, NaN) where it ranks the NaN first. The
    port gives the same entries, and drops none (the IVF base searched on
    its exact scan)."""
    rng = np.random.default_rng(29)
    y = rng.normal(size=(96, D)).astype(np.float32)
    x = rng.normal(size=(5, D)).astype(np.float32)
    plane = {"base_f32": "brute_f32", "base_int8": "brute_int8",
             "delta_f32": "brute_f32", "delta_ivf_flat": "ivf_flat"}[where]
    bad = rng.normal(size=(1, D)).astype(np.float32)
    bad[0, 3] = inf
    if where.startswith("base"):
        y[7] = bad[0]
    pair = _pair(plane, y)
    t, j = pair
    if where.startswith("delta"):
        _upsert(pair, np.array([500]), bad)
    tv, ti = _same(t, j, x, k=6, exact=plane == "ivf_flat")
    nan = np.isnan(tv)
    assert nan.any()                  # the row is in the answer ...
    assert (ti[nan] == -1).all()      # ... as the reference's (−1, NaN)


def test_run_fused_ops_masks_short_rows_to_minus_one():
    """The layout search keeps the reference's pos = −1 wherever the value
    is not finite: a masked slab short of k never names a masked row."""
    rng = np.random.default_rng(2)
    y = rng.normal(size=(20, D)).astype(np.float32)
    valid = np.zeros(20, bool)
    valid[[2, 5, 9]] = True
    for dt in (None, "int8"):
        lay = dense_layout(y, rows_valid=valid)
        fops = fused_ops_for_layout(lay, T=256, g=2, db_dtype=dt)
        vals, pos, _ = run_fused_ops(fops, torch.from_numpy(y[:4]), 6)
        assert (pos[:, 3:] == -1).all()
        assert torch.isinf(vals[:, 3:]).all()
        assert set(pos[:, :3].flatten().tolist()) <= {2, 5, 9}


def test_dense_layout_matches_reference():
    rng = np.random.default_rng(4)
    y = rng.normal(size=(13, D)).astype(np.float32)
    ids = np.arange(100, 113, dtype=np.int32)
    valid = rng.random(13) > 0.3
    t = dense_layout(y, ids=ids, rows_valid=valid)
    j = jm.dense_layout(y, ids=ids, rows_valid=valid)
    np.testing.assert_array_equal(t.slab.numpy(), j.slab)
    np.testing.assert_array_equal(t.ids.numpy(), j.ids)
    np.testing.assert_array_equal(t.rows_valid.numpy(), j.rows_valid)
    assert t.n_rows == j.n_rows and t.slab_rows == j.slab_rows


def _raises_both(fn_t, fn_j):
    with pytest.raises(LogicError):
        fn_t()
    from raft_tpu.core.error import LogicError as JLogicError

    with pytest.raises(JLogicError):
        fn_j()


def test_apply_validation_matches_reference():
    """Shapes, negative ids, duplicates in one batch and an upsert past the
    delta cap are refused as the reference refuses them, before any state
    changes."""
    rng = np.random.default_rng(6)
    y = rng.normal(size=(64, D)).astype(np.float32)
    t, j = _pair("brute_f32", y, threshold=16, delta_cap=16)
    row = rng.normal(size=(1, D)).astype(np.float32)
    cases = [
        ([1], rng.normal(size=(1, D + 1)).astype(np.float32)),
        ([1, 2], row),
        ([-3], row),
        ([4, 4], np.concatenate([row, row])),
        (np.arange(100, 117), rng.normal(size=(17, D)).astype(np.float32)),
    ]
    for ids, rows in cases:
        _raises_both(lambda: apply_upsert(t, ids, rows),
                     lambda: jm.apply_upsert(j, ids, rows))
    _stats_equal(t, j)
    assert t.stats()["seq"] == 0
    with pytest.raises(LogicError):
        MutableIndex(y, ids=np.zeros(64, np.int32), device="cpu", **CFG)
    with pytest.raises(LogicError):
        MutableIndex(y, metric="ip", device="cpu", **CFG)


def test_query_races_compaction_swap():
    """Readers hammering the index while a fold runs and swaps each see
    one generation; a fold does not change the content, so every answer is
    the reference's."""
    rng = np.random.default_rng(13)
    y = rng.normal(size=(512, D)).astype(np.float32)
    x = rng.normal(size=(6, D)).astype(np.float32)
    t, j = _pair("brute_f32", y, threshold=64)
    _upsert((t, j), np.arange(3000, 3070),
            rng.normal(size=(70, D)).astype(np.float32))
    jv, ji = jm.search_view(j, x, K)
    results, errors = [], []

    def reader():
        try:
            for _ in range(8):
                v, i = search_view(t, x, K)
                results.append((v.numpy(), i.numpy()))
        except Exception as e:                    # pragma: no cover
            errors.append(repr(e))

    threads = [threading.Thread(target=reader) for _ in range(3)]
    try:
        for th in threads:
            th.start()
        assert t.compact(block=True)
    finally:
        for th in threads:
            th.join(WAIT)
    assert not errors and len(results) == 24
    for v, i in results:
        np.testing.assert_array_equal(i, np.asarray(ji))
        np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5, atol=1e-5)


def test_reader_and_writer_complete_while_fold_in_flight():
    """The fold's rebuild is held on a gate while a read and a write both
    complete (readers never wait on the compactor); the mid-fold delete
    survives the rebase onto the new base."""
    rng = np.random.default_rng(17)
    y = rng.normal(size=(256, D)).astype(np.float32)
    x = rng.normal(size=(4, D)).astype(np.float32)
    t, j = _pair("brute_f32", y)
    _upsert((t, j), np.arange(4000, 4020),
            rng.normal(size=(20, D)).astype(np.float32))
    gate = threading.Event()
    inner = t._build_index

    def held_build(yy):
        assert gate.wait(timeout=WAIT)
        return inner(yy)

    t._build_index = held_build
    try:
        assert t.compact(block=False)
        t0 = time.monotonic()
        while not t.folding and time.monotonic() - t0 < 10:
            time.sleep(0.001)
        assert t.folding
        _same(t, j, x)
        _delete((t, j), [4000])
        _same(t, j, x)
    finally:
        gate.set()
        t._build_index = inner
        t.wait_for_compaction(timeout=WAIT)
    assert t.compactions == 1 and not t.folding
    assert j.compact(block=True)
    _same(t, j, x)
    # the folded copy of 4000 was tombstoned in the new base at the swap
    assert t.stats()["tombstones"] == 1


def test_writer_at_delta_cap_waits_for_fold():
    """Crossing the watermark starts the background fold; a writer that
    fills the delta cap waits for it (or folds inline) rather than fail,
    and the answers stay the reference's."""
    rng = np.random.default_rng(19)
    y = rng.normal(size=(256, D)).astype(np.float32)
    t, j = _pair("brute_f32", y, threshold=32, auto=True, delta_cap=64)
    try:
        for b in range(6):                   # 6 × 16 = 96 rows > the cap
            ids = np.arange(5000 + 16 * b, 5000 + 16 * (b + 1))
            rows = rng.normal(size=(16, D)).astype(np.float32)
            _upsert((t, j), ids, rows)
    finally:
        t.wait_for_compaction(timeout=WAIT)
        j.wait_for_compaction(timeout=WAIT)
    assert t.compactions >= 1
    _same(t, j, rng.normal(size=(5, D)).astype(np.float32))


def test_prepared_index_wrapped_and_validated():
    """A prepared KnnIndex is wrapped as its base (its rows are the fold
    source); an IVF index offered as brute, or a lite index, is refused."""
    from raft_tpu_torch.distance.knn_fused import prepare_knn_index

    rng = np.random.default_rng(21)
    y = rng.normal(size=(96, D)).astype(np.float32)
    idx = prepare_knn_index(y, device="cpu", **{k: v for k, v in CFG.items()
                                               if k != "Qb"})
    t = MutableIndex(idx, compact_threshold=48, auto_compact=False)
    j = jm.MutableIndex(y, compact_threshold=48, auto_compact=False, **CFG)
    x = rng.normal(size=(3, D)).astype(np.float32)
    _delete((t, j), [1, 2])
    _same(t, j, x)
    lite = prepare_knn_index(y, device="cpu", store_yp=False, T=256, g=2)
    with pytest.raises(LogicError):
        MutableIndex(lite)
    with pytest.raises(LogicError):
        MutableIndex(idx, algorithm="ivf_flat")
