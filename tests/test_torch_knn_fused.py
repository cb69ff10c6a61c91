"""Parity of the port's certified fused KNN (raft_tpu_torch.distance.
knn_fused, on the CPU through K1's twin) with the reference's
(raft_tpu.distance.knn_fused, its Pallas kernel in interpret mode).

Both packages get the same numpy data. Where the reference certifies
exactness (passes=3, and passes=1 with certify="f32") the ids must be
identical; both rescore in f32 in different summation orders, so values
agree to 1e-5 relative, and an id mismatch is allowed only at a tie, which
the test proves from the values. passes=1 with certify="kernel" is exact
w.r.t. bf16 scores only: there recall ≥ 0.99 against the reference and an
f64 oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.distance import fused_l2nn as jl2nn
from raft_tpu.distance import knn_fused as jkf
from raft_tpu_torch import distance as tdist
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.core.kvp import select_smallest
from raft_tpu_torch.distance import knn_fused as tkf
from raft_tpu_torch.matrix.select_k_slotted import lax_top_k

T, QB, G = 512, 64, 8
CASES = [(64, 8192, 128, 10), (130, 8192, 100, 64)]
MODES = [(3, "kernel"), (1, "f32"), (1, "kernel")]


def _data(Q, m, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(Q, d)).astype(np.float32),
            rng.normal(size=(m, d)).astype(np.float32))


def _oracle_ids(x, y, k):
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    d2 = (x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None] \
        - 2 * x64 @ y64.T
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def _recall(ids, ref):
    k = ref.shape[1]
    return np.mean([len(set(a) & set(b)) / k for a, b in zip(ids, ref)])


def assert_same_ids(v, i, v_ref, i_ref, rtol=1e-5, atol=0.0):
    """Values within tolerance; ids identical as sets per query, or
    different only at a tie with the k-th value."""
    np.testing.assert_allclose(v, v_ref, rtol=rtol, atol=atol)
    tol = rtol * np.abs(v_ref[:, -1]) + atol
    for q in range(i.shape[0]):
        extra = set(i[q].tolist()) - set(i_ref[q].tolist())
        if extra:
            pos = [list(i[q]).index(e) for e in extra]
            assert np.all(np.abs(v[q, pos] - v_ref[q, -1]) <= tol[q]), q


@pytest.fixture(scope="module")
def ref_runs():
    """Reference answers, once per module: {(case, mode): (vals, ids)}."""
    out = {}
    for c, (Q, m, d, k) in enumerate(CASES):
        x, y = _data(Q, m, d, 100 + c)
        for passes, certify in MODES:
            v, i = jkf.knn_fused(x, y, k=k, passes=passes, T=T, Qb=QB, g=G,
                                 certify=certify, grid_order="query")
            out[c, passes, certify] = (np.asarray(v), np.asarray(i))
    return out


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("passes,certify", MODES)
def test_knn_fused_matches_reference(ref_runs, case, passes, certify):
    Q, m, d, k = CASES[case]
    x, y = _data(Q, m, d, 100 + case)
    v, i, n_fail = tkf.knn_fused(x, y, k=k, passes=passes, T=T, g=G,
                                 certify=certify, device="cpu",
                                 with_stats=True)
    v, i = v.numpy(), i.numpy()
    assert v.shape == i.shape == (Q, k) and i.dtype == np.int32
    v_ref, i_ref = ref_runs[case, passes, certify]
    if passes == 3 or certify == "f32":
        assert_same_ids(v, i, v_ref, i_ref)
    else:
        assert _recall(i, i_ref) >= 0.99
        assert _recall(i, _oracle_ids(x, y, k)) >= 0.99
    assert 0 <= n_fail <= Q


def test_inner_product_matches_reference():
    x, y = _data(64, 8192, 128, 7)
    v_ref, i_ref = jkf.knn_fused(x, y, k=16, passes=3, T=T, Qb=QB, g=G,
                                 metric="ip", grid_order="query")
    v, i = tkf.knn_fused(x, y, k=16, passes=3, T=T, g=G, metric="ip",
                         device="cpu")
    v, i = v.numpy(), i.numpy()
    assert np.all(np.diff(v, axis=1) <= 0)           # descending x·y
    assert_same_ids(v, i, np.asarray(v_ref), np.asarray(i_ref))


def test_clustered_forces_fixup_on_both_sides():
    # near-duplicate points share buckets → the certificate fails → the
    # exact fixup runs on both sides (mirrors test_knn_fused.py's
    # test_exact_mode_clustered_forces_fixup)
    rng = np.random.default_rng(5)
    Q, m, d, k = 256, 4096, 64, 32
    base = rng.normal(size=(50, d)).astype(np.float32)
    y = base[rng.integers(0, 50, m)] + 1e-3 * rng.normal(
        size=(m, d)).astype(np.float32)
    x = base[rng.integers(0, 50, Q)] + 1e-3 * rng.normal(
        size=(Q, d)).astype(np.float32)
    jidx = jkf.prepare_knn_index(y, passes=3, T=T, Qb=QB, g=G,
                                 grid_order="query")
    xp = np.concatenate([x, np.zeros((Q, 128 - d), np.float32)], 1)
    jv, ji, j_fail, _ = jkf._knn_fused_core(
        jnp.asarray(xp), jidx.yp, jidx.y_hi, jidx.y_lo, jidx.yyh_k,
        jidx.yy_raw, k=k, T=T, Qb=QB, g=G, passes=3, metric="l2", m=m,
        pbits=jidx.pbits, with_stats=True)
    v, i, n_fail = tkf.knn_fused(x, y, k=k, passes=3, T=T, g=G,
                                 device="cpu", with_stats=True)
    assert int(j_fail) > 0 and n_fail > 0
    # the cancellation floor of expanded f32 at near-duplicates (as in
    # the reference's own test)
    scale = float(((x ** 2).sum(1)[:, None] + (y ** 2).sum(1)[None]).max())
    np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                               atol=8 * scale * 2.0 ** -24)


def test_lite_mode_matches_reference():
    x, y = _data(64, 8192, 128, 9)
    jidx = jkf.prepare_knn_index(y, passes=3, T=T, Qb=QB, g=G,
                                 store_yp=False, grid_order="query")
    v_ref, i_ref = jkf.knn_fused(x, jidx, k=10)
    idx = tkf.prepare_knn_index(y, passes=3, T=T, g=G, store_yp=False,
                                device="cpu")
    assert idx.yp is None
    v, i = tkf.knn_fused(x, idx, k=10)
    # lite values are packed kernel values with the code bits cleared:
    # within 2^(pbits−23) relative (plus f32 sum order) of each other
    assert_same_ids(v.numpy(), i.numpy(), np.asarray(v_ref),
                    np.asarray(i_ref), rtol=2.0 ** (idx.pbits - 22))


def _repeated_rows(seed, repeats):
    """8192 × 16 integer-valued rows, each of 8192 / repeats rows
    ``repeats`` times, and 48 integer queries: exact ties at the k-th
    place in most rows (at 128, a tie class spans both k and the k + 32
    nominated candidates)."""
    rng = np.random.default_rng(seed)
    u = rng.integers(-2, 3, size=(8192 // repeats, 16)).astype(np.float32)
    y = np.tile(u, (repeats, 1))[rng.permutation(8192)]
    x = rng.integers(-2, 3, size=(48, 16)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("repeats", [2, 128])
@pytest.mark.parametrize("store_yp", [False, True])
def test_exact_rows_ties_match_reference(store_yp, repeats, monkeypatch):
    # the queries whose certificate fails on the ties take the exact
    # fixup (_exact_rows): their ids must be the reference's exactly
    x, y = _repeated_rows(41, repeats)
    jidx = jkf.prepare_knn_index(y, passes=3, T=T, Qb=QB, g=G,
                                 store_yp=store_yp, grid_order="query")
    v_ref, i_ref = jkf.knn_fused(x, jidx, k=40)
    idx = tkf.prepare_knn_index(y, passes=3, T=T, g=G, store_yp=store_yp,
                                device="cpu")
    fixed = []
    exact_rows = tkf._exact_rows

    def spy(xq, index, k):
        fixed.extend(bytes(r) for r in xq[:, :x.shape[1]].numpy())
        return exact_rows(xq, index, k)

    monkeypatch.setattr(tkf, "_exact_rows", spy)
    v, i, n_fail = tkf.knn_fused(x, idx, k=40, with_stats=True)
    rows = [q for q in range(len(x)) if bytes(x[q]) in fixed]
    assert n_fail == len(fixed) == len(rows) > 0
    np.testing.assert_array_equal(i.numpy()[rows], np.asarray(i_ref)[rows])
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))


def _export(jidx):
    """A reference KnnIndex's state as numpy (what from_numpy takes)."""
    return {"yp": np.asarray(jidx.yp), "y_hi": np.asarray(jidx.y_hi),
            "y_lo": np.asarray(jidx.y_lo), "yyh_k": np.asarray(jidx.yyh_k),
            "yy_raw": np.asarray(jidx.yy_raw), "n_rows": jidx.n_rows,
            "T": jidx.T, "g": jidx.g, "passes": jidx.passes,
            "metric": jidx.metric, "d_orig": jidx.d_orig,
            "pbits": jidx.pbits}


@pytest.mark.parametrize("passes", [1, 3])
def test_index_from_reference_state(passes):
    x, y = _data(70, 6000, 100, 13)
    jidx = jkf.prepare_knn_index(y, passes=passes, T=T, Qb=QB, g=G,
                                 grid_order="query")
    idx = tkf.KnnIndex.from_numpy(_export(jidx), device="cpu")
    assert idx.y_hi.dtype == torch.bfloat16 and idx.yyh_k.ndim == 1
    mine = tkf.prepare_knn_index(y, passes=passes, T=T, g=G, device="cpu")
    torch.testing.assert_close(idx.y_hi, mine.y_hi, rtol=0, atol=0)
    torch.testing.assert_close(idx.yyh_k, mine.yyh_k)
    v_ref, i_ref = jkf.knn_fused(x, jidx, k=12, certify="f32")
    v, i = tkf.knn_fused(x, idx, k=12, certify="f32")
    assert_same_ids(v.numpy(), i.numpy(), np.asarray(v_ref),
                    np.asarray(i_ref))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_distance_knn_with_prepared_index(metric):
    x, y = _data(64, 8192, 128, 17)
    jidx = jkf.prepare_knn_index(y, passes=3, T=T, Qb=QB, g=G,
                                 grid_order="query")
    v_ref, i_ref = jl2nn.knn(JaxResources(seed=0), jidx, x, k=20,
                             metric=metric)
    idx = tdist.prepare_knn_index(y, passes=3, T=T, g=G, device="cpu")
    v, i = tdist.knn(DeviceResources(device="cpu"), idx, x, k=20,
                     metric=metric)
    assert_same_ids(v.numpy(), i.numpy(), np.asarray(v_ref),
                    np.asarray(i_ref))


def test_wide_and_unpacked_indexes_match_reference():
    """d > 512 (K1's d-chunked form) and g·T/128 past the packed envelope
    (the unpacked form) build and answer with the reference's ids."""
    x, y = _data(8, 4096, 640, 1)
    for yy, g in ((y, G), (y[:, :64], 4096)):
        xx = x[:, :yy.shape[1]]
        idx = tkf.prepare_knn_index(yy, T=T, g=g, device="cpu")
        v, i = tkf.knn_fused(xx, idx, 10)
        v_ref, i_ref = jkf.knn_fused(xx, yy, k=10, passes=3, T=T, Qb=8, g=g,
                                     grid_order="query")
        assert_same_ids(v.numpy(), i.numpy(), np.asarray(v_ref),
                        np.asarray(i_ref))


def test_pad_query_rows():
    x = torch.ones(3, 5)
    p = tkf.pad_query_rows(x, 8)
    assert p.shape == (8, 5) and torch.all(p[3:] == 0)
    assert tkf.pad_query_rows(x, 3) is x
    with pytest.raises(ValueError):
        tkf.pad_query_rows(x, 2)


def _planted_scores(seed):
    """[64, 300] f32 scores with ties across and inside every cut, ±0,
    ±inf, +NaN and −NaN (first in total order, last for torch.topk: in
    rows 13 and 17 past every cut, in rows with no other tie), rows with
    fewer finite values than the selections take, and two rows with no
    tie and no NaN (19, 21), which the f32 top-k answers alone."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 6, size=(64, 300)).astype(np.float32)
    neg_nan = np.array([0xFFC00000], dtype=np.uint32).view(np.float32)[0]
    d2[3, ::7] = -0.0
    d2[5, :] = np.inf
    d2[7, :250] = np.nan
    d2[9, ::3] = -np.inf
    d2[11, 10:20] = np.nan
    d2[13] = rng.permutation(300)       # no tie at any cut: only the
    d2[13, 299] = neg_nan               # −NaN calls for the redo
    d2[15, 100:] = neg_nan
    d2[17] = rng.permutation(300)
    d2[17, ::5] = neg_nan
    d2[19] = rng.permutation(300)       # no tie, no NaN: kept from the
    d2[21] = rng.permutation(300) - 150.0   # f32 top-k (with a −0)
    d2[21, d2[21] == 0] = -0.0
    assert np.signbit(d2[13, 299]) and np.isnan(d2[13, 299])
    return torch.from_numpy(d2)


@pytest.mark.parametrize("kk", [1, 7, 40, 300])
def test_nominate_is_smallest_k_bit_for_bit(kk):
    # the nomination of _exact_rows (the f32 top-k with its tied and NaN
    # rows redone) equals the int64-key selection
    d2 = _planted_scores(kk)
    v, pos = select_smallest(d2.clone(), kk)
    v_ref, i_ref = tkf._smallest_k(d2.clone(), None, kk)
    assert pos.dtype == torch.int64
    assert torch.equal(v.view(torch.int32), v_ref.view(torch.int32))
    assert torch.equal(pos.to(torch.int32), i_ref)


@pytest.mark.parametrize("kk", [1, 7, 40, 300])
def test_select_smallest_of_negation_is_lax_top_k(kk):
    # the streamed sweep's merge: the largest in jax.lax.top_k's order
    # are the smallest of the negation, NaNs of either sign included
    d2 = _planted_scores(kk)
    for v in (d2, -d2):
        got_v, got_p = select_smallest(-v, kk)
        want_v, want_p = lax_top_k(v, kk)
        assert torch.equal((-got_v).view(torch.int32),
                           want_v.view(torch.int32))
        assert torch.equal(got_p, want_p)
