"""Parity of the port's IVF-Flat (raft_tpu_torch.ann) with the reference's
(raft_tpu.ann, its Pallas fine scan in interpret mode on the CPU).

k-means++ draws from threefry in JAX and from a torch.Generator in the
port, so the two builds cannot agree bitwise: the reference's index is
carried across with ``IvfFlatIndex.from_numpy`` and both packages search
that one index. Both rescore ``xx + yy − 2·x·y`` in f32 in different
summation orders, so values agree to 1e-5 relative plus the cancellation
floor of that expanded form, 8·2⁻²⁴·(‖x‖² + max‖y‖²) (as in
test_torch_knn_fused.py), and an id may differ only at a tie within that
tolerance, which the test proves from the values. f32 ids are compared
position for position; int8 ids as sets, the reference's int8 contract.
The port's own build is held to the reference's recall on the same data.
"""

import numpy as np
import pytest
import torch

from raft_tpu.ann import build_ivf_flat as j_build
from raft_tpu.ann import resolve_fine_scan as j_resolve
from raft_tpu.ann import search_ivf_flat as j_search
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu_torch.ann import IvfFlatIndex, build_ivf_flat, search_ivf_flat
from raft_tpu_torch.ann import ivf_flat as tivf
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.ops import fine_scan as tfs

from _torch_threads import one_torch_thread  # noqa: F401

M, D, NQ, K, L = 8000, 32, 64, 10, 16


def _blobs(m, d, nq, seed=11):
    """``bench_ann.py``'s data recipe in numpy: imbalanced blobs with
    per-center spread, queries drawn from the rows plus N(0, 0.1) noise."""
    rng = np.random.default_rng(seed)
    nc = 32
    centers = rng.uniform(-10, 10, (nc, d)).astype(np.float32)
    std = np.linspace(0.5, 2.0, nc).astype(np.float32)
    p = rng.uniform(0.5, 2.0, nc)
    lab = rng.choice(nc, m, p=p / p.sum())
    X = (centers[lab] + rng.normal(size=(m, d)).astype(np.float32)
         * std[lab, None]).astype(np.float32)
    Q = (X[rng.choice(m, nq, replace=False)]
         + rng.normal(0, 0.1, (nq, d))).astype(np.float32)
    return X, Q


def _export(j):
    """A reference IvfFlatIndex's state as numpy (what from_numpy takes)."""
    out = {n: np.asarray(getattr(j, n)) for n in (
        "centroids", "slab", "ids", "yy_slab", "offsets", "sizes",
        "padded_sizes")}
    out.update(n_rows=j.n_rows, d_orig=j.d_orig, row_quantum=j.row_quantum,
               n_probes_default=j.n_probes_default,
               kmeans_iters=j.kmeans_iters, db_dtype=j.db_dtype)
    if j.db_dtype == "int8":
        out.update({n: np.asarray(getattr(j, n))
                    for n in ("slab_q", "row_scale", "yy_q", "eq_rows")})
    return out


@pytest.fixture(scope="module")
def world():
    X, Q = _blobs(M, D, NQ)
    jres = JaxResources(seed=7)
    jidx = {dt: j_build(jres, X, n_lists=L, max_iter=8, seed=3, db_dtype=dt)
            for dt in ("f32", "int8")}
    tidx = {dt: IvfFlatIndex.from_numpy(_export(j), device="cpu")
            for dt, j in jidx.items()}
    return X, Q, jres, jidx, tidx, DeviceResources(device="cpu")


def _assert_same(v, i, v_ref, i_ref, as_sets: bool, Q, X):
    floor = 8 * 2.0 ** -24 * ((Q * Q).sum(1) + (X * X).sum(1).max())
    tol = 1e-5 * np.abs(v_ref) + floor[:, None]
    fin = np.isfinite(v_ref)
    assert np.array_equal(fin, np.isfinite(v))
    assert np.all(np.abs(np.where(fin, v - v_ref, 0.0)) <= tol)
    tol = tol[:, -1]
    for q in range(i.shape[0]):
        if as_sets:
            extra = set(i[q].tolist()) - set(i_ref[q].tolist())
            pos = [list(i[q]).index(e) for e in extra]
        else:
            pos = np.nonzero(i[q] != i_ref[q])[0]
        # a differing id must sit at a tie, proven by the values
        for p in pos:
            near = np.abs(v_ref[q] - v[q, p]) <= tol[q]
            assert near.any(), (q, p)


def test_index_carried_across(world):
    _, _, _, jidx, tidx, _ = world
    for dt in ("f32", "int8"):
        j, t = jidx[dt], tidx[dt]
        assert t.n_lists == L and t.probe_window == j.probe_window
        assert t.slab_rows == j.slab_rows and t.db_dtype == dt
        assert torch.equal(t.ids, torch.from_numpy(np.array(j.ids)))
    assert tidx["int8"].slab_q.dtype == torch.int8


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("P", [1, 4, L - 1])
@pytest.mark.parametrize("fine_scan", ["list", "query"])
def test_search_matches_reference(world, dtype, P, fine_scan):
    X, Q, jres, jidx, tidx, res = world
    j, t = jidx[dtype], tidx[dtype]
    if fine_scan == "list":
        # outside its envelope the reference quietly runs query-major
        assert j_resolve(j, NQ, K, P, j.probe_window, "list") == "list"
        assert tivf.resolve_fine_scan(t, NQ, K, P, t.probe_window,
                                      "list") == "list"
    jv, ji = j_search(jres, j, Q, K, n_probes=P, fine_scan=fine_scan)
    before = (tfs.LAUNCHES, tfs.LAUNCHES_Q8)
    v, i, reruns = search_ivf_flat(res, t, Q, K, n_probes=P,
                                   fine_scan=fine_scan, with_stats=True)
    assert (tfs.LAUNCHES, tfs.LAUNCHES_Q8) == before     # CPU: twins only
    assert v.shape == i.shape == (NQ, K) and i.dtype == torch.int32
    assert 0 <= reruns <= NQ
    _assert_same(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji),
                 dtype == "int8", Q, X)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_degenerate_exact_matches_reference(world, dtype):
    X, Q, jres, jidx, tidx, res = world
    jv, ji = j_search(jres, jidx[dtype], Q, K, n_probes=L)
    v, i = search_ivf_flat(res, tidx[dtype], Q, K, n_probes=L,
                           fine_scan="list")
    _assert_same(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji),
                 True, Q, X)
    # the exact plane is the brute-force oracle
    d2 = ((Q.astype(np.float64)[:, None] - X[None]) ** 2).sum(2)
    oracle = np.sort(d2, 1)[:, :K]
    np.testing.assert_allclose(v.numpy(), oracle, rtol=1e-4, atol=1e-3)


def test_list_chunk_sizes_give_identical_ids(world):
    _, Q, _, _, tidx, res = world
    t = tidx["f32"]
    x = torch.from_numpy(Q)
    P, W = 4, t.probe_window
    probes = tivf._coarse_probe(res, t.centroids, x, P)
    pl = probes.long()
    starts, psizes = t.offsets[:-1][pl], t.padded_sizes[pl]
    outs = [tivf._search_list_major(t, x, probes, probes.numpy(), starts,
                                    psizes, K, P, W, 8, chunk)
            for chunk in (NQ, 24)]
    assert torch.equal(outs[0][1], outs[1][1])
    assert torch.equal(outs[0][0], outs[1][0])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("fine_scan", ["list", "query"])
def test_answers_do_not_depend_on_the_batch(world, dtype, fine_scan):
    """A query's answer has the same bits asked alone as in a batch, and
    its values are ``(xx + yy) − 2·Σ x·y`` evaluated row-wise for that
    query alone: the exact rescore takes one row-wise dot a candidate,
    never a batched product whose rounding follows the batch's shape (on
    the card, a served answer padded to its bucket differed from the same
    query asked alone). f32 answers have the same bits under both
    schedules."""
    _, Q, _, _, tidx, res = world
    t = tidx[dtype]
    x = torch.from_numpy(Q)
    v, i = search_ivf_flat(res, t, x, K, n_probes=4, fine_scan=fine_scan)
    live = t.ids >= 0
    row_of = torch.full((t.n_rows,), -1, dtype=torch.long)
    row_of[t.ids[live].long()] = torch.nonzero(live).squeeze(1)
    for q in range(0, NQ, 7):
        xq = x[q:q + 1]
        vq, iq = search_ivf_flat(res, t, xq, K, n_probes=4,
                                 fine_scan=fine_scan)
        assert torch.equal(vq[0], v[q]) and torch.equal(iq[0], i[q])
        r = row_of[i[q].long()]
        dot = (t.slab[r][None] * xq[:, None, :]).sum(2)
        d2 = ((xq * xq).sum(1, keepdim=True) + t.yy_slab[r][None]) \
            - 2.0 * dot
        assert torch.equal(d2.clamp_min(0.0)[0], v[q]), q
    if dtype == "f32":
        other = "query" if fine_scan == "list" else "list"
        v2, i2 = search_ivf_flat(res, t, x, K, n_probes=4, fine_scan=other)
        assert torch.equal(v, v2) and torch.equal(i, i2)


def test_port_build_recall_matches_reference(world):
    """The port builds its own index (torch k-means++) and reaches the
    reference build's recall at P=4, less 0.02."""
    X, Q, jres, jidx, _, res = world
    d2 = ((Q.astype(np.float64)[:, None] - X[None]) ** 2).sum(2)
    oracle = np.argsort(d2, 1)[:, :K]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K
                        for a, b in zip(np.asarray(ids), oracle)])

    idx = build_ivf_flat(res, X, n_lists=L, max_iter=8, seed=3)
    assert idx.device.type == "cpu" and idx.n_rows == M
    assert int(idx.sizes.sum()) == M
    assert torch.equal(torch.sort(idx.ids[idx.ids >= 0]).values,
                       torch.arange(M, dtype=torch.int32))
    _, i = search_ivf_flat(res, idx, Q, K, n_probes=4, fine_scan="query")
    _, ji = j_search(jres, jidx["f32"], Q, K, n_probes=4, fine_scan="query")
    assert recall(i) >= recall(ji) - 0.02


def test_int8_build_shares_the_f32_lists(world):
    X, Q, _, _, _, res = world
    a = build_ivf_flat(res, X[:3000], n_lists=8, max_iter=4, seed=5)
    b = build_ivf_flat(res, X[:3000], n_lists=8, max_iter=4, seed=5,
                       db_dtype="int8")
    assert torch.equal(a.offsets, b.offsets) and torch.equal(a.ids, b.ids)
    assert b.slab_q.dtype == torch.int8
    deq = b.slab_q.float() * b.row_scale[:, None]
    err = (deq - b.slab).norm(dim=1)
    assert torch.all(err <= b.eq_rows + 1e-6)
    # one id set, f32 and int8, whichever schedule
    _, i32 = search_ivf_flat(res, a, Q, K, n_probes=3, fine_scan="list")
    _, i8 = search_ivf_flat(res, b, Q, K, n_probes=3, fine_scan="list")
    assert all(set(p) == set(q) for p, q in zip(i32.tolist(), i8.tolist()))


def test_resolve_and_validation(world):
    _, Q, _, _, tidx, res = world
    t = tidx["f32"]
    W = t.probe_window
    assert tivf.resolve_fine_scan(t, NQ, 200, 4, W, "list") == "query"
    assert tivf.resolve_fine_scan(t, NQ, K, 4, W, "query") == "query"
    assert tivf.resolve_fine_scan(t, NQ, K, 4, W) in ("list", "query")
    with pytest.raises(ValueError):
        tivf.resolve_fine_scan(t, NQ, K, 4, W, "bogus")
    v, i = search_ivf_flat(res, t, Q[:0], K)
    assert v.shape == (0, K) and i.shape == (0, K)
    with pytest.raises(Exception):
        search_ivf_flat(res, t, Q[:, :8], K)
