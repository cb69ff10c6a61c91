"""Parity of the port's IVF-PQ (raft_tpu_torch.ann.ivf_pq) with the
reference's (raft_tpu.ann.ivf_pq, its Pallas ADC kernel in interpret mode on
the CPU), at the reference test's shape (tests/test_ivf_pq.py: 96 groups ×
12 near-duplicates in d=16, 96 lists, 40 queries).

k-means++ draws from threefry in JAX and from a torch.Generator in the
port, so the builds cannot agree bitwise: each reference index is carried
across with ``IvfPqIndex.from_numpy`` and both packages search that index.
Both return exact f32 distances after the rescore, in different summation
orders: values agree to 1e-5 relative plus 8·2⁻²⁴·(‖x‖² + max‖y‖²) (as in
test_torch_ivf_flat.py), and an id may differ only at a tie within that
tolerance, which the test proves from the values. The encode step is held
to the reference's codes given the reference's codebooks and rotation.
"""

import numpy as np
import pytest
import torch

from raft_tpu.ann import build_ivf_pq as j_build
from raft_tpu.ann import pack_pq_codes as j_pack
from raft_tpu.ann import resolve_pq_scan as j_resolve
from raft_tpu.ann import search_ivf_flat as j_search_flat
from raft_tpu.ann import search_ivf_pq as j_search
from raft_tpu.ann import unpack_pq_codes as j_unpack
from raft_tpu.ann import ivf_pq as jpq_mod
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu_torch.ann import (IvfFlatIndex, IvfPqIndex, build_ivf_pq,
                                pack_pq_codes, resolve_pq_scan,
                                search_ivf_flat, search_ivf_pq,
                                unpack_pq_codes, warm_pq_scan)
from raft_tpu_torch.ann import build_ivf_flat
from raft_tpu_torch.ann import ivf_flat as tivf
from raft_tpu_torch.ann import ivf_pq as tpq
from raft_tpu_torch.core import DeviceError, DeviceResources, LogicError, env
from raft_tpu_torch.observability import quality
from raft_tpu_torch.ops import pq_scan as k5

from _torch_threads import one_torch_thread  # noqa: F401

G, GS, D, NQ, L, K, P = 96, 12, 16, 40, 96, 6, 4
BUILDS = [("plain", 8), ("plain", 4), ("opq", 8), ("opq", 4),
          ("opq_aniso", 8), ("opq_aniso", 4)]


def _dup_data(G=G, g=GS, d=D, sep=4.0, jitter=0.05, seed=7):
    """The reference test's near-duplicate data: G separated base points,
    each repeated g times with a small jitter."""
    r = np.random.default_rng(seed)
    base = r.normal(0, sep, (G, d)).astype(np.float32)
    X = (np.repeat(base, g, axis=0)
         + r.normal(0, jitter, (G * g, d))).astype(np.float32)
    return base, X[r.permutation(G * g)]


def export(j) -> dict:
    """A reference IvfPqIndex's state as numpy (what from_numpy takes)."""
    out = {n: np.asarray(getattr(j, n)) for n in (
        "centroids", "slab", "ids", "yy_slab", "offsets", "sizes",
        "padded_sizes", "codebooks", "codes", "yy_pq", "pq_eq_rows",
        "pq_eq_sub", "pq_eq_list", "pq_rhat_list", "pq_eq_qlist")}
    out.update(n_rows=j.n_rows, d_orig=j.d_orig, row_quantum=j.row_quantum,
               n_probes_default=j.n_probes_default,
               kmeans_iters=j.kmeans_iters, db_dtype=j.db_dtype,
               pq_dim=j.pq_dim, pq_bits=j.pq_bits, pq_mode=j.pq_mode,
               pq_resid_med=j.pq_resid_med,
               pq_rot=None if j.pq_rot is None else np.asarray(j.pq_rot))
    return out


@pytest.fixture(scope="module")
def world():
    base, X = _dup_data()
    r = np.random.default_rng(3)
    Q = (base[r.choice(G, NQ, replace=False)]
         + r.normal(0, 0.02, (NQ, D))).astype(np.float32)
    jres = JaxResources(seed=5)
    jidx = {b: j_build(jres, X, n_lists=L, pq_bits=b[1], max_iter=5,
                       seed=2, pq_mode=b[0]) for b in BUILDS}
    tidx = {b: IvfPqIndex.from_numpy(export(j), device="cpu")
            for b, j in jidx.items()}
    return X, Q, jres, jidx, tidx, DeviceResources(device="cpu")


@pytest.fixture(autouse=True)
def _clean_counters():
    from raft_tpu.observability import quality as jquality

    quality.clear()
    jquality.clear()
    yield
    quality.clear()
    jquality.clear()


def _assert_same(v, i, v_ref, i_ref, Q, X):
    floor = 8 * 2.0 ** -24 * ((Q * Q).sum(1) + (X * X).sum(1).max())
    tol = 1e-5 * np.abs(v_ref) + floor[:, None]
    fin = np.isfinite(v_ref)
    assert np.array_equal(fin, np.isfinite(v))
    diff = np.where(fin, v, 0.0) - np.where(fin, v_ref, 0.0)
    assert np.all(np.abs(diff) <= tol)
    for q in range(i.shape[0]):
        for p in np.nonzero(i[q] != i_ref[q])[0]:
            # a differing id must sit at a tie, proven by the values
            assert (np.abs(v_ref[q] - v[q, p]) <= tol[q, -1]).any(), (q, p)


def _sets(ids):
    return [set(int(v) for v in row if v >= 0) for row in np.asarray(ids)]


# ------------------------------------------------------------ packing
@pytest.mark.parametrize("bits", [8, 4])
def test_pack_unpack_match_reference(bits):
    codes = np.random.default_rng(1).integers(0, 1 << bits, (37, 6))
    packed = pack_pq_codes(codes, bits)
    assert packed.dtype == torch.int8
    assert np.array_equal(packed.numpy(), np.asarray(j_pack(codes, bits)))
    back = unpack_pq_codes(packed, 6, bits).numpy()
    assert np.array_equal(back, codes)
    assert np.array_equal(back, j_unpack(np.asarray(j_pack(codes, bits)),
                                         6, bits))
    with pytest.raises(LogicError):
        pack_pq_codes(codes[:, :5], 4)


# --------------------------------------------------- the encode step
def _near_tie(sub, books, a, b, aniso):
    """The two codewords score within f32 rounding of each other for the
    (rotated) residual subvector ``sub`` (f64), under the mode's loss."""
    def loss(c):
        e = sub - books[c]
        out = e @ e
        if aniso:
            rn = np.sqrt(sub @ sub)
            if rn > 0:
                out += (tpq._PQ_ANISO_ETA - 1.0) * (e @ sub / rn) ** 2
        return out
    la, lb = loss(a), loss(b)
    return abs(la - lb) <= 1e-5 * max(la, lb, sub @ sub) + 1e-7


@pytest.mark.parametrize("build", BUILDS, ids=[f"{m}-{b}" for m, b in BUILDS])
def test_encode_matches_reference(world, build):
    X, _, _, jidx, tidx, res = world
    j, t = jidx[build], tidx[build]
    flat = IvfFlatIndex.from_numpy(export(j), device="cpu")
    rot = None if j.pq_rot is None else torch.from_numpy(
        np.asarray(j.pq_rot))
    books = torch.from_numpy(np.asarray(j.codebooks))
    got = tpq._pq_encode(res, flat, books, rot, j.pq_bits, j.pq_mode)
    S, dsub = j.pq_dim, j.dsub
    codes = unpack_pq_codes(got["codes"], S, j.pq_bits).numpy()
    ref = j_unpack(np.asarray(j.codes), S, j.pq_bits)
    slab = np.asarray(j.slab, np.float64)
    valid = np.asarray(j.ids) >= 0
    gid = np.repeat(np.arange(j.n_lists), np.asarray(j.padded_sizes))
    resid = slab - np.asarray(j.centroids, np.float64)[gid]
    if rot is not None:
        resid = resid @ np.asarray(j.pq_rot, np.float64)
    cb64 = np.asarray(j.codebooks, np.float64)
    rows, subs = np.nonzero(codes != ref)
    for r_, s in zip(rows, subs):
        assert _near_tie(resid[r_, s * dsub:(s + 1) * dsub], cb64[s],
                         codes[r_, s], ref[r_, s],
                         j.pq_mode == "opq_aniso"), (r_, s)
    assert rows.size <= 0.01 * codes.size
    # the recorded envelopes, within the f32 rounding of sums in another
    # order: relative 1e-5 plus 2⁻¹⁸ of the row's magnitude ‖y‖ + ‖ŷ‖
    same = ~np.isin(np.arange(codes.shape[0]), rows)
    mag = np.sqrt((slab ** 2).sum(1)) + np.sqrt(np.asarray(j.yy_pq)[:, 0])
    for name, scale in (("yy_pq", mag ** 2), ("pq_eq_rows", mag)):
        a = got[name].reshape(-1).numpy()[same]
        b = np.asarray(getattr(j, name)).reshape(-1)[same]
        np.testing.assert_array_less(
            np.abs(a - b), 1e-5 * np.abs(b) + 2.0 ** -18 * scale[same]
            + 1e-12)
    big = mag.max()
    for name in ("pq_eq_sub", "pq_eq_list", "pq_rhat_list", "pq_eq_qlist"):
        a = np.asarray(got[name], np.float64)
        b = np.asarray(getattr(j, name), np.float64)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2.0 ** -18 * big,
                                   err_msg=name)
    assert abs(got["pq_resid_med"] - j.pq_resid_med) <= 1e-6 * max(
        1.0, j.pq_resid_med)
    # the index carried across holds the reference's sidecar unchanged
    assert torch.equal(t.codes, torch.from_numpy(np.asarray(j.codes)))
    assert t.code_bytes == (S if j.pq_bits == 8 else S // 2)
    lay = t.layout()
    assert lay.pq_codes is t.codes and lay.pq_meta["pq_bits"] == j.pq_bits


# ---------------------------------------------------------- searching
@pytest.mark.parametrize("build", BUILDS, ids=[f"{m}-{b}" for m, b in BUILDS])
@pytest.mark.parametrize("scan", ["pq", "flat", "auto"])
def test_search_matches_reference(world, build, scan):
    X, Q, jres, jidx, tidx, res = world
    j, t = jidx[build], tidx[build]
    W = t.probe_window
    assert resolve_pq_scan(t, NQ, K, P, W, scan) == j_resolve(
        j, NQ, K, P, W, scan)
    jv, ji = j_search(jres, j, Q, K, n_probes=P, pq_scan=scan)
    before = (k5.LAUNCHES_8BIT, k5.LAUNCHES_4BIT)
    v, i = search_ivf_pq(res, t, Q, K, n_probes=P, pq_scan=scan)
    assert (k5.LAUNCHES_8BIT, k5.LAUNCHES_4BIT) == before   # CPU: the twin
    assert v.shape == i.shape == (NQ, K) and i.dtype == torch.int32
    _assert_same(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji), Q, X)
    # the certified contract: the flat scan's id sets over the same probes
    _, fi = search_ivf_flat(res, t, Q, K, n_probes=P, fine_scan="query")
    assert _sets(i) == _sets(fi)


@pytest.mark.parametrize("build", [("plain", 8), ("opq", 4)],
                         ids=["plain-8", "opq-4"])
def test_exact_degrade_matches_reference(world, build):
    X, Q, jres, jidx, tidx, res = world
    jv, ji = j_search(jres, jidx[build], Q, K, n_probes=L)
    v, i, n_fix = search_ivf_pq(res, tidx[build], Q, K, n_probes=L,
                                with_stats=True)
    _assert_same(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji), Q, X)
    d2 = ((Q.astype(np.float64)[:, None] - X[None]) ** 2).sum(2)
    np.testing.assert_allclose(v.numpy(), np.sort(d2, 1)[:, :K], rtol=1e-4,
                               atol=1e-3)
    # k past the probed capacity takes the same plane
    W = tidx[build].probe_window
    v2, _ = search_ivf_pq(res, tidx[build], Q[:4], W + 1, n_probes=1)
    assert v2.shape == (4, W + 1)


def test_empty_batch_and_validation(world):
    _, Q, _, _, tidx, res = world
    t = tidx[("plain", 8)]
    v, i = search_ivf_pq(res, t, Q[:0], K)
    assert v.shape == i.shape == (0, K)
    with pytest.raises(LogicError):
        search_ivf_pq(res, t, Q[:, :8], K)
    with pytest.raises(LogicError):
        search_ivf_pq(res, IvfFlatIndex.from_numpy(
            export(world[3][("plain", 8)]), device="cpu"), Q, K)
    with pytest.raises(ValueError):
        search_ivf_pq(res, t, Q, K, n_probes=P, pq_scan="bogus")


# ------------------------------------------------ the certificate ladder
@pytest.mark.parametrize("build", [("plain", 8), ("opq_aniso", 4)],
                         ids=["plain-8", "opq_aniso-4"])
def test_widen_rung_resolves_failures(world, build, monkeypatch):
    """The base pool's certificate forced to fail: the 512-slot re-run
    certifies every query, and the ids stay the flat scan's."""
    _, Q, _, _, tidx, res = world
    t = tidx[build]
    depths = []
    real = tpq._pq_certify

    def certify(bound, theta, widen):
        depths.append(1)
        return real(bound, theta, widen) & (len(depths) > 1)

    monkeypatch.setattr(tpq, "_pq_certify", certify)
    v, i, n_rerun = search_ivf_pq(res, t, Q, K, n_probes=P, pq_scan="pq",
                                  with_stats=True)
    c = quality.certificate_counts("ann.search_ivf_pq")
    assert n_rerun == 0 and c["widened"] == NQ and c["exact_rerun"] == 0
    _, fi = search_ivf_flat(res, t, Q, K, n_probes=P, fine_scan="query")
    assert _sets(i) == _sets(fi)


@pytest.mark.parametrize("widen", ["4", "1"])
def test_rerun_rung_gives_flat_ids(world, monkeypatch, widen):
    """Every certificate forced to fail (the reference test's lambda): the
    widen rungs run as the cap allows, then every query reruns exactly;
    ids and values equal the reference's under the same forcing."""
    X, Q, jres, jidx, tidx, res = world
    monkeypatch.setenv("RAFT_TPU_ANN_PQ_WIDEN", widen)
    never = lambda bound, theta, widen: bound < bound          # noqa: E731
    monkeypatch.setattr(tpq, "_pq_certify", never)
    monkeypatch.setattr(jpq_mod, "_pq_certify", never)
    calls = []
    real = k5.pq_scan_list_major

    def counting(*a, **kw):
        calls.append(a[-1] if len(a) > 10 else kw.get("pool_depth", 2))
        return real(*a, **kw)

    monkeypatch.setattr(tpq, "pq_scan_list_major", counting)
    j, t = jidx[("plain", 8)], tidx[("plain", 8)]
    v, i, n_rerun = search_ivf_pq(res, t, Q, K, n_probes=P, pq_scan="pq",
                                  with_stats=True)
    assert n_rerun == NQ
    assert calls == ([2, 4, 8] if widen == "4" else [2])
    c = quality.certificate_counts("ann.search_ivf_pq")
    assert c["exact_rerun"] == NQ and c["reruns"] == 1
    jv, ji = j_search(jres, j, Q, K, n_probes=P, pq_scan="pq")
    _assert_same(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji), Q, X)
    _, fi = j_search_flat(jres, j, Q, K, n_probes=P, fine_scan="query")
    assert _sets(i) == _sets(fi)


def test_kernel_failure_raises(world, monkeypatch):
    """A K5 failure reaches the caller: no except turns it into the flat
    scan (the reference degrades; the port does not)."""
    _, Q, _, _, tidx, res = world

    def broken(*a, **kw):
        raise DeviceError("pq scan: launch failed with CUDA error 700")

    monkeypatch.setattr(tpq, "pq_scan_list_major", broken)
    with pytest.raises(DeviceError, match="700"):
        search_ivf_pq(res, tidx[("plain", 8)], Q, K, n_probes=P,
                      pq_scan="pq")


def test_wide_4bit_table_envelope(monkeypatch):
    """4-bit tables admit more than 512 subspaces (here S = d = 1024, a
    64 KB table): the certificate's first term grows to S·2⁻²⁴·‖x‖·‖r̂‖,
    the exact f32 table's error, past the reference's 2⁻¹⁵, and the ADC
    scan's answers are the flat scan's bits."""
    r = np.random.default_rng(23)
    d = S = 1024
    X = r.normal(0, 1, (600, d)).astype(np.float32)
    x = torch.from_numpy((X[:8] + r.normal(0, 0.05, (8, d)))
                         .astype(np.float32))
    res = DeviceResources(device="cpu")
    flat = build_ivf_flat(res, X, n_lists=8, n_probes=3, max_iter=3, seed=1)
    books = torch.from_numpy(r.normal(0, 1, (S, 16, 1)).astype(np.float32))
    idx = IvfPqIndex(flat, pq_dim=S, pq_bits=4, codebooks=books,
                     **tpq._pq_encode(res, flat, books, None, 4, "plain"))
    assert resolve_pq_scan(idx, 8, K, 3, idx.probe_window, "pq") == "pq"
    widen = []
    real = tpq._pq_certify
    monkeypatch.setattr(tpq, "_pq_certify",
                        lambda b, t, w: widen.append(w) or real(b, t, w))
    v, i = search_ivf_pq(res, idx, x, K, n_probes=3, pq_scan="pq")
    fv, fi = search_ivf_pq(res, idx, x, K, n_probes=3, pq_scan="flat")
    assert torch.equal(v, fv) and torch.equal(i, fi)
    pl = tivf._coarse_probe(res, idx.centroids, x, 3).long()
    xnorm = (x * x).sum(1).sqrt()
    yymax = tivf._list_host(idx)["yy_lmax"][pl].max(1).values
    span = (xnorm + yymax.sqrt() + idx.pq_eq_list[pl].max(1).values) ** 2
    first = widen[0] - (2.0 ** -20 + d * 2.0 ** -24) * span
    need = S * 2.0 ** -24 * xnorm * idx.pq_rhat_list[pl].max(1).values
    assert torch.all(first >= need * (1 - 2.0 ** -10))


# ----------------------------------------------------------- the chooser
def test_resolve_matches_reference(world, monkeypatch):
    _, _, _, jidx, tidx, _ = world
    j, t = jidx[("plain", 8)], tidx[("plain", 8)]
    W = t.probe_window
    for nq, k, P_, req in [(8, 4, 2, "pq"), (8, 97, 2, "pq"),
                           (8, 4, 129, "pq"), (NQ, K, P, "auto"),
                           (4096, 10, 24, "auto"), (8, 4, 2, "flat"),
                           (8, 4, 2, None)]:
        assert resolve_pq_scan(t, nq, k, P_, W, req) == \
            j_resolve(j, nq, k, P_, W, req), (nq, k, P_, req)
    monkeypatch.setenv("RAFT_TPU_IVF_PQ_SCAN", "flat")
    assert resolve_pq_scan(t, 8, 4, 2, W) == "flat"
    with pytest.raises(ValueError):
        resolve_pq_scan(t, 8, 4, 2, W, "bogus")


def test_expected_rerun_frac_matches_reference(world):
    from raft_tpu.observability import quality as jquality

    _, _, _, jidx, tidx, _ = world
    probes = np.arange(0, L, 3).reshape(-1, 4)
    for b in (("plain", 8), ("opq", 4)):
        for pr in (None, probes):
            f, src = tpq.expected_pq_rerun_frac(tidx[b], pr)
            jf, jsrc = jpq_mod.expected_pq_rerun_frac(jidx[b], pr)
            assert src == jsrc == "modeled"
            assert abs(f - jf) <= 1e-6 * max(1.0, jf)
    # the measured branch, fed the same rung counts in both packages
    for fn in (quality.record_pq_rungs, jquality.record_pq_rungs):
        fn("ann.search_ivf_pq", certified=50, widened=10, exact_rerun=4)
    f, src = tpq.expected_pq_rerun_frac(tidx[("plain", 8)])
    jf, jsrc = jpq_mod.expected_pq_rerun_frac(jidx[("plain", 8)])
    assert (f, src) == (jf, jsrc) == (4 / 64, "measured")
    t, j = tidx[("plain", 8)], jidx[("plain", 8)]
    assert resolve_pq_scan(t, 4096, 10, 24, t.probe_window, "auto") == \
        j_resolve(j, 4096, 10, 24, j.probe_window, "auto")


@pytest.mark.parametrize("name,value", [
    ("RAFT_TPU_IVF_PQ_SCAN", None), ("RAFT_TPU_IVF_PQ_SCAN", "PQ"),
    ("RAFT_TPU_IVF_PQ_SCAN", "list"), ("RAFT_TPU_ANN_PQ_BITS", None),
    ("RAFT_TPU_ANN_PQ_BITS", "4"), ("RAFT_TPU_ANN_PQ_BITS", "x"),
    ("RAFT_TPU_ANN_PQ_MODE", "opq_aniso"), ("RAFT_TPU_ANN_PQ_MODE", "pca"),
    ("RAFT_TPU_ANN_PQ_WIDEN", None), ("RAFT_TPU_ANN_PQ_WIDEN", "2")])
def test_pq_knobs_match_reference(monkeypatch, name, value):
    from raft_tpu.core import env as jenv

    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    assert env.get(name) == jenv.get(name)
    assert env.raw(name) == jenv.raw(name)


def test_costmodel_pq_keys_match_reference():
    from raft_tpu.observability import costmodel as jcm
    from raft_tpu_torch.observability import costmodel as tcm

    sizes = np.random.default_rng(4).integers(0, 2000, 64)
    padded = -(-sizes // 8) * 8
    for kw in (dict(), dict(list_sizes=sizes, padded_sizes=padded)):
        for bits, frac in ((8, 0.0), (4, 0.3)):
            args = (2048, 100_000, 128, 10, 64, 8, int(padded.max()),
                    int(padded.sum()))
            a = tcm.ivf_traffic_model(*args, pq_dim=32, pq_bits=bits,
                                      pq_rerun_frac=frac, **kw)
            b = jcm.ivf_traffic_model(*args, pq_dim=32, pq_bits=bits,
                                      pq_rerun_frac=frac, **kw)
            assert a.keys() == b.keys()
            for key in a:
                assert a[key] == pytest.approx(b[key], rel=1e-12), key
            assert tcm.choose_pq_scan(a) == jcm.choose_pq_scan(b)
            assert tcm.choose_pq_scan(a, 0.0) == jcm.choose_pq_scan(b, 0.0)
    assert tcm.pq_bytes_ratio(128, 32, 8) == jcm.pq_bytes_ratio(128, 32, 8)
    assert tcm.pq_index_bytes(10 ** 8, 128, 50_000, 32, 8) == \
        pytest.approx(jcm.pq_index_bytes(10 ** 8, 128, 50_000, 32, 8))


# ------------------------------------------------------ the port's build
def test_build_reaches_reference_recall(world):
    """The port's own build (another k-means++ stream) on the same data
    reaches the reference build's recall@k against the exact oracle."""
    X, Q, jres, jidx, _, res = world
    d2 = ((Q.astype(np.float64)[:, None] - X[None]) ** 2).sum(2)
    oracle = _sets(np.argsort(d2, 1)[:, :K])

    def recall(ids):
        return np.mean([len(a & b) / K for a, b in zip(_sets(ids), oracle)])

    for mode, bits in (("plain", 8), ("opq", 4)):
        t = build_ivf_pq(res, X, n_lists=L, pq_bits=bits, max_iter=5,
                         seed=2, pq_mode=mode)
        assert isinstance(t, IvfPqIndex) and t.device.type == "cpu"
        assert set(t.build_seconds) == {"coarse", "codebooks", "encode"}
        _, ti = search_ivf_pq(res, t, Q, K, n_probes=P, pq_scan="pq")
        _, ji = j_search(jres, jidx[(mode, bits)], Q, K, n_probes=P,
                         pq_scan="pq")
        assert recall(ti) >= recall(ji) - 0.02, (mode, bits)


def test_opq_rotation_is_orthogonal(world):
    X, _, _, _, _, res = world
    t = build_ivf_pq(res, X, n_lists=16, pq_bits=4, max_iter=3, seed=1,
                     pq_mode="opq", opq_iters=2)
    rot = t.pq_rot.double()
    eye = torch.eye(D, dtype=torch.float64)
    assert float((rot.T @ rot - eye).abs().max()) <= 8 * D * 2.0 ** -24
    # norms survive the rotation, so the envelopes hold on the true rows
    assert t.codebooks.shape == (D // 4, 16, 4)


def test_build_validation(world):
    X, _, _, _, _, res = world
    with pytest.raises(LogicError):
        build_ivf_pq(res, X, n_lists=8, pq_bits=5)
    with pytest.raises(LogicError):
        build_ivf_pq(res, X, n_lists=8, pq_dim=5)
    with pytest.raises(LogicError):
        build_ivf_pq(res, X, n_lists=8, pq_dim=3, pq_bits=4)
    with pytest.raises(LogicError):
        build_ivf_pq(res, X, n_lists=8, pq_mode="pca")
    with pytest.raises(LogicError):
        build_ivf_pq(res, X[:100], n_lists=8, pq_bits=8)
    assert tpq._default_pq_dim(128) == 32 and tpq._default_pq_dim(7) == 1


def test_warm_and_tf32_off(world):
    """warm_pq_scan launches the scan once per widen depth (the twin here)
    and the path keeps TF32 off for its f32 products."""
    _, Q, _, _, tidx, res = world
    t = tidx[("plain", 8)]
    assert warm_pq_scan(res, t, 16, K, P) == 3
    assert warm_pq_scan(res, t, 16, K, L) == 0
    search_ivf_pq(res, t, Q, K, n_probes=P, pq_scan="pq")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_from_numpy_needs_a_card_unless_asked(world):
    jidx = world[3]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda")
    with pytest.raises(DeviceError):
        IvfPqIndex.from_numpy(export(jidx[("plain", 8)]))
