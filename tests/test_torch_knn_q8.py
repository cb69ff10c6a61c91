"""Parity of the port's int8-streamed index and its kernel K2 (the twin,
on the CPU) with the reference (raft_tpu.distance.knn_fused with
``db_dtype="int8"``, its Pallas kernel in interpret mode).

Both packages get the same numpy data.
- The quantized state is computed by the same formulas: the codes must be
  bit-identical; scales, Eq, and the norms summed in another order agree
  within d f32 ulps.
- K2's twin and the reference kernel sum the same exact bf16 products in
  f32 in other orders: a value may differ by the f32 summation bound
  (d + 2)·2⁻²⁴·Σ|x||ŷ| (plus the few roundings of the norm terms and two
  units of the packing truncation); a slot's code may differ only where
  the two rows it names score within that bound of each other.
- int8 ``knn_fused`` is certified against the f32 rows: ids identical to
  the f32 oracle's (up to a proven tie), values to f32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.distance import knn_fused as jkf
from raft_tpu.ops import fused_l2_topk_pallas as jk
from raft_tpu_torch.distance import knn_fused as tkf
from raft_tpu_torch.ops import fused_l2_topk as tk

from _torch_threads import one_torch_thread  # noqa: F401

T = 256
ULP = 2.0 ** -24


def _oracle(x, y, k, metric="l2"):
    """f64 scores and the top-k ids (ascending d2, or descending x·y)."""
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    if metric == "ip":
        s = -(x64 @ y64.T)
    else:
        s = (x64 ** 2).sum(1)[:, None] + (y64 ** 2).sum(1)[None] \
            - 2 * x64 @ y64.T
    ids = np.argsort(s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, ids, 1), ids


def f32_floor(x, y):
    """The rounding floor of an f32 score formed as ‖x‖² + ‖y‖² − 2x·y:
    a few ulps of the norms, which dwarf the distances of near-duplicates
    (what both packages rank by, in other summation orders)."""
    return 16 * ULP * float((x.astype(np.float64) ** 2).sum(1).max()
                            + (y.astype(np.float64) ** 2).sum(1).max())


def assert_certified(v, i, x, y, k, metric="l2", rtol=1e-5):
    """Ids equal to the f64 oracle's as sets per query, or different only
    at a tie with the oracle's k-th score (within the f32 floor); values
    to f32 tolerance."""
    s_ref, i_ref = _oracle(x, y, k, metric)
    v_ref = -s_ref if metric == "ip" else s_ref
    floor = f32_floor(x, y)
    np.testing.assert_allclose(v, v_ref, rtol=rtol, atol=floor)
    for q in range(i.shape[0]):
        extra = set(i[q].tolist()) - set(i_ref[q].tolist())
        for e in extra:
            xe, ye = x[q].astype(np.float64), y[e].astype(np.float64)
            se = -(xe @ ye) if metric == "ip" else ((xe - ye) ** 2).sum()
            assert abs(se - s_ref[q, -1]) <= rtol * abs(s_ref[q, -1]) \
                + floor, (q, e)


# ------------------------------------------------------------------
# the quantized state, against the reference's _prepare_ops_q8
# ------------------------------------------------------------------
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("g", [2, 4])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_quantized_state_matches_reference(d, g, metric):
    rng = np.random.default_rng(d + g)
    y = rng.normal(size=(4100, d)).astype(np.float32) * 3.0 + 1.0
    jidx = jkf.prepare_knn_index(y, passes=1, T=T, Qb=32, g=g,
                                 metric=metric, grid_order="db",
                                 db_dtype="int8")
    idx = tkf.prepare_knn_index(y, passes=1, T=T, g=g, metric=metric,
                                db_dtype="int8", device="cpu")
    assert idx.db_dtype == jidx.db_dtype == "int8"
    assert idx.y_hi is None and idx.y_q.dtype == torch.int8
    M = idx.prepared_rows
    assert M % (g * T) == 0 and M == jidx.y_q.shape[0] >= 4100
    np.testing.assert_array_equal(idx.y_q.numpy(), np.asarray(jidx.y_q))
    dpad = idx.stream_width

    def close(a, b):
        b = np.asarray(b, np.float64)
        np.testing.assert_allclose(a.numpy(), b, rtol=dpad * ULP,
                                   atol=0.0)

    close(idx.scales, np.asarray(jidx.y_scale_k)[:, 0, 0])
    close(idx.eq_groups, jidx.eq_groups)
    close(idx.yyh_k, np.asarray(jidx.yyh_k)[0])
    close(idx.yy_raw, np.asarray(jidx.yy_raw)[0])
    np.testing.assert_array_equal(idx.yp.numpy(), np.asarray(jidx.yp))


# ------------------------------------------------------------------
# K2's twin against the reference kernel
# ------------------------------------------------------------------
@pytest.fixture(scope="module")
def k2_inputs():
    rng = np.random.default_rng(21)
    Q, m, d, g = 32, 4100, 128, 2
    x = rng.normal(size=(Q, d)).astype(np.float32)
    y = rng.normal(size=(m, d)).astype(np.float32)
    jidx = jkf.prepare_knn_index(y, passes=1, T=T, Qb=32, g=g,
                                 grid_order="db", db_dtype="int8")
    xxh = (0.5 * (x * x).sum(1)).astype(np.float32)
    return x, jidx, xxh


def _decode_rows(codes, g, pair):
    """The database row each slot's code names."""
    Q, S = codes.shape
    slot = np.arange(S)[None, :]
    return (slot // 128) * g * T + codes * 128 + slot % 128


def _scores(x, y_hat, yyh, xxh, rows, passes):
    """f64 kernel scores c = yyh − x_bf·ŷ + xxh of ``rows`` [Q, S]."""
    xb = torch.from_numpy(x).to(torch.bfloat16)
    xs = xb.double()
    if passes == 3:
        xs = xs + (torch.from_numpy(x) - xb.float()).to(
            torch.bfloat16).double()
    yr = torch.from_numpy(y_hat).double()[torch.from_numpy(rows)]
    dot = (yr * xs[:, None, :]).sum(2).numpy()
    return yyh.astype(np.float64)[rows] - dot + xxh[:, None]


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("pair", [False, True])
def test_k2_twin_matches_reference_kernel(k2_inputs, passes, pair):
    x, jidx, xxh = k2_inputs
    g, pbits = jidx.g, jidx.pbits
    M, d = jidx.y_q.shape
    ref = jk.fused_l2_group_topk_packed_db_q8(
        jnp.asarray(x), jidx.y_q, jidx.yyh_k, jidx.y_scale_k,
        jnp.full((1,), M, jnp.int32), T=T, Qb=32, passes=passes, tpg=g,
        pair=pair, pbits=pbits, xxh=jnp.asarray(xxh)[:, None])
    scales = np.asarray(jidx.y_scale_k)[:, 0, 0].copy()
    yyh = np.asarray(jidx.yyh_k)[0].copy()
    got = tk.fused_l2_group_topk_packed_q8(
        torch.from_numpy(x), torch.from_numpy(np.asarray(jidx.y_q).copy()),
        torch.from_numpy(yyh), torch.from_numpy(scales), T=T, g=g,
        passes=passes, pair=pair, pbits=pbits, xxh=torch.from_numpy(xxh))
    y_hat = np.asarray(jidx.y_q, np.float32) * np.repeat(scales, g * T)[
        :, None]
    # the stated bound: the d-sum of |x||ŷ| in f32, the norm terms' few
    # roundings, and two units of the packed mantissa truncation
    sum_abs = (np.abs(x).astype(np.float64) @ np.abs(y_hat).T.astype(
        np.float64)).max(1)
    live = yyh < tk._PACK_PAD * 0.25
    acc = ((d + 2) * ULP * sum_abs + 4 * ULP * (yyh[live].max() + xxh)
           )[:, None]
    mask = (1 << pbits) - 1
    for n, (a, b) in enumerate(zip(got, ref)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape == (x.shape[0], M // (g * T) * 128)
        ca, cb = a.view(np.int32) & mask, b.view(np.int32) & mask
        va = (a.view(np.int32) & ~mask).view(np.float32)
        vb = (b.view(np.int32) & ~mask).view(np.float32)
        tol = acc + 2 * 2.0 ** (pbits - 23) * np.abs(vb)
        assert np.all(np.abs(va - vb) <= tol), n
        if n == 2 and pair:
            continue                      # a3's code means nothing here
        diff = ca != cb
        if diff.any():
            # a differing code must name a row that scores within the
            # bound of the other one: a tie, not a wrong candidate
            ra, rb = _decode_rows(ca, g, pair), _decode_rows(cb, g, pair)
            sa = _scores(x, y_hat, yyh, xxh, ra, passes)
            sb = _scores(x, y_hat, yyh, xxh, rb, passes)
            assert np.all(np.abs(sa - sb)[diff] <= 2 * tol[diff]), n


# ------------------------------------------------------------------
# int8 knn_fused against the reference and the f32 oracle
# ------------------------------------------------------------------
def _clustered(seed, m, d, nq):
    """Clustered, norm-offset data (the reference's
    test_brute_parity_clustered_offset_data)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, d)).astype(np.float32) * 5.0 + 20.0
    y = (centers[rng.integers(0, 8, m)]
         + rng.normal(size=(m, d)).astype(np.float32) * 0.05)
    x = (centers[rng.integers(0, 8, nq)]
         + rng.normal(size=(nq, d)).astype(np.float32) * 0.05)
    return x, y


CASES = {"l2_p1": ("l2", 1, "gauss"), "l2_p3": ("l2", 3, "gauss"),
         "ip_p1": ("ip", 1, "gauss"), "l2_p3_clustered": ("l2", 3, "clus")}


@pytest.mark.parametrize("case", list(CASES))
def test_int8_knn_matches_reference_and_oracle(case):
    metric, passes, kind = CASES[case]
    if kind == "clus":
        x, y = _clustered(5, 4096, 32, 48)
        k, g = 10, 2
    else:
        rng = np.random.default_rng(passes + len(metric))
        x = rng.normal(size=(32, 64)).astype(np.float32)
        y = rng.normal(size=(4096, 64)).astype(np.float32)
        k, g = 8, 4
    jv, ji = jkf.knn_fused(x, y, k, passes=passes, T=T, Qb=32, g=g,
                           metric=metric, grid_order="db", db_dtype="int8")
    v, i, n_fail = tkf.knn_fused(x, y, k, passes=passes, T=T, g=g,
                                 metric=metric, db_dtype="int8",
                                 device="cpu", with_stats=True)
    v, i = v.numpy(), i.numpy()
    assert v.shape == i.shape == (x.shape[0], k) and i.dtype == np.int32
    assert 0 <= n_fail <= x.shape[0]
    assert_certified(v, i, x, y, k, metric)
    assert_certified(np.asarray(jv), np.asarray(ji), x, y, k, metric)
    np.testing.assert_allclose(v, np.asarray(jv), rtol=1e-5,
                               atol=f32_floor(x, y))


def test_int8_prepared_index_and_distance_knn():
    from raft_tpu_torch import distance as tdist
    from raft_tpu_torch.core import DeviceResources

    rng = np.random.default_rng(3)
    x = rng.normal(size=(40, 100)).astype(np.float32)
    y = rng.normal(size=(5000, 100)).astype(np.float32)
    idx = tdist.prepare_knn_index(y, passes=3, T=T, g=2, db_dtype="int8",
                                  device="cpu")
    assert idx.prepared_rows == 5120 and idx.stream_width == 128
    v, i = tdist.knn(DeviceResources(device="cpu"), idx, x, 12)
    assert_certified(v.numpy(), i.numpy(), x, y, 12)
    # the CPU path takes the twins: no kernel launched
    assert tk.LAUNCHES == tk.LAUNCHES_Q8 == 0


# ------------------------------------------------------------------
# the envelope and its errors
# ------------------------------------------------------------------
def test_int8_lite_index_rejected():
    y = np.ones((512, 32), np.float32)
    with pytest.raises(ValueError, match="store_yp"):
        tkf.prepare_knn_index(y, db_dtype="int8", store_yp=False,
                              device="cpu")


def test_int8_rescore_false_rejected():
    y = np.random.default_rng(0).normal(size=(1024, 32)).astype(np.float32)
    idx = tkf.prepare_knn_index(y, passes=1, T=T, g=2, db_dtype="int8",
                                device="cpu")
    with pytest.raises(ValueError, match="rescore"):
        tkf.knn_fused(np.ones((8, 32), np.float32), idx, 4, rescore=False)


def test_unknown_db_dtype_rejected():
    y = np.ones((512, 32), np.float32)
    with pytest.raises(ValueError, match="db_dtype"):
        tkf.prepare_knn_index(y, db_dtype="int4", device="cpu")
    with pytest.raises(ValueError, match="db_dtype"):
        tkf.knn_fused(y[:4], y, 2, db_dtype="f16", device="cpu")


def test_int8_wide_features_downgrade_then_run_dchunk():
    y = np.ones((512, 600), np.float32)
    assert tkf.resolve_db_dtype("int8", 600, True) == "bf16"
    # the reference downgrades the same way
    assert jkf.resolve_db_dtype("int8", 600, True, "db") == "bf16"
    idx = tkf.prepare_knn_index(y, passes=1, db_dtype="int8", device="cpu")
    assert idx.db_dtype == "bf16" and idx.y_q is None
    # the bf16 index then serves through K1's d-chunked form
    v, i = tkf.knn_fused(y[:4], idx, 3)
    np.testing.assert_array_equal(v.numpy(), np.zeros((4, 3), np.float32))


def test_index_from_reference_int8_state():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(24, 48)).astype(np.float32)
    y = rng.normal(size=(3000, 48)).astype(np.float32)
    jidx = jkf.prepare_knn_index(y, passes=3, T=T, Qb=32, g=2,
                                 grid_order="db", db_dtype="int8")
    state = {"yp": np.asarray(jidx.yp), "y_q": np.asarray(jidx.y_q),
             "y_scale_k": np.asarray(jidx.y_scale_k),
             "eq_groups": np.asarray(jidx.eq_groups),
             "yyh_k": np.asarray(jidx.yyh_k),
             "yy_raw": np.asarray(jidx.yy_raw), "n_rows": jidx.n_rows,
             "T": jidx.T, "Qb": jidx.Qb, "g": jidx.g,
             "passes": jidx.passes, "metric": jidx.metric,
             "d_orig": jidx.d_orig, "pbits": jidx.pbits,
             "db_dtype": jidx.db_dtype}
    idx = tkf.KnnIndex.from_numpy(state, device="cpu")
    assert idx.db_dtype == "int8" and idx.Qb == 32 and idx.y_hi is None
    mine = tkf.prepare_knn_index(y, passes=3, T=T, g=2, db_dtype="int8",
                                 device="cpu")
    assert torch.equal(idx.y_q, mine.y_q)
    torch.testing.assert_close(idx.scales, mine.scales)
    jv, ji = jkf.knn_fused(x, jidx, 9)
    v, i = tkf.knn_fused(x, idx, 9)
    assert_certified(v.numpy(), i.numpy(), x, y, 9)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=f32_floor(x, y))
