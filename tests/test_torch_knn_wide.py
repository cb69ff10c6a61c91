"""Parity of the port's wide-feature and unpacked brute-force KNN with the
reference: K1's d-chunked packed form and its unpacked forms (twins
against the reference's Pallas kernels in interpret mode on the CPU), and
``knn_fused`` / ``distance.knn`` at d = 640 and in the unpacked geometry
(T = 512, g = 4096: 16,384 codes, past the 2¹³ packing envelope).

The reference pads features to its d-chunk of 256 (640 → 768) and the
port to 128 (640 stays); zero features change no product. The kernels sum
the same exact bf16 products in f32 in other orders, so a value may differ
by that accumulation error (2·d·2⁻²⁴·‖x‖·max‖y‖) plus, packed, two units
of the mantissa truncation 2^(pbits−23)·|v|; codes and ids agree on
≥ 99.9% of slots (a near-tie may flip). The KNN results must name the
reference's ids up to proven ties (``assert_same_ids``, values 1e-5
relative).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.distance import fused_l2nn as jl2nn
from raft_tpu.distance import knn_fused as jkf
from raft_tpu.ops import fused_l2_topk_pallas as jk
from raft_tpu_torch import distance as tdist
from raft_tpu_torch.core import DeviceError, DeviceResources
from raft_tpu_torch.distance import knn_fused as tkf
from raft_tpu_torch.ops import fused_l2_topk as tk

from test_torch_knn_fused import assert_same_ids

Q, M, T, G, PBITS = 16, 4096, 512, 8, 8
G_UNPACKED = 4096                    # 16,384 codes > 2^13


def _data(q, m, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(q, d)).astype(np.float32)
    y = rng.normal(size=(m, d)).astype(np.float32)
    return x, y


def _pad_features(a, d):
    return np.concatenate([a, np.zeros((a.shape[0], d - a.shape[1]),
                                       np.float32)], axis=1)


def _operands(d, sentinel, seed):
    """x, y and the half-norm carrier with a padded tail of 300 rows."""
    x, y = _data(Q, M, d, seed)
    yyh = (0.5 * (y * y).sum(1)).astype(np.float32)
    yyh[-300:] = sentinel
    xxh = (0.5 * (x * x).sum(1)).astype(np.float32)
    return x, y, yyh, xxh


def _acc(x, y):
    d = x.shape[1]
    return (2 * d * 2.0 ** -24 * np.linalg.norm(x, axis=1)[:, None]
            * np.linalg.norm(y, axis=1).max())


def _jax_kernel(fn, x, y, yyh, d_ref, passes, **kw):
    hi, lo = jk.split_hi_lo(jnp.asarray(_pad_features(y, d_ref)))
    return [np.asarray(a) for a in fn(
        jnp.asarray(_pad_features(x, d_ref)), hi, lo,
        jnp.broadcast_to(jnp.asarray(yyh)[None], (8, M)),
        jnp.full((1,), M, jnp.int32), T=T, Qb=Q, passes=passes, **kw)]


def _torch_split(x, y):
    hi, lo = tk.split_hi_lo(torch.from_numpy(y))
    return torch.from_numpy(x), hi, lo


def _split(a):
    bits = a.view(np.int32)
    mask = (1 << PBITS) - 1
    return bits & mask, (bits & ~mask).view(np.float32)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("pair", [False, True])
def test_packed_dchunk_twin_matches_pallas_kernel(passes, pair):
    x, y, yyh, xxh = _operands(640, tk._PACK_PAD, 11)
    ref = _jax_kernel(jk.fused_l2_group_topk_packed_dchunk, x, y, yyh, 768,
                      passes, tpg=G, dc=256, pair=pair, pbits=PBITS,
                      xxh=jnp.asarray(xxh)[:, None])
    xt, hi, lo = _torch_split(x, y)
    got = tk.fused_l2_group_topk_packed_dchunk(
        xt, hi, lo, torch.from_numpy(yyh), T=T, g=G, passes=passes,
        pair=pair, pbits=PBITS, xxh=torch.from_numpy(xxh))
    assert tk.LAUNCHES_DCHUNK == 0          # the CPU takes the twin
    acc = _acc(x, y)
    for n, (a, b) in enumerate(zip((t.numpy() for t in got), ref)):
        assert a.shape == b.shape == (Q, -(-(M // T) // G) * 128)
        ca, va = _split(a)
        cb, vb = _split(b)
        if n < 2 or not pair:
            assert (ca == cb).mean() >= 0.999
        tol = 2 * 2.0 ** (PBITS - 23) * np.abs(vb) + acc
        assert np.all(np.abs(va - vb) <= tol)


@pytest.mark.parametrize("d,dchunk", [(128, False), (640, True)])
@pytest.mark.parametrize("passes", [1, 3])
def test_unpacked_twins_match_pallas_kernels(d, dchunk, passes):
    x, y, yyh, _ = _operands(d, np.inf, 12)
    if dchunk:
        ref = _jax_kernel(jk.fused_l2_group_topk_dchunk, x, y, yyh, 768,
                          passes, tpg=G_UNPACKED, dc=256)
        fn = tk.fused_l2_group_topk_dchunk
    else:
        ref = _jax_kernel(jk.fused_l2_group_topk, x, y, yyh, d, passes,
                          tpg=G_UNPACKED)
        fn = tk.fused_l2_group_topk
    xt, hi, lo = _torch_split(x, y)
    got = [t.numpy() for t in fn(xt, hi, lo, torch.from_numpy(yyh), T=T,
                                 g=G_UNPACKED, passes=passes)]
    assert tk.LAUNCHES_GROUP == tk.LAUNCHES_GROUP_DCHUNK == 0
    assert got[1].dtype == got[3].dtype == np.int32
    acc = _acc(x, y)
    for n in (0, 2, 4):
        a, b = got[n], ref[n]
        assert a.shape == b.shape == (Q, 128)
        assert np.all(np.abs(a - b) <= acc)
    for n in (1, 3):
        assert (got[n] == ref[n]).mean() >= 0.999
        # no id names a padded row (+inf never wins a strict <)
        assert got[n].max() < M - 300 and got[n].min() >= 0


def test_unpacked_fold_keeps_the_first_id_on_a_tie():
    """_merge_chunk_top2 compares strictly: equal half-scores keep the
    earlier row; a bucket of +inf pads keeps +inf and id −1."""
    c = torch.zeros(1, 4 * 128)
    c[0, 256:] = float("inf")
    a1, id1, a2, id2, a3 = tk._group_fold(c, 128, 8)
    assert torch.all(a1 == 0) and torch.all(a2 == 0)
    assert torch.equal(id1[0], torch.arange(128, dtype=torch.int32))
    assert torch.equal(id2[0], torch.arange(128, 256, dtype=torch.int32))
    assert torch.all(torch.isinf(a3))
    a1, id1, _, id2, _ = tk._group_fold(c[:, 256:], 128, 1)
    assert torch.all(torch.isinf(a1)) and torch.all(id1 == -1)


def _integer_operands(d, seed):
    """Integer-valued x and y (|v| ≤ 3: every bf16 product and f32 sum is
    exact, so any summation order gives the same half-scores, and ties
    are common) with planted rows: duplicates of chunk 15's rows in chunk
    16 and of chunk 9's in chunk 10 (across the segment boundaries at
    S = 2 and 3), a NaN row, a +inf and a −inf half-norm carrier, and a
    padded tail of 300 rows (yyh = +inf)."""
    r_ = np.random.default_rng(seed)
    x = r_.integers(-3, 4, (Q, d)).astype(np.float32)
    y = r_.integers(-3, 4, (M, d)).astype(np.float32)
    y[16 * 128:17 * 128] = y[15 * 128:16 * 128]
    y[10 * 128:11 * 128] = y[9 * 128:10 * 128]
    y[700, 5] = np.nan
    yyh = (0.5 * (y * y).sum(1)).astype(np.float32)
    yyh[901], yyh[1902] = np.inf, -np.inf
    yyh[-300:] = np.inf
    return x, y, yyh


def _bits(a):
    """A float array's bits with every NaN as one pattern (ids as they
    are), for comparisons bit for bit."""
    a = np.asarray(a)
    if a.dtype != np.float32:
        return a
    return np.where(np.isnan(a), np.float32(np.nan), a).view(np.int32)


@pytest.mark.parametrize("segments", [1, 2, 3, 40])
@pytest.mark.parametrize("d,dchunk", [(128, False), (640, True)])
def test_split_twin_matches_fold_and_pallas_bit_for_bit(d, dchunk,
                                                        segments):
    """The split twin (segment summaries merged in segment order, what
    the card's merge kernel is held to) gives the sequential fold's bits
    and ids, and so the reference's Pallas kernels', at S = 1, 2, 3
    (uneven: 32 chunks) and 40 (more segments than chunks), with ties
    planted across segment boundaries, NaN and ±inf scores and pads."""
    x, y, yyh = _integer_operands(d, 31)
    kw = dict(tpg=G_UNPACKED)
    if dchunk:
        ref = _jax_kernel(jk.fused_l2_group_topk_dchunk, x, y, yyh, 768, 3,
                          dc=256, **kw)
        fn = tk.fused_l2_group_topk_dchunk_ref
    else:
        ref = _jax_kernel(jk.fused_l2_group_topk, x, y, yyh, d, 3, **kw)
        fn = tk.fused_l2_group_topk_ref
    xt, hi, lo = _torch_split(x, y)
    yt = torch.from_numpy(yyh)
    seq = fn(xt, hi, lo, yt, T=T, g=G_UNPACKED, passes=3)
    got, _ = tk._group_fold_split(tk._half_scores(xt, hi, lo, yt, 3), T,
                                  G_UNPACKED, segments)
    for a, b, r in zip(got, seq, ref):
        assert np.array_equal(_bits(a.numpy()), _bits(b.numpy()))
        assert np.array_equal(_bits(a.numpy()), _bits(r))
    a1, id1, a2, id2, a3 = (t.numpy() for t in got)
    assert np.isnan(a3).any() and np.isneginf(a1).any()
    assert (a1 == a2).any()                        # ties were folded
    assert id1.max() < M - 300 and id2.max() < M - 300


def test_split_merge_keeps_the_fold_s_tie_order():
    """The one place a naive merge of (a1, a2) states goes wrong: two
    equal entries before a smaller one in a later segment. The fold keeps
    the later equal entry in a2 (its strict < drops the earlier one when
    the smaller arrives); the merge of segment summaries keeps it too."""
    c = torch.full((1, 4 * 128), 5.0)
    c[0, 0], c[0, 256], c[0, 384] = -2.0, -2.0, -3.0
    seq = tk._group_fold(c, 128, 4)
    assert [int(seq[1][0, 0]), int(seq[3][0, 0])] == [384, 256]
    for segments in (2, 3, 4):
        out, parts = tk._group_fold_split(c, 128, 4, segments)
        for a, b in zip(out, seq):
            assert torch.equal(a, b)
        assert parts[0].shape == (segments, 1, 128)


def test_group_segments_fills_the_card():
    """S fills the 132 SMs in whole waves with the fewest segments, is
    capped by a group's chunks, and is 1 when the (query block, group)
    blocks already fill the card."""
    assert tk.group_segments(2048, 1, 7816, 132) == 4      # 32 blocks
    assert tk.group_segments(1000, 1, 7816, 132) == 8      # 16 blocks
    assert tk.group_segments(1000, 1, 5, 132) == 5         # chunk cap
    assert tk.group_segments(2048, 16, 256, 132) == 1      # 512 blocks
    assert tk.group_segments(64, 132, 32, 132) == 1
    for q, groups in ((1, 1), (100, 2), (6400, 1), (64 * 100, 1)):
        blocks = -(-q // 64) * groups
        S = tk.group_segments(q, groups, 10 ** 6, 132)
        busy = blocks * S / (132 * -(-blocks * S // 132))
        assert busy >= 0.9 and all(
            blocks * s / (132 * -(-blocks * s // 132)) < 0.9
            for s in range(1, S))


# ---- knn_fused and distance.knn ----
MODES = [(3, "kernel"), (1, "f32"), (1, "kernel")]


@pytest.fixture(scope="module")
def wide_runs():
    """Reference answers at d = 640, once per module."""
    x, y = _data(32, 8192, 640, 21)
    out = {}
    for metric in ("l2", "ip"):
        for passes, certify in MODES:
            v, i = jkf.knn_fused(x, y, k=16, passes=passes, T=T, Qb=32, g=G,
                                 metric=metric, certify=certify,
                                 grid_order="query")
            out[metric, passes, certify] = (np.asarray(v), np.asarray(i))
    return x, y, out


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("passes,certify", MODES)
def test_knn_fused_wide_matches_reference(wide_runs, metric, passes,
                                          certify):
    x, y, ref = wide_runs
    v, i = tkf.knn_fused(x, y, k=16, passes=passes, T=T, g=G,
                         metric=metric, certify=certify, device="cpu")
    v_ref, i_ref = ref[metric, passes, certify]
    if passes == 1 and certify == "kernel":
        # exact w.r.t. bf16 scores only: the two packages' summation
        # orders may rank near-ties of the bf16 score apart
        hit = np.mean([len(set(a) & set(b)) / 16 for a, b in
                       zip(i.numpy(), i_ref)])
        assert hit >= 0.99
        return
    sign = -1.0 if metric == "ip" else 1.0
    assert_same_ids(sign * v.numpy(), i.numpy(), sign * v_ref, i_ref)


def test_prepared_wide_index_through_distance_knn():
    x, y = _data(24, 8192, 640, 22)
    idx = tdist.prepare_knn_index(y, passes=3, T=T, g=G, device="cpu")
    assert idx.stream_width == 640          # the port pads to 128
    jidx = jkf.prepare_knn_index(y, passes=3, T=T, Qb=24, g=G,
                                 grid_order="query")
    assert jidx.stream_width == 768         # the reference to 256
    v_ref, i_ref = jl2nn.knn(JaxResources(seed=0), jidx, x, k=12)
    v, i = tdist.knn(DeviceResources(device="cpu"), idx, x, k=12)
    assert_same_ids(v.numpy(), i.numpy(), np.asarray(v_ref),
                    np.asarray(i_ref))


@pytest.mark.parametrize("d", [128, 640])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_unpacked_geometry_matches_reference(d, metric):
    """The reference's own unpacked test geometry (tests/test_knn_fused.py
    :526-534): T = 512, g = 4096."""
    x, y = _data(16, 9000, d, 23)
    jv, ji = jkf.knn_fused(x, y, k=8, passes=3, T=T, Qb=16, g=G_UNPACKED,
                           metric=metric, grid_order="query")
    idx = tkf.prepare_knn_index(y, passes=3, T=T, g=G_UNPACKED,
                                metric=metric, device="cpu")
    assert idx.g * (idx.T // 128) > (1 << idx.pbits)
    # the unpacked carrier: +inf on padded rows, never the packed sentinel
    assert torch.isinf(idx.yyh_k[9000:]).all()
    v, i = tkf.knn_fused(x, idx, k=8)
    sign = -1.0 if metric == "ip" else 1.0
    assert_same_ids(sign * v.numpy(), i.numpy(), sign * np.asarray(jv),
                    np.asarray(ji))
    # lite mode returns the kernel score function's top-k
    lite = tkf.prepare_knn_index(y, passes=3, T=T, g=G_UNPACKED,
                                 metric=metric, store_yp=False,
                                 device="cpu")
    lv, li = tkf.knn_fused(x, lite, k=8)
    assert (li.numpy() == i.numpy()).mean() >= 0.99


def test_unpacked_ragged_mask_raises():
    _, y = _data(4, 4096, 64, 24)
    with pytest.raises(ValueError, match="packed-code envelope"):
        tkf.prepare_knn_index(y, T=T, g=G_UNPACKED, device="cpu",
                              rows_valid=np.ones(4096, bool))


def test_int8_wide_features_run_as_bf16():
    x, y = _data(16, 8192, 600, 25)
    idx = tkf.prepare_knn_index(y, passes=1, T=T, g=G, db_dtype="int8",
                                device="cpu")
    assert idx.db_dtype == "bf16" and idx.stream_width == 640
    jidx = jkf.prepare_knn_index(y, passes=1, T=T, Qb=16, g=G,
                                 db_dtype="int8")
    assert jidx.db_dtype == "bf16"
    jv, ji = jkf.knn_fused(x, jidx, 10, certify="f32")
    v, i = tkf.knn_fused(x, idx, 10, certify="f32")
    assert_same_ids(v.numpy(), i.numpy(), np.asarray(jv), np.asarray(ji))


def test_fused_eligible_gate():
    assert tkf.fused_eligible(4096, 960, "cuda")
    assert tkf.fused_eligible(4096, 4096, "cuda")
    assert not tkf.fused_eligible(4096, 4097, "cuda")
    assert not tkf.fused_eligible(4095, 128, "cuda")
    assert not tkf.fused_eligible(1 << 20, 960, "cpu")


@pytest.mark.parametrize("name,d,g", [
    ("fused_l2_group_topk_packed_dchunk", 640, G),
    ("fused_l2_group_topk", 64, G_UNPACKED),
    ("fused_l2_group_topk_dchunk", 640, G_UNPACKED)])
def test_kernel_failure_raises(monkeypatch, name, d, g):
    """A failed launch of a new K1 form reaches the caller: nothing turns
    it into another path."""
    x, y = _data(8, 4096, d, 26)

    def broken(*a, **kw):
        raise DeviceError(f"{name}: launch failed with CUDA error 700")

    monkeypatch.setattr(tkf, name, broken)
    with pytest.raises(DeviceError, match="700"):
        tkf.knn_fused(x, y, k=4, T=T, g=g, device="cpu")


def test_k3_failure_raises(monkeypatch):
    from raft_tpu_torch.matrix import SelectAlgo, select_k

    def broken(*a, **kw):
        raise DeviceError("select_slot_topk_packed: launch failed with "
                          "CUDA error 700")

    monkeypatch.setattr(
        importlib.import_module("raft_tpu_torch.matrix.select_k_slotted"),
        "select_slot_topk_packed", broken)
    v = torch.zeros(2, 8192)
    for algo in (SelectAlgo.SLOTTED, SelectAlgo.BITONIC):
        with pytest.raises(DeviceError, match="700"):
            select_k(None, v, k=8, algo=algo)


@pytest.mark.parametrize("d,g", [(640, G), (64, G_UNPACKED)])
def test_serving_entry_serves_wide_and_unpacked_indexes(d, g):
    """runtime.knn_query (the serving engine's data plane) on a wide and
    an unpacked index answers as knn_fused does, bit for bit."""
    from raft_tpu_torch.runtime import knn_query

    x, y = _data(12, 8192, d, 27)
    idx = tkf.prepare_knn_index(y, passes=3, T=T, g=g, device="cpu")
    v, i = knn_query(None, idx, x, 10)
    v_ref, i_ref = tkf.knn_fused(x, idx, 10)
    assert torch.equal(v, v_ref) and torch.equal(i, i_ref)
