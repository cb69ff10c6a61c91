"""Parity of the port's K5 twin (raft_tpu_torch.ops.pq_scan) with the
reference's list-major ADC kernel (Pallas, interpret mode on the CPU), on
real schedules from a small IVF-PQ index.

The index is laid out from chosen list sizes, so its schedules hold lists
shorter than and exactly as long as the kernel window, an empty list and
pad entries (lid −1); the query batch has pad queries (probes −2). The
reference sums the lookup table through a bf16 hi/lo one-hot product, the
twin sums the f32 entries; their difference is bounded by the reference's
own certificate envelope e_k = 2⁻¹⁵·‖x‖·max‖r̂‖ + (2⁻²⁰ + d·2⁻²⁴)·(‖x‖ +
max‖ŷ‖ + max Eq)² per query (``ann/ivf_pq.py``), the stated tolerance for
pooled values and the rest-min. A slot's row may differ only where the two
rows' exact (f64) lower bounds lie within twice that envelope, which the
test proves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import pq_scan_pallas as jpq
from raft_tpu_torch.ann import IvfFlatIndex
from raft_tpu_torch.ann import ivf_flat as tivf
from raft_tpu_torch.ann import ivf_pq as tpq
from raft_tpu_torch.core import DeviceError, DeviceResources
from raft_tpu_torch.mutable.layout import ragged_layout_from_lists
from raft_tpu_torch.ops import pq_scan as k5
from raft_tpu_torch.ops.fine_scan import pad_window

from _torch_threads import one_torch_thread  # noqa: F401

D, S = 16, 4
# list sizes: two lists of exactly the window (256), an empty one, short
# ones and one a row under the window
SIZES = [256, 1, 37, 0, 128, 200, 256, 64, 9, 255, 17, 100]
NQ, P = 13, 4           # 13 queries pad to 16: three pad queries


def _index(bits: int):
    """An IvfPqIndex on the CPU over rows bucketed by :data:`SIZES`,
    encoded with codebooks drawn from its residuals."""
    rng = np.random.default_rng(5)
    L = len(SIZES)
    centers = rng.uniform(-6, 6, (L, D)).astype(np.float32)
    labels = np.repeat(np.arange(L), SIZES)
    X = (centers[labels] + rng.normal(0, 1.0, (labels.size, D))
         ).astype(np.float32)
    lay = ragged_layout_from_lists(torch.from_numpy(X),
                                   torch.from_numpy(labels), L)
    flat = IvfFlatIndex(torch.from_numpy(centers), lay.slab, lay.ids,
                        (lay.slab * lay.slab).sum(1), lay.offsets, lay.sizes,
                        lay.padded_sizes, n_rows=X.shape[0], d_orig=D,
                        row_quantum=8, n_probes_default=P)
    K = 1 << bits
    books = torch.from_numpy(rng.normal(0, 0.8, (S, K, D // S))
                             .astype(np.float32))
    res = DeviceResources(device="cpu")
    return tpq.IvfPqIndex(flat, pq_dim=S, pq_bits=bits, codebooks=books,
                          **tpq._pq_encode(res, flat, books, None, bits,
                                           "plain"))


def _operands(index, seed: int = 3):
    """K5's operands as ``pq_scan_chunk`` builds them, for NQ queries each
    probing P distinct non-empty lists."""
    rng = np.random.default_rng(seed)
    live = [l for l, s in enumerate(SIZES) if s]
    probes = np.stack([rng.choice(live, P, replace=False)
                       for _ in range(NQ)]).astype(np.int32)
    x = torch.from_numpy(rng.normal(0, 4.0, (NQ, D)).astype(np.float32))
    pr = torch.from_numpy(probes)
    sch = tivf.build_list_schedule(index, probes)
    sched = torch.from_numpy(sch.sched)
    xp, pp, nqp = tivf._pad_kernel_operands(x, pr)
    xx = (xp * xp).sum(1, keepdim=True)
    lut = tpq._pq_lut(xp, index.codebooks, S, D // S)
    cdot = xp @ index.centroids[sched[3].long().clamp_min(0)].T
    W = index.probe_window
    return dict(sched=sched, xx=xx, probes=pp, cdot=cdot.contiguous(),
                lut=lut, codes=index.codes, yy_pq=index.yy_pq,
                eq_rows=index.pq_eq_rows.reshape(-1, 1),
                Wk=pad_window(W)), x, probes


@pytest.fixture(scope="module", params=[8, 4])
def case(request):
    index = _index(request.param)
    ops, x, probes = _operands(index)
    return index, ops, x, probes


def _reference(ops, bits, depth):
    o = {n: (v.numpy() if isinstance(v, torch.Tensor) else v)
         for n, v in ops.items()}
    out = jpq.pq_scan_list_major(
        jnp.asarray(o["sched"]), o["xx"], o["probes"], o["cdot"], o["lut"],
        o["codes"], o["yy_pq"], o["eq_rows"], Wk=o["Wk"], pq_bits=bits,
        pool_depth=depth)
    return [np.asarray(a) for a in out]


def _lb64(index, ops, q, row):
    """The exact (f64) certified lower bound of slab ``row`` for query
    ``q``: the table sum in f64 and the score of the row's schedule
    entry."""
    sched = ops["sched"].numpy()
    lid = int(np.searchsorted(index._np_offsets, row, side="right") - 1)
    j = int(np.nonzero(sched[3] == lid)[0][0])
    K = index.pq_k
    codes = tpq.unpack_pq_codes(index.codes[row:row + 1], S,
                                index.pq_bits)[0].numpy()
    lut = ops["lut"][q].double().numpy()
    adc = sum(lut[s * K + codes[s]] for s in range(S))
    d2 = (float(ops["xx"][q, 0]) + float(index.yy_pq[row, 0])
          - 2.0 * float(ops["cdot"][q, j]) - 2.0 * adc)
    return max(np.sqrt(max(d2, 0.0)) - float(index.pq_eq_rows[row]),
               0.0) ** 2


def _envelope(index, ops):
    """Per padded query: the reference's envelope e_k over its probes."""
    pl = ops["probes"].long().clamp_min(0)
    xnorm = ops["xx"][:, 0].sqrt()
    eq_w = index.pq_eq_list[pl].max(1).values
    yymax = tivf._list_host(index)["yy_lmax"][pl].max(1).values
    rhat = index.pq_rhat_list[pl].max(1).values
    span = (xnorm + yymax.sqrt() + eq_w) ** 2
    return (2.0 ** -15 * xnorm * rhat
            + (2.0 ** -20 + D * 2.0 ** -24) * span).numpy()


@pytest.mark.parametrize("depth", [2, 4, 8])
def test_twin_matches_reference(case, depth):
    index, ops, _, _ = case
    bits = index.pq_bits
    before = (k5.LAUNCHES_8BIT, k5.LAUNCHES_4BIT)
    got = [a.numpy() for a in k5.pq_scan_list_major(
        **ops, pq_bits=bits, pool_depth=depth)]
    assert (k5.LAUNCHES_8BIT, k5.LAUNCHES_4BIT) == before   # CPU: the twin
    ref = _reference(ops, bits, depth)
    assert len(got) == len(ref) == 2 * depth + 1
    tol = _envelope(index, ops)[:, None]
    for n in list(range(0, 2 * depth, 2)) + [2 * depth]:
        fin = np.isfinite(ref[n])
        assert np.array_equal(fin, np.isfinite(got[n])), n
        diff = np.where(fin, got[n], 0.0) - np.where(fin, ref[n], 0.0)
        assert np.all(np.abs(diff) <= tol), n
    assert np.isfinite(got[0][:NQ]).mean() > 0.5     # the pools are filled
    n_diff = 0
    for t in range(depth):
        rows, rrows = got[2 * t + 1], ref[2 * t + 1]
        assert np.array_equal(rows < 0, rrows < 0)
        for q, lane in zip(*np.nonzero(rows != rrows)):
            a = _lb64(index, ops, q, int(rows[q, lane]))
            b = _lb64(index, ops, q, int(rrows[q, lane]))
            assert abs(a - b) <= 2 * tol[q, 0], (t, q, lane, a, b)
            n_diff += 1
    assert n_diff <= 2 * depth      # a tie, not a different pool
    # pad queries (rows 13..15) pooled nothing
    assert np.all(np.isinf(got[0][NQ:])) and np.all(got[1][NQ:] == -1)


def test_schedule_covers_the_cases(case):
    """The schedule holds window-long and short lists and pad entries."""
    index, ops, _, probes = case
    sched = ops["sched"].numpy()
    Wk = ops["Wk"]
    assert Wk == 256 and index.probe_window == 256
    lids = sched[3]
    assert (lids == -1).any()
    sizes = sched[1][lids >= 0]
    assert (sizes == Wk).any() and (sizes < Wk).any()
    assert set(lids[lids >= 0]) == set(np.unique(probes))


def test_twin_pools_only_member_lists(case):
    """Every pooled row lies in one of the query's probed lists, and the
    pooled values ascend within each slot."""
    index, ops, _, probes = case
    out = k5.pq_scan_list_major(**ops, pq_bits=index.pq_bits, pool_depth=4)
    offs = index._np_offsets
    for t in range(4):
        rows = out[2 * t + 1][:NQ].numpy()
        for q in range(NQ):
            r = rows[q][rows[q] >= 0]
            lists = np.searchsorted(offs, r, side="right") - 1
            assert set(lists) <= set(probes[q])
    vals = torch.stack([out[2 * t] for t in range(4)] + [out[8]])
    assert bool((vals[1:] >= vals[:-1]).all())


def test_wrapper_refusals(case):
    index, ops, _, _ = case
    bits = index.pq_bits
    bad = [
        (dict(Wk=100), "multiple"),
        (dict(sched=ops["sched"][:, :5]), "sched"),
        (dict(probes=ops["probes"][:4]), "probes"),
        (dict(cdot=ops["cdot"][:, :8]), "cdot"),
        (dict(lut=ops["lut"][:, :-1]), "lut"),
        (dict(codes=ops["codes"].to(torch.uint8)), "int8"),
        (dict(yy_pq=ops["yy_pq"][:-1]), "one value per slab row"),
    ]
    for kw, msg in bad:
        with pytest.raises(ValueError, match=msg):
            k5.pq_scan_list_major(**{**ops, **kw}, pq_bits=bits)
    with pytest.raises(ValueError, match="pq_bits"):
        k5.pq_scan_list_major(**ops, pq_bits=6)
    with pytest.raises(ValueError, match="pool_depth"):
        k5.pq_scan_list_major(**ops, pq_bits=bits, pool_depth=3)


def test_shared_memory_cap():
    """A table over 227 KB is refused by the wrapper and by the chooser."""
    assert k5.pq_scan_smem_bytes(32, 8) == 32 * 1024
    assert k5.pq_scan_smem_bytes(64, 8) == 64 * 1024
    assert k5.pq_scan_smem_bytes(226, 8) <= k5.MAX_SMEM_BYTES
    assert k5.pq_scan_smem_bytes(228, 8) > k5.MAX_SMEM_BYTES
    nqp, R = 8, 512
    sched = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="shared memory"):
        k5.pq_scan_list_major(
            sched, torch.zeros(nqp), torch.full((nqp, 1), -2,
                                                dtype=torch.int32),
            torch.zeros((nqp, 8)), torch.zeros((nqp, 228 * 256)),
            torch.zeros((R, 228), dtype=torch.int8), torch.zeros(R),
            torch.zeros(R), 128, 8)


def test_decode_matches_reference():
    rng = np.random.default_rng(2)
    for bits, width in ((8, 6), (4, 3)):
        packed = rng.integers(-128, 128, (50, width)).astype(np.int8)
        S_ = width if bits == 8 else 2 * width
        ref = np.stack([np.asarray(c) for c in jpq._decode_subspaces(
            jnp.asarray(packed), S_, bits)], axis=1)
        got = k5.decode_codes(torch.from_numpy(packed), S_, bits).numpy()
        assert np.array_equal(got, ref)


def test_kernel_needs_a_card(case):
    """The kernel path refuses CPU tensors, and the library cannot be
    built without nvcc: a call that reaches the kernel raises, it never
    falls back to the twin."""
    index, ops, _, _ = case
    with pytest.raises(DeviceError):
        k5._launch(ops["sched"], ops["xx"], ops["probes"], ops["cdot"],
                   ops["lut"], ops["codes"], ops["yy_pq"], ops["eq_rows"],
                   ops["Wk"], index.pq_bits, 2)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the kernel builds here")
    from raft_tpu_torch.ops import _build

    if not _build.os.path.exists(_build.library_path("pq_scan")):
        with pytest.raises(DeviceError, match="nvcc"):
            k5._launcher()


@pytest.mark.parametrize("terms", [2, 16, 24, 32, 48, 64, 96, 128])
def test_adc_order_permutes_and_spreads_the_banks(terms):
    """Each column's order is a permutation of the row's terms, a function
    of the column mod 32; the table columns (``i ^ m``) the 32 columns of
    a warp read at a step are 32 different banks where 32 divides the
    terms or they are a power of 2 (the table repeating them up to 32)."""
    cols = torch.arange(7, 7 + 256)
    order = k5.adc_order(cols, terms)
    assert order.shape == (256, terms)
    assert torch.equal(order.sort(1).values,
                       torch.arange(terms).expand(256, terms))
    assert torch.equal(order[0], order[32])
    span = k5._order_span(terms)
    warp = torch.arange(64, 96)
    m = (warp & 31) % span
    table_cols = torch.arange(terms)[None, :] ^ m[:, None]
    assert int(table_cols.max()) < k5._table_cols(terms)
    assert torch.equal(table_cols % terms, k5.adc_order(warp, terms))
    if span == 32:
        assert all(len(set((table_cols[:, i] % 32).tolist())) == 32
                   for i in range(terms))


@pytest.mark.parametrize("pq_dim,bits,pairs", [(32, 8, False),
                                               (32, 4, True),
                                               (1024, 4, False)])
def test_table_layout(pq_dim, bits, pairs):
    """A row's terms are its code bytes over a 256-code table where that
    fits the block (4-bit pairs too), else its nibbles."""
    got = k5.table_layout(pq_dim, bits)
    assert got[0] == pairs
    assert got[1] == (pq_dim // 2 if pairs else pq_dim)
    assert got[3] == 4 * (16 if bits == 4 and not pairs else 256) * got[2]
    assert got[3] <= k5.MAX_SMEM_BYTES


def test_adc_sum_within_envelope(case):
    """The twin's f32 table sum (:func:`adc_sum`: the kernel's terms, in
    its order, two chains a row) stays within S·2⁻²⁴·Σ|entries| of the same
    entries summed in f64 — the part of the certificate envelope e_k
    (``ann/ivf_pq.py``) that covers the order of the sum — for every row of
    the slab and every query."""
    index, ops, _, _ = case
    R = index.codes.shape[0]
    K = 1 << index.pq_bits
    got = k5.adc_sum(ops["lut"], index.codes, torch.arange(R), S,
                     index.pq_bits)
    code_idx = k5.decode_codes(index.codes, S, index.pq_bits) \
        + torch.arange(S) * K
    terms = ops["lut"].double()[:, code_idx]            # [nq, R, S]
    tol = S * 2.0 ** -24 * terms.abs().sum(2)
    assert bool(((got.double() - terms.sum(2)).abs() <= tol).all())
