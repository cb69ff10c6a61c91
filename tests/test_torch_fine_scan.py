"""Parity of the port's K4 twins (raft_tpu_torch.ops.fine_scan) with the
reference's list-major fine-scan kernels (Pallas, interpret mode on the
CPU), on one schedule and one set of operands.

The reference scores with bf16 hi/lo products and MXU-contracted norms;
the twin in f32. Their difference is bounded by the reference kernel's
own envelope, (2⁻¹³ + d·2⁻²²)·(‖x‖ + max‖y‖)² per query, which is the
stated tolerance for the pooled values. A slot's ids may differ only
where the two candidates' exact (f64) scores lie within twice that
envelope of each other, which the test proves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ann import build_ivf_flat as j_build
from raft_tpu.ann import build_list_schedule as j_schedule
from raft_tpu.ann.ivf_flat import _coarse_probe as j_probe
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.ops import fine_scan_pallas as jfs
from raft_tpu_torch.ops import fine_scan as tfs

M, D, NQ, L, P, K = 3000, 32, 64, 12, 3, 10


@pytest.fixture(scope="module")
def case():
    """A reference IVF index (f32 and int8), 64 queries, their probe
    table padded to the kernel envelope and the schedule built from it."""
    rng = np.random.default_rng(29)
    centers = rng.uniform(-10, 10, (8, D)).astype(np.float32)
    X = (centers[rng.integers(0, 8, M)]
         + rng.normal(0, 1.5, (M, D))).astype(np.float32)
    Q = (X[rng.choice(M, NQ, replace=False)]
         + rng.normal(0, 0.1, (NQ, D))).astype(np.float32)
    res = JaxResources(seed=4)
    idx = j_build(res, X, n_lists=L, max_iter=5, seed=2)
    idx8 = j_build(res, X, n_lists=L, max_iter=5, seed=2, db_dtype="int8")
    probes = np.asarray(j_probe(res, idx.centroids, Q, P))
    pp = np.full((NQ, 128), -2, np.int32)
    pp[:, :P] = probes
    xx = (Q * Q).sum(1, keepdims=True).astype(np.float32)
    return Q, xx, pp, idx, idx8


def _envelope(x, y_rows):
    ymax = np.sqrt((y_rows.astype(np.float64) ** 2).sum(1).max())
    xn = np.sqrt((x.astype(np.float64) ** 2).sum(1))
    return (2.0 ** -13 + x.shape[1] * 2.0 ** -22) * (xn + ymax) ** 2


def _d2(x, rows_f32, i):
    """Exact f64 squared distances of query rows to slab rows ``i``
    (inf where i = −1)."""
    y = rows_f32[np.maximum(i, 0)].astype(np.float64)
    d2 = ((x.astype(np.float64)[:, None, :] - y) ** 2).sum(2)
    return np.where(i >= 0, d2, np.inf)


def _assert_pools_match(mine, ref, x, y_deq, tol):
    a1, i1, a2, i2, a3 = (t.numpy() for t in mine)
    r1, j1, r2, j2, r3 = (np.asarray(t) for t in ref)
    for a, r in ((a1, r1), (a2, r2), (a3, r3)):
        fin = np.isfinite(r)
        assert np.array_equal(fin, np.isfinite(a))
        assert np.all(np.abs(np.where(fin, a - r, 0.0)) <= tol[:, None])
    for i, j in ((i1, j1), (i2, j2)):
        diff = i != j
        assert diff.mean() <= 0.01
        # a differing slot must be a near-tie of the two candidates
        q = np.nonzero(diff)[0]
        gap = np.abs(_d2(x[q], y_deq, i[diff][:, None])[:, 0]
                     - _d2(x[q], y_deq, j[diff][:, None])[:, 0])
        assert np.all(gap <= 2 * tol[q] + 1e-6)


def test_twin_matches_reference_f32(case):
    Q, xx, pp, idx, _ = case
    sch = j_schedule(idx, pp[:, :P])
    Wk = jfs.pad_window(idx.probe_window)
    slab = np.array(idx.slab)
    ref = jfs.fine_scan_list_major(jnp.asarray(sch.sched), jnp.asarray(Q),
                                   jnp.asarray(xx), jnp.asarray(pp),
                                   idx.slab, Wk=Wk)
    before = tfs.LAUNCHES
    mine = tfs.fine_scan_list_major(
        torch.from_numpy(sch.sched), torch.from_numpy(Q),
        torch.from_numpy(xx), torch.from_numpy(pp), torch.from_numpy(slab),
        Wk)
    assert tfs.LAUNCHES == before          # a CPU tensor takes the twin
    assert all(t.shape == (NQ, 128) for t in mine)
    assert mine[1].dtype == torch.int32 and mine[0].dtype == torch.float32
    _assert_pools_match(mine, ref, Q, slab, _envelope(Q, slab))


def test_twin_matches_reference_int8(case):
    Q, xx, pp, _, idx8 = case
    sch = j_schedule(idx8, pp[:, :P])
    Wk = jfs.pad_window(idx8.probe_window)
    slab_q = np.array(idx8.slab_q)
    ref = jfs.fine_scan_list_major_q8(
        jnp.asarray(sch.sched), jnp.asarray(sch.scale_l), jnp.asarray(Q),
        jnp.asarray(xx), jnp.asarray(pp), jnp.asarray(slab_q), Wk=Wk)
    before = tfs.LAUNCHES_Q8
    mine = tfs.fine_scan_list_major_q8(
        torch.from_numpy(sch.sched), torch.from_numpy(sch.scale_l),
        torch.from_numpy(Q), torch.from_numpy(xx), torch.from_numpy(pp),
        torch.from_numpy(slab_q), Wk)
    assert tfs.LAUNCHES_Q8 == before
    deq = slab_q.astype(np.float32) * np.asarray(idx8.row_scale)[:, None]
    _assert_pools_match(mine, ref, Q, deq, _envelope(Q, deq))


def test_twin_masks_non_members_and_pads(case):
    """Queries with only pad probes pool nothing; every pooled row belongs
    to a list the query probes."""
    Q, xx, pp, idx, _ = case
    pp = pp.copy()
    pp[:8] = -2
    sch = j_schedule(idx, pp[8:, :P])
    Wk = jfs.pad_window(idx.probe_window)
    a1, i1, a2, i2, a3 = tfs.fine_scan_list_major_ref(
        torch.from_numpy(sch.sched), torch.from_numpy(Q),
        torch.from_numpy(xx), torch.from_numpy(pp),
        torch.from_numpy(np.array(idx.slab)), Wk)
    assert torch.all(torch.isinf(a1[:8])) and torch.all(i1[:8] == -1)
    rows = i1[8:].numpy()
    owner = np.searchsorted(np.asarray(idx.offsets), rows, side="right") - 1
    for q in range(NQ - 8):
        hit = rows[q] >= 0
        assert hit.any() and np.isin(owner[q][hit], pp[8 + q, :P]).all()
    assert torch.all(a1 <= a2) and torch.all(a2 <= a3)


def test_member_table_inverts_the_probe_table(case):
    """The kernel's device-side inversion (``_members``): entry j owns
    exactly the (query, column) pairs whose probe is its list, each query's
    entries ascend, and a repeated probe is pooled once."""
    _, _, pp, idx, _ = case
    pp = pp[:, :P].copy()
    pp[0, 1] = pp[0, 0]                         # a repeated probe
    pp[1, 2] = -2                               # a pad probe
    sch = j_schedule(idx, pp)
    sched = torch.from_numpy(sch.sched)
    js, order, seg = tfs._members(sched, torch.from_numpy(pp))
    lids = sch.sched[3]
    js, order, seg = js.numpy(), order.numpy(), seg.numpy()
    for q in range(NQ):
        want = sorted({int(np.nonzero(lids == l)[0][0])
                       for l in pp[q] if l >= 0})
        got = js[q][js[q] >= 0].tolist()
        assert got == want
        assert np.all(np.diff(js[q][js[q] >= 0]) > 0)
    for j in range(sched.shape[1]):
        parts = order[seg[j]:seg[j + 1]]
        assert np.all(js.reshape(-1)[parts] == j)
    assert seg[-1] == (js >= 0).sum()


def test_pad_window_and_chunk():
    assert tfs.pad_window(1) == 128 and tfs.pad_window(129) == 256
    assert tfs.pad_window(256) == 256
    assert tfs.max_list_chunk(128) >= 2048     # the batch fits one call
    with pytest.raises(ValueError):
        tfs.fine_scan_list_major(torch.zeros(4, 5, dtype=torch.int32),
                                 torch.zeros(8, 4), torch.zeros(8),
                                 torch.zeros(8, 3, dtype=torch.int32),
                                 torch.zeros(256, 4), 128)


@pytest.mark.parametrize("plant", ["slab", "queries"])
def test_nonfinite_rows_never_reach_the_pools(case, plant):
    """NaN and ±inf planted in probed slab rows (or in query rows): every
    score they make is NaN or +inf, which loses each strict < of the
    reference's fold (``fine_scan_pallas.py:148-155``) and of the twin's,
    so no NaN ever enters a1, a2 or a3 and no pool names a planted row;
    the kernel's partial merge, fed only such pools, takes its min of a3
    over non-NaN values. The pools still match the reference's."""
    Q, xx, pp, idx, _ = case
    Q = Q.copy()
    slab = np.array(idx.slab)
    sch = j_schedule(idx, pp[:, :P])
    Wk = jfs.pad_window(idx.probe_window)
    offsets, sizes = np.asarray(idx.offsets), np.asarray(idx.sizes)
    planted = []
    if plant == "slab":
        lids = [l for l in np.unique(pp[:4, :P]) if l >= 0 and sizes[l]]
        for n, lid in enumerate(lids):
            r = int(offsets[lid]) + n % int(sizes[lid])
            slab[r, n % D] = (np.nan, np.inf, -np.inf)[n % 3]
            planted.append(r)
        assert len(planted) >= 3
    else:
        Q[5, 3], Q[9, 0], Q[20, 7] = np.nan, np.inf, -np.inf
    with np.errstate(over="ignore", invalid="ignore"):
        xx = (Q * Q).sum(1, keepdims=True).astype(np.float32)
    ref = jfs.fine_scan_list_major(jnp.asarray(sch.sched), jnp.asarray(Q),
                                   jnp.asarray(xx), jnp.asarray(pp),
                                   jnp.asarray(slab), Wk=Wk)
    mine = tfs.fine_scan_list_major(
        torch.from_numpy(sch.sched), torch.from_numpy(Q),
        torch.from_numpy(xx), torch.from_numpy(pp), torch.from_numpy(slab),
        Wk)
    for pools in (mine, [torch.from_numpy(np.array(t)) for t in ref]):
        a1, i1, a2, i2, a3 = pools
        assert not any(bool(a.isnan().any()) for a in (a1, a2, a3))
        assert not np.isin(torch.cat([i1, i2]).numpy(), planted).any()
        assert bool((a1 <= a2).all() and (a2 <= a3).all())
    live = np.isfinite(Q).all(1)
    if plant == "queries":
        a1, i1 = mine[0].numpy(), mine[1].numpy()
        assert np.isposinf(a1[~live]).all() and (i1[~live] == -1).all()
    rows = np.isfinite(slab).all(1)
    tol = np.where(live, _envelope(np.where(live[:, None], Q, 0.0),
                                   slab[rows]), np.inf)
    _assert_pools_match(mine, ref, np.where(live[:, None], Q, 0.0), slab,
                        tol)
