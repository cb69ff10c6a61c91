"""Parity of the port's K6 twins (raft_tpu_torch.ops.spmv: tiled-ELL SpMV,
pair-tiled SpMV, tiled-ELL SpMM) with the reference's Pallas kernels
(interpret mode on the CPU) and with a scipy f64 oracle.

Tolerances. K6a/K6b sum in f32 in another order than the reference: per
row ``(nnz_i + 2)·2⁻²⁴·Σ_j |a_ij·x_j|``, against the reference and against
the exact (f64) product alike. K6c: the port sums in f32, the reference's
one-hot selects run at bf16×3 (≈ 2⁻¹⁶ relative, ``spmv_pallas.py:283``),
so against the reference ``2⁻¹⁵·Σ_j |a_ij·b_jv|`` and against f64 the f32
bound.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu.ops import spmv_pallas as jk
from raft_tpu.sparse import COOMatrix as JCOO
from raft_tpu.sparse import linalg as jl
from raft_tpu.sparse import tiled as jt
from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.ops import spmv as k6
from raft_tpu_torch.sparse import linalg as tl
from raft_tpu_torch.sparse import tiled as tt
from _torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(17)


def _matrix(n_rows, n_cols, density, pattern="uniform", seed=3):
    if pattern == "powerlaw":
        r_ = np.random.default_rng(seed)
        nnz = int(n_rows * n_cols * density)
        r = (n_rows * r_.power(0.25, nnz)).astype(np.int64) % n_rows
        c = (n_cols * r_.power(0.25, nnz)).astype(np.int64) % n_cols
        v = r_.normal(size=nnz).astype(np.float32)
        m = sp.coo_matrix((v, (r, c)), shape=(n_rows, n_cols)).tocsr()
        m.sum_duplicates()
        return m
    return sp.random(n_rows, n_cols, density=density, random_state=seed,
                     dtype=np.float32, format="csr")


def _both(m):
    """The reference's matrix as COO in CSR entry order (the same layouts
    without compiling its ``row_ids`` per nnz), the port's as CSR."""
    ip, ix = m.indptr.astype(np.int32), m.indices.astype(np.int32)
    v = m.data.astype(np.float32)
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int32), np.diff(ip))
    return (JCOO(rows, ix, v, m.shape),
            CSRMatrix.from_numpy(ip, ix, v, m.shape, device="cpu"))


def _bound(m, X):
    """Per-row (per-column of X) f32 bound (nnz_i + 2)·2⁻²⁴·Σ|a_ij·x_j|."""
    a = abs(m).astype(np.float64)
    nnz_i = np.diff(m.indptr)[:, None]
    X = np.abs(np.asarray(X, np.float64)).reshape(m.shape[1], -1)
    return (nnz_i + 2) * 2.0 ** -24 * (a @ X)


def _f64(m, X):
    return (m.astype(np.float64) @ np.asarray(X, np.float64).reshape(
        m.shape[1], -1))


CASES = [
    (1000, 700, 0.01, "uniform"),       # rectangular
    (800, 800, 0.01, "powerlaw"),       # skewed degrees
    (100, 100, 0.3, "uniform"),         # dense-ish
]


@pytest.mark.parametrize("n_rows,n_cols,density,pattern", CASES)
def test_spmv_tiled_twin_matches_reference_and_f64(n_rows, n_cols, density,
                                                   pattern):
    m = _matrix(n_rows, n_cols, density, pattern)
    J, T = _both(m)
    x = rng.normal(size=n_cols).astype(np.float32)
    ref = np.asarray(jk.spmv_tiled(jt.tile_csr(J, C=128, R=64, E=512,
                                               impl="numpy"), x))
    tiled = tl.prepare_spmv(T, C=128, R=64, E=512)
    y = tl.spmv(None, tiled, torch.from_numpy(x)).numpy()
    tol = _bound(m, x)[:, 0]
    assert np.all(np.abs(y - ref) <= tol)
    assert np.all(np.abs(y - _f64(m, x)[:, 0]) <= tol)
    # the twin on the reference's own layout, carried across
    y2 = k6.spmv_tiled(tt.TiledELL.from_numpy(
        jt.tile_csr(J, C=128, R=64, E=512, impl="numpy"), device="cpu"), x)
    assert np.all(np.abs(y2.numpy() - ref) <= tol)
    # and the CSR path
    y3 = tl.spmv(None, T, torch.from_numpy(x)).numpy()
    assert np.all(np.abs(y3 - _f64(m, x)[:, 0]) <= tol)


@pytest.mark.parametrize("n_rows,n_cols,density,pattern", CASES)
def test_spmv_pair_tiled_twin_matches_reference(n_rows, n_cols, density,
                                                pattern):
    m = _matrix(n_rows, n_cols, density, pattern)
    J, T = _both(m)
    x = rng.normal(size=n_cols).astype(np.float32)
    jp = jt.tile_csr_pairs(J, R=64, C=128, E=512, impl="numpy")
    ref = np.asarray(jk.spmv_pair_tiled(jp, x))
    tp = tl.prepare_spmv(T, C=128, R=64, E=512, layout="pairs")
    assert isinstance(tp, tt.TiledPairsSpmv)
    y = tl.spmv(None, tp, x).numpy()
    tol = _bound(m, x)[:, 0]
    assert np.all(np.abs(y - ref) <= tol)
    assert np.all(np.abs(y - _f64(m, x)[:, 0]) <= tol)
    y2 = k6.spmv_pair_tiled(tt.TiledPairsSpmv.from_numpy(jp, device="cpu"),
                            x)
    assert np.all(np.abs(y2.numpy() - ref) <= tol)


def test_unvisited_row_tiles_and_empty_matrix():
    """Row tiles that hold no chunk read 0; so does an empty matrix."""
    m = sp.random(300, 150, density=0.05, random_state=5, dtype=np.float32,
                  format="lil")
    m[64:192, :] = 0                    # row tiles 1 and 2 (R = 64) empty
    m = m.tocsr()
    m.eliminate_zeros()
    J, T = _both(m)
    x = rng.normal(size=150).astype(np.float32)
    for layout in ("ell", "pairs"):
        t = tl.prepare_spmv(T, C=128, R=64, E=512, layout=layout)
        vis = (t.visited_row_tiles if layout == "ell" else t.visited)
        assert vis.tolist() == [True, False, False, True, True]
        y = tl.spmv(None, t, x).numpy()
        assert np.all(y[64:192] == 0)
        ref = np.asarray(jl.spmv(None, jl.prepare_spmv(
            J, C=128, R=64, E=512, layout=layout), x))
        assert np.all(np.abs(y - ref) <= _bound(m, x)[:, 0])
    empty = CSRMatrix.from_numpy(np.zeros(31, np.int32),
                                 np.zeros(0, np.int32),
                                 np.zeros(0, np.float32), (30, 40),
                                 device="cpu")
    ye = tl.spmv(None, tl.prepare_spmv(empty, C=128, R=64, E=512),
                 rng.normal(size=40).astype(np.float32))
    assert torch.equal(ye, torch.zeros(30))


@pytest.mark.parametrize("V", [1, 33])
@pytest.mark.parametrize("pattern", ["uniform", "powerlaw"])
def test_spmm_tiled_twin_matches_reference(V, pattern):
    m = _matrix(600, 500, 0.02, pattern)
    J, T = _both(m)
    B = rng.normal(size=(500, V)).astype(np.float32)
    ref = np.asarray(jk.spmm_tiled(jt.tile_csr(J, C=128, R=64, E=512,
                                               impl="numpy"), B))
    tiled = tl.prepare_spmv(T, C=128, R=64, E=512)
    Y = tl.spmm(None, tiled, torch.from_numpy(B)).numpy()
    assert Y.shape == (600, V)
    scale = abs(m).astype(np.float64) @ np.abs(B.astype(np.float64))
    assert np.all(np.abs(Y - ref) <= 2.0 ** -15 * scale)
    assert np.all(np.abs(Y - _f64(m, B)) <= _bound(m, B))
    # alpha / beta epilogue and the CSR path
    C0 = rng.normal(size=(600, V)).astype(np.float32)
    Y2 = tl.spmm(None, tiled, B, alpha=2.0, beta=0.5, C=C0).numpy()
    np.testing.assert_allclose(Y2, 2.0 * Y + 0.5 * C0, rtol=1e-6, atol=1e-6)
    Y3 = tl.spmm(None, T, torch.from_numpy(B)).numpy()
    assert np.all(np.abs(Y3 - _f64(m, B)) <= _bound(m, B))


def test_spmm_v_envelope_and_validation():
    m = _matrix(200, 150, 0.05)
    J, T = _both(m)
    tiled = tl.prepare_spmv(T, C=128, R=64, E=512)
    with pytest.raises(NotImplementedError):
        jk.spmm_tiled(jt.tile_csr(J, C=128, R=64, E=512, impl="numpy"),
                      np.zeros((150, 513), np.float32))
    with pytest.raises(NotImplementedError):
        k6.spmm_tiled(tiled, torch.zeros(150, 513))
    Y = k6.spmm_tiled(tiled, torch.ones(150, 512))   # the edge of it
    assert Y.shape == (200, 512)
    with pytest.raises(ValueError):
        k6.spmm_tiled(tiled, torch.zeros(149, 4))
    with pytest.raises(ValueError):
        k6.spmv_tiled(tiled, torch.zeros(149))
    with pytest.raises(TypeError):
        tl.spmm(None, tl.prepare_spmv(T, C=128, R=64, E=512,
                                      layout="pairs"), np.zeros((150, 2)))
    # the SpMM block's column slice and tile fit its shared-memory budget
    for R, V, vector in ((256, 16, True), (256, 128, True), (256, 512, True),
                         (64, 33, True), (256, 33, True), (256, 12, False),
                         (1024, 128, True), (64, 1, True)):
        VC, W, QP = k6.spmm_geometry(R, V, vector)
        assert 1 <= VC <= min(V, W * QP) and 4 * R * W * QP <= k6.SPMM_SMEM
        assert W == (4 if vector and V % 4 == 0 else 1)
        assert QP & (QP - 1) == 0 and 32 % QP == 0
    assert k6.spmm_geometry(256, 128, True) == (64, 4, 16)  # 2 slices
    assert k6.spmm_geometry(256, 16, True) == (16, 4, 4)
    assert k6.spmm_geometry(256, 33, True) == (32, 1, 32)   # scalar tail


def test_cpu_twins_launch_no_kernel():
    before = (k6.LAUNCHES_SPMV, k6.LAUNCHES_PAIR, k6.LAUNCHES_SPMM)
    m = _matrix(200, 150, 0.05)
    _, T = _both(m)
    tl.spmv(None, tl.prepare_spmv(T, C=128, R=64, E=512), np.ones(150))
    tl.spmm(None, tl.prepare_spmv(T, C=128, R=64, E=512), np.ones((150, 2)))
    tl.spmv(None, tl.prepare_spmv(T, C=128, R=64, E=512, layout="pairs"),
            np.ones(150))
    assert (k6.LAUNCHES_SPMV, k6.LAUNCHES_PAIR, k6.LAUNCHES_SPMM) == before


def _item_walk(t, B):
    """K6c's schedule in plain torch: the row tiles of ``zero_tiles`` start
    at 0 and the rest hold NaN; each work item sums its chunks' slots into
    an [R, V] tile (the twin's arithmetic) and stores it when it holds its
    row tile whole, or adds it."""
    R, E, V = t.R, t.E, B.shape[1]
    Y = torch.full((t.n_row_tiles * R, V), float("nan"))
    Y.view(t.n_row_tiles, R * V)[t.zero_tiles] = 0.0
    ic, split = t.item_chunk0.tolist(), t.item_split.tolist()
    zero_row = t.n_chunks * E // 8
    vals, cl = t.vals.reshape(-1), t.col_local.reshape(-1)
    for i in range(len(split)):
        s = torch.arange(ic[i] * E, ic[i + 1] * E)
        pr = t.perm_rows[s // 8].long()
        rl = t.row_local.reshape(-1)[s].long()
        real = (pr < zero_row) & (rl < R)
        g = (pr * 8 + s % 8)[real]
        col = t.chunk_col_tile[g // E].long() * t.C + cl[g]
        tile = torch.zeros((R, V)).index_add_(0, rl[real],
                                              vals[g][:, None] * B[col])
        row0 = int(t.chunk_row_tile[ic[i]]) * R
        if split[i]:
            Y[row0:row0 + R] += tile
        else:
            Y[row0:row0 + R] = tile
    return Y[:t.shape[0]]


@pytest.mark.parametrize("cap", [2, tt.ITEM_CHUNKS])
@pytest.mark.parametrize("V", [1, 4, 33, 128])
def test_spmm_item_walk_matches_twin_and_reference(V, cap):
    """The work items alone compute A @ B: bit for bit the twin's sum on
    integer-valued data, and the reference's spmm_tiled within its bound;
    cap 2 splits the power-law hub tiles, and row tiles 2-3 are empty."""
    m = _matrix(600, 500, 0.03, "powerlaw").tolil()
    m[128:256, :] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    J, T = _both(m)
    t = tl.prepare_spmv(T, C=128, R=64, E=512)
    t = dataclasses.replace(t, **dict(zip(
        ("item_chunk0", "item_split", "zero_tiles"),
        tt.spmm_items(t.chunk_row_tile, t.n_row_tiles, cap))))
    assert t.visited_row_tiles[2:4].tolist() == [False, False]
    if cap == 2:
        assert int(t.item_split.sum()) > 0
    r_ = np.random.default_rng(V)
    ti = dataclasses.replace(t, vals=torch.from_numpy(r_.integers(
        -4, 5, t.vals.shape).astype(np.float32)))
    Bi = torch.from_numpy(r_.integers(-4, 5, (500, V)).astype(np.float32))
    Yw = _item_walk(ti, Bi)
    assert torch.equal(Yw, k6.spmm_tiled_ref(ti, Bi))
    assert torch.equal(Yw[128:256], torch.zeros(128, V))
    B = r_.normal(size=(500, V)).astype(np.float32)
    Y = _item_walk(t, torch.from_numpy(B)).numpy()
    ref = np.asarray(jk.spmm_tiled(jt.tile_csr(J, C=128, R=64, E=512,
                                               impl="numpy"), B))
    scale = abs(m).astype(np.float64) @ np.abs(B.astype(np.float64))
    assert np.all(np.abs(Y - ref) <= 2.0 ** -15 * scale)
    assert np.all(np.abs(Y - _f64(m, B)) <= _bound(m, B))


def _k6a_walk(t, x):
    """K6a's schedule in plain numpy: y from an allocation filled with NaN
    whose ``zero_tiles`` start at 0; each work item's lanes take one 8-slot
    scatter row each (one perm_rows read, 8 consecutive gather slots), pad
    rows and pad slots add nothing, and a run of equal rows among a lane's
    slots is summed before it adds; the item's R tile is stored when it
    holds its row tile whole, else added."""
    R, E, C = t.R, t.E, t.C
    y = np.full(t.n_row_tiles * R, np.nan, np.float32)
    y.reshape(t.n_row_tiles, R)[t.zero_tiles.numpy()] = 0.0
    ic, split = t.item_chunk0.tolist(), t.item_split.tolist()
    zero_row, E8 = t.n_chunks * E // 8, E // 8
    pr_all, rl_all = t.perm_rows.numpy(), t.row_local.numpy().reshape(-1)
    vals, cl = t.vals.numpy().reshape(-1), t.col_local.numpy().reshape(-1)
    cct, xs = t.chunk_col_tile.numpy(), np.asarray(x, np.float32)
    for i in range(len(split)):
        tile = np.zeros(R, np.float32)
        for s in range(ic[i] * E, ic[i + 1] * E, 8):
            pr = int(pr_all[s // 8])
            if pr >= zero_row:
                continue
            g = pr * 8
            rl = rl_all[s:s + 8]
            p = vals[g:g + 8] * xs[cct[pr // E8] * C + cl[g:g + 8]]
            adds = []
            for r, v in zip(rl.tolist(), p.tolist()):
                if adds and adds[-1][0] == r:
                    adds[-1][1] = np.float32(adds[-1][1] + np.float32(v))
                else:
                    adds.append([r, np.float32(v)])
            for r, v in adds:
                if r < R:
                    tile[r] += v
        row0 = int(t.chunk_row_tile[ic[i]]) * R
        if split[i]:
            y[row0:row0 + R] += tile
        else:
            y[row0:row0 + R] = tile
    return torch.from_numpy(y[:t.shape[0]])


@pytest.fixture(scope="module")
def hub_matrix():
    """A power-law matrix (its hub row tiles hold many chunks) with rows
    128-255 empty (row tiles 2-3 at R = 64), and one x."""
    m = _matrix(600, 500, 0.03, "powerlaw").tolil()
    m[128:256, :] = 0
    m = m.tocsr()
    m.eliminate_zeros()
    x = np.random.default_rng(23).normal(size=500).astype(np.float32)
    return m, x


@pytest.mark.parametrize("C,E", [(128, 512), (256, 512), (128, 1024),
                                 (512, 1024)])
@pytest.mark.parametrize("cap", [2, tt.ITEM_CHUNKS])
def test_spmv_item_walk_matches_twin_and_reference(hub_matrix, cap, C, E):
    """K6a's walk over the work items alone computes A @ x, at several
    column tiles C and chunk lengths E: bit for bit the twin's sum on
    integer-valued data (every summation order is exact there), and the
    reference's spmv_tiled (interpret mode) and the f64 product within
    the stated bound; cap 2 splits the hub tiles, whose split items add,
    and the empty row tiles 2-3 read 0 from a NaN-filled allocation."""
    m, x = hub_matrix
    J, T = _both(m)
    t = tl.prepare_spmv(T, C=C, R=64, E=E)
    t = dataclasses.replace(t, **dict(zip(
        ("item_chunk0", "item_split", "zero_tiles"),
        tt.spmm_items(t.chunk_row_tile, t.n_row_tiles, cap))))
    assert t.visited_row_tiles[2:4].tolist() == [False, False]
    assert {2, 3} <= set(t.zero_tiles.tolist())
    if cap == 2:
        assert int(t.item_split.sum()) > 0
    r_ = np.random.default_rng(cap + C + E)
    ti = dataclasses.replace(t, vals=torch.from_numpy(r_.integers(
        -4, 5, t.vals.shape).astype(np.float32)))
    xi = r_.integers(-4, 5, 500).astype(np.float32)
    yw = _k6a_walk(ti, xi)
    assert torch.equal(yw, k6.spmv_tiled_ref(ti, xi))
    assert torch.equal(yw[128:256], torch.zeros(128))
    y = _k6a_walk(t, x).numpy()
    ref = np.asarray(jk.spmv_tiled(jt.tile_csr(J, C=C, R=64, E=E,
                                               impl="numpy"), x))
    tol = _bound(m, x)[:, 0]
    assert np.all(np.abs(y - ref) <= tol)
    assert np.all(np.abs(y - _f64(m, x)[:, 0]) <= tol)


def test_spmv_item_walk_of_an_empty_matrix_reads_zeros():
    """A matrix with no entries is laid out as one chunk of pad slots:
    its one item stores row tile 0 whole (pads add nothing), the other
    row tiles are zero tiles, so y reads 0 from a NaN-filled allocation,
    as the twin's product."""
    m = sp.csr_matrix((300, 200), dtype=np.float32)
    _, T = _both(m)
    t = tl.prepare_spmv(T, C=128, R=64, E=512)
    assert t.item_chunk0.tolist() == [0, 1] and t.item_split.tolist() == [0]
    assert t.zero_tiles.tolist() == list(range(1, t.n_row_tiles))
    x = np.ones(200, np.float32)
    assert torch.equal(_k6a_walk(t, x), torch.zeros(300))
    assert torch.equal(k6.spmv_tiled(t, x), torch.zeros(300))


def test_pair_envelope_limits_the_kernel_not_the_twin():
    """Tilings whose locals do not fit 16 bits, or whose x and y tiles do
    not fit a block's shared memory, are refused for the kernel
    (``_check_pairs``, called before a card launch); the CPU twin answers
    them."""
    m = sp.random(300, 200, density=0.05, random_state=4, dtype=np.float32,
                  format="csr")
    _, T = _both(m)
    x = np.ones(200, np.float32)
    y_f64, bound = _f64(m, x)[:, 0], _bound(m, x)[:, 0]
    for R, C, match in ((65536, 128, "16 bits"), (64, 65664, "16 bits"),
                        (64, 65536, "shared memory")):
        t = tt.tile_csr_pairs(T, R=R, C=C, E=512)
        assert (t.rowcol is None) == (match == "16 bits")
        with pytest.raises(ValueError, match=match):
            k6._check_pairs(t)
        y = k6.spmv_pair_tiled(t, x)
        assert np.all(np.abs(y.numpy() - y_f64) <= bound)
    t = tt.tile_csr_pairs(T, R=64, C=57344, E=512)
    k6._check_pairs(t)
    assert np.all(np.abs(k6.spmv_pair_tiled(t, x).numpy() - y_f64) <= bound)
