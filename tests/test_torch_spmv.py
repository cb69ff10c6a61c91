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
    # the SpMM column slice fits its shared-memory budget
    for R, E, V in ((256, 2048, 16), (256, 2048, 128), (256, 2048, 512),
                    (64, 512, 33)):
        vc = k6.spmm_column_slice(R, E, V)
        assert 1 <= vc <= V and 4 * R * vc + 12 * E <= k6.SPMM_SMEM


def test_cpu_twins_launch_no_kernel():
    before = (k6.LAUNCHES_SPMV, k6.LAUNCHES_PAIR, k6.LAUNCHES_SPMM)
    m = _matrix(200, 150, 0.05)
    _, T = _both(m)
    tl.spmv(None, tl.prepare_spmv(T, C=128, R=64, E=512), np.ones(150))
    tl.spmm(None, tl.prepare_spmv(T, C=128, R=64, E=512), np.ones((150, 2)))
    tl.spmv(None, tl.prepare_spmv(T, C=128, R=64, E=512, layout="pairs"),
            np.ones(150))
    assert (k6.LAUNCHES_SPMV, k6.LAUNCHES_PAIR, k6.LAUNCHES_SPMM) == before
