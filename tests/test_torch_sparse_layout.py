"""The port's tiled layouts (raft_tpu_torch.sparse.tiled) against the
reference's ``impl="numpy"`` host pass: every array bit-identical, on
uniform, rectangular, power-law, empty-row, empty and dense-ish matrices,
and the same validation errors."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu.sparse import COOMatrix as JCOO
from raft_tpu.sparse import tiled as jt
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse import tiled as tt
from _torch_threads import one_torch_thread  # noqa: F401

ELL_FIELDS = ("vals", "col_local", "chunk_col_tile", "perm_rows",
              "row_local", "chunk_row_tile", "visited_row_tiles")
PAIR_FIELDS = ("row_local", "col_local", "chunk_row_tile", "chunk_col_tile",
               "pos", "rows", "cols")


def _matrix(pattern: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    if pattern == "uniform":
        return sp.random(500, 500, density=0.02, random_state=seed,
                         dtype=np.float32, format="csr")
    if pattern == "rectangular":
        return sp.random(1000, 700, density=0.01, random_state=seed,
                         dtype=np.float32, format="csr")
    if pattern == "powerlaw":
        nnz = 6400
        r = (800 * rng.power(0.25, nnz)).astype(np.int64) % 800
        c = (800 * rng.power(0.25, nnz)).astype(np.int64) % 800
        v = rng.normal(size=nnz).astype(np.float32)
        m = sp.coo_matrix((v, (r, c)), shape=(800, 800)).tocsr()
        m.sum_duplicates()
        return m
    if pattern == "empty_rows":
        m = sp.random(200, 150, density=0.05, random_state=seed,
                      dtype=np.float32, format="lil")
        m[10:20, :] = 0
        m = m.tocsr()
        m.eliminate_zeros()
        return m
    if pattern == "empty":
        return sp.csr_matrix((30, 40), dtype=np.float32)
    assert pattern == "dense"
    return sp.random(100, 100, density=0.3, random_state=seed,
                     dtype=np.float32, format="csr")


def _pair(m):
    """The reference's matrix as COO in CSR entry order (its CSR
    ``row_ids`` compiles once per nnz: the layouts are the same), the
    port's as CSR."""
    ip = m.indptr.astype(np.int32)
    ix = m.indices.astype(np.int32)
    v = m.data.astype(np.float32)
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int32), np.diff(ip))
    return (JCOO(rows, ix, v, m.shape),
            CSRMatrix.from_numpy(ip, ix, v, m.shape, device="cpu"))


def _same(a, b, fields):
    for f in fields:
        x = np.asarray(getattr(a, f))
        y = getattr(b, f).numpy()
        assert x.dtype == y.dtype, f
        assert x.shape == y.shape, (f, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f)


PATTERNS = ["uniform", "rectangular", "powerlaw", "empty_rows", "empty",
            "dense"]
TILES = [(128, 64, 512), (256, 8, 1024)]


@pytest.mark.parametrize("C,R,E", TILES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_tile_csr_bit_identical(pattern, C, R, E):
    J, T = _pair(_matrix(pattern))
    a = jt.tile_csr(J, C=C, R=R, E=E, impl="numpy")
    b = tt.tile_csr(T, C=C, R=R, E=E)
    _same(a, b, ELL_FIELDS)
    assert (a.shape, a.C, a.R, a.E, a.n_col_tiles, a.n_row_tiles) == (
        b.shape, b.C, b.R, b.E, b.n_col_tiles, b.n_row_tiles)


@pytest.mark.parametrize("C,R,E", TILES)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_tile_pairs_and_csr_pairs_bit_identical(pattern, C, R, E):
    J, T = _pair(_matrix(pattern))
    a = jt.tile_pairs(J, R=R, C=C, E=E, impl="numpy")
    b = tt.tile_pairs(T, R=R, C=C, E=E)
    _same(a, b, PAIR_FIELDS)
    assert (a.n_row_tiles, a.n_col_tiles) == (b.n_row_tiles, b.n_col_tiles)
    a = jt.tile_csr_pairs(J, R=R, C=C, E=E, impl="numpy")
    b = tt.tile_csr_pairs(T, R=R, C=C, E=E)
    _same(a.pairs, b.pairs, PAIR_FIELDS)
    np.testing.assert_array_equal(
        np.asarray(a.vals).reshape(b.vals.shape), b.vals.numpy())
    np.testing.assert_array_equal(np.asarray(a.visited), b.visited.numpy())


def test_coo_input_with_duplicates_bit_identical():
    """Unsorted COO with duplicate entries: the within-bucket input order
    and the duplicates survive as the reference's do."""
    rng = np.random.default_rng(5)
    r = rng.integers(0, 300, 4000).astype(np.int32)
    c = rng.integers(0, 260, 4000).astype(np.int32)
    v = rng.normal(size=4000).astype(np.float32)
    J = JCOO(r, c, v, (300, 260))
    T = COOMatrix.from_numpy(r, c, v, (300, 260), device="cpu")
    _same(jt.tile_csr(J, C=128, R=64, E=512, impl="numpy"),
          tt.tile_csr(T, C=128, R=64, E=512), ELL_FIELDS)
    _same(jt.tile_pairs(J, R=64, C=128, E=512, impl="numpy"),
          tt.tile_pairs(T, R=64, C=128, E=512), PAIR_FIELDS)


def test_from_numpy_carries_the_reference_layout():
    J, T = _pair(_matrix("powerlaw"))
    a = jt.tile_csr(J, C=128, R=64, E=512, impl="numpy")
    _same(a, tt.TiledELL.from_numpy(a, device="cpu"), ELL_FIELDS)
    p = jt.tile_csr_pairs(J, R=64, C=128, E=512, impl="numpy")
    q = tt.TiledPairsSpmv.from_numpy(p, device="cpu")
    _same(p.pairs, q.pairs, PAIR_FIELDS)
    assert q.vals.shape == (q.pairs.m_chunks, q.pairs.E)


def _raises_like(fn_ref, fn_port):
    with pytest.raises(Exception) as e_ref:
        fn_ref()
    with pytest.raises(Exception) as e_port:
        fn_port()
    assert type(e_port.value) is type(e_ref.value)
    assert str(e_port.value) == str(e_ref.value)


@pytest.mark.parametrize("C,R,E", [(100, 64, 512), (128, 60, 512),
                                   (128, 64, 500)])
def test_alignment_errors_match(C, R, E):
    J, T = _pair(_matrix("uniform"))
    _raises_like(lambda: jt.tile_csr(J, C=C, R=R, E=E, impl="numpy"),
                 lambda: tt.tile_csr(T, C=C, R=R, E=E))
    _raises_like(lambda: jt.tile_pairs(J, R=R, C=C, E=E, impl="numpy"),
                 lambda: tt.tile_pairs(T, R=R, C=C, E=E))


def test_range_type_and_impl_errors_match():
    r = np.array([0, 5], np.int32)
    c = np.array([0, 1], np.int32)
    v = np.ones(2, np.float32)
    J = JCOO(r, c, v, (4, 4))
    T = COOMatrix.from_numpy(r, c, v, (4, 4), device="cpu")
    _raises_like(lambda: jt.tile_csr(J, C=128, R=8, E=512, impl="numpy"),
                 lambda: tt.tile_csr(T, C=128, R=8, E=512))
    _raises_like(lambda: jt.tile_pairs(J, R=8, C=128, E=512, impl="numpy"),
                 lambda: tt.tile_pairs(T, R=8, C=128, E=512))
    _raises_like(lambda: jt.tile_pairs(np.eye(4), impl="numpy"),
                 lambda: tt.tile_pairs(np.eye(4)))
    _raises_like(lambda: jt.tile_csr(J, impl="bogus"),
                 lambda: tt.tile_csr(T, impl="bogus"))
    _raises_like(lambda: jt.tile_pairs(J, impl="native"),
                 lambda: tt.tile_pairs(T, impl="native"))
    with pytest.raises(NotImplementedError, match="native"):
        tt.tile_csr(T, C=128, R=8, E=512, impl="native")


def test_layout_runs_on_the_matrix_device_and_defaults_to_cuda():
    m = _matrix("uniform")
    ip, ix, v = (m.indptr.astype(np.int32), m.indices.astype(np.int32),
                 m.data.astype(np.float32))
    t = tt.tile_csr(CSRMatrix(torch.from_numpy(ip), torch.from_numpy(ix),
                              torch.from_numpy(v), m.shape))
    assert t.device.type == "cpu"
    if not torch.cuda.is_available():
        from raft_tpu_torch.core import DeviceError

        with pytest.raises(DeviceError):
            tt.tile_csr(CSRMatrix(ip, ix, v, m.shape))
        t2 = tt.tile_csr(CSRMatrix(ip, ix, v, m.shape), device="cpu")
        _same(t, t2, ELL_FIELDS)
