"""Parity of the port's sparse linalg, conversions, ops and matrix ops
(raft_tpu_torch.sparse.{linalg,convert,op,matrix}) with the reference on
the CPU.

Structure (indptr, indices, nnz, degree) must be equal. Values are exact
where both packages do the same f32 operations on the same inputs
(gathers, coalesced sums of at most two terms of integer-valued weights,
the same elementwise formula); sums over a row may differ in order and are
held to ``(n + 2)·2⁻²⁴·Σ|terms|``, n the row's nonzeros.
"""

import numpy as np
import pytest
import torch

from raft_tpu.core.sparse_types import COOMatrix as JCOO
from raft_tpu.linalg import NormType as JNorm
from raft_tpu.sparse import convert as jc
from raft_tpu.sparse import linalg as jl
from raft_tpu.sparse import matrix as jm
from raft_tpu.sparse import op as jo
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.linalg import NormType
from raft_tpu_torch.sparse import convert as tc
from raft_tpu_torch.sparse import linalg as tl
from raft_tpu_torch.sparse import matrix as tm
from raft_tpu_torch.sparse import op as to
from _torch_threads import one_torch_thread  # noqa: F401


def _graph(n=120, nnz=900, seed=0, weights="int", diag=True):
    """A COO adjacency with duplicate entries, self-loops and empty rows,
    in both packages."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, n - 10, nnz).astype(np.int32)   # rows ≥ n−10 empty
    c = rng.integers(0, n, nnz).astype(np.int32)
    if diag:
        r[:20] = c[:20]
    v = (rng.integers(1, 4, nnz).astype(np.float32) if weights == "int"
         else rng.normal(size=nnz).astype(np.float32))
    return (JCOO(r, c, v, (n, n)),
            COOMatrix.from_numpy(r, c, v, (n, n), device="cpu"), r, c, v)


def _same_csr(j, t, values="exact", tol=None):
    np.testing.assert_array_equal(t.indptr.numpy(), np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    assert t.nnz == j.nnz and t.shape == j.shape
    if values == "exact":
        np.testing.assert_array_equal(t.values.numpy(), np.asarray(j.values))
    else:
        assert np.all(np.abs(t.values.numpy() - np.asarray(j.values)) <= tol)


@pytest.mark.parametrize("weights", ["int", "normal"])
def test_laplacian_and_degree(weights):
    J, T, r, c, v = _graph(weights=weights)
    jL = jl.compute_graph_laplacian(None, J)
    tL = tl.compute_graph_laplacian(None, T)
    if weights == "int":
        _same_csr(jL, tL)
    else:
        # the diagonal sums a row's weights in another order
        deg_scale = np.zeros(120)
        np.add.at(deg_scale, r, np.abs(v.astype(np.float64)))
        n_i = np.bincount(r, minlength=120) + 3
        tol = np.repeat(n_i * deg_scale * 2.0 ** -24, np.diff(
            np.asarray(jL.indptr)))
        _same_csr(jL, tL, values="bound", tol=tol)
    np.testing.assert_array_equal(tl.degree(None, tL).numpy(),
                                  np.asarray(jl.degree(None, jL)))
    np.testing.assert_array_equal(tl.degree(None, T).numpy(),
                                  np.asarray(jl.degree(None, J)))
    # dedup: the canonical structure
    _same_csr(jl.compute_graph_laplacian(None, J, dedup=True),
              tl.compute_graph_laplacian(None, T, dedup=True),
              values="exact" if weights == "int" else "bound",
              tol=None if weights == "int" else 1e-5)


def test_laplacian_normalized_and_diagonal():
    J, T, *_ = _graph()
    jL, jd = jl.laplacian_normalized(None, J)
    tL, td = tl.laplacian_normalized(None, T)
    _same_csr(jL, tL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tl.diagonal(None, tL).numpy(),
                                  np.asarray(jl.diagonal(None, jL)))
    np.testing.assert_array_equal(tm.diagonal(None, T).numpy(),
                                  np.asarray(jm.diagonal(None, J)))


def test_symmetrize_add_transpose():
    J, T, *_ = _graph(weights="normal")
    _same_csr(jl.symmetrize(None, J), tl.symmetrize(None, T), "bound", 1e-6)
    _same_csr(jl.symmetrize(None, J, dedup=True),
              tl.symmetrize(None, T, dedup=True), "bound", 1e-6)
    J2, T2, *_ = _graph(seed=1, weights="normal")
    _same_csr(jl.add(None, J, J2), tl.add(None, T, T2), "bound", 1e-6)
    _same_csr(jl.add(None, J, J2, dedup=True),
              tl.add(None, T, T2, dedup=True), "bound", 1e-6)
    jcsr, tcsr = jc.coo_to_csr(J), tc.coo_to_csr(T)
    _same_csr(jcsr, tcsr)
    _same_csr(jl.transpose(None, jcsr), tl.transpose(None, tcsr))


@pytest.mark.parametrize("norm", ["L1", "L2", "LINF"])
def test_row_norm_and_normalize(norm):
    J, T, r, _, v = _graph(weights="normal")
    jn = np.asarray(jl.row_norm(None, J, getattr(JNorm, norm)))
    tn = tl.row_norm(None, T, getattr(NormType, norm)).numpy()
    n_i = np.bincount(r, minlength=120) + 2
    tol = n_i * 2.0 ** -24 * np.asarray(jl.row_norm(None, J, JNorm.L2)
                                        if norm == "L2" else
                                        jl.row_norm(None, J, JNorm.L1))
    assert np.array_equal(np.isinf(jn), np.isinf(tn))   # empty rows, LINF
    fin = np.isfinite(jn)
    assert np.all(np.abs(tn[fin] - jn[fin]) <= tol[fin])
    jr = np.asarray(jl.row_normalize(None, J, getattr(JNorm, norm)).values)
    tr = tl.row_normalize(None, T, getattr(NormType, norm)).values.numpy()
    np.testing.assert_allclose(tr, jr, rtol=4e-6, atol=1e-7)


def test_conversions_and_ops():
    J, T, r, c, v = _graph(weights="normal")
    dense = np.asarray(J.to_dense())
    np.testing.assert_array_equal(T.to_dense().numpy(), dense)
    jcsr, tcsr = jc.dense_to_csr(dense), tc.dense_to_csr(dense,
                                                          device="cpu")
    _same_csr(jcsr, tcsr)
    np.testing.assert_array_equal(tc.csr_to_dense(tcsr).numpy(), dense)
    jcoo, tcoo = jc.csr_to_coo(jcsr), tc.csr_to_coo(tcsr)
    np.testing.assert_array_equal(tcoo.rows.numpy(), np.asarray(jcoo.rows))
    np.testing.assert_array_equal(tc.coo_to_dense(tcoo).numpy(), dense)
    adj = dense != 0
    _same_csr(jc.adj_to_csr(adj), tc.adj_to_csr(adj, device="cpu"))
    s = to.coo_sort(T)
    js = jo.coo_sort(J)
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(getattr(s, f).numpy(),
                                      np.asarray(getattr(js, f)))
    for name in ("sum_duplicates", "max_duplicates"):
        a, b = getattr(jo, name)(J), getattr(to, name)(T)
        np.testing.assert_array_equal(b.rows.numpy(), np.asarray(a.rows))
        np.testing.assert_array_equal(b.cols.numpy(), np.asarray(a.cols))
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=1e-6, atol=1e-6)
    a, b = jo.coo_remove_zeros(J, 0.5), to.coo_remove_zeros(T, 0.5)
    np.testing.assert_array_equal(b.values.numpy(), np.asarray(a.values))
    a = jo.csr_row_slice(jcsr, 3, 40)
    b = to.csr_row_slice(tcsr, 3, 40)
    _same_csr(a, b)
    a = jo.csr_row_op(jcsr, lambda i, x: x * (i + 1))
    b = to.csr_row_op(tcsr, lambda i, x: x * (i + 1))
    np.testing.assert_array_equal(b.values.numpy(), np.asarray(a.values))


@pytest.mark.parametrize("select_min", [True, False])
def test_sparse_select_k(select_min):
    rng = np.random.default_rng(3)
    dense = rng.normal(size=(40, 30)).astype(np.float32)
    dense[rng.random((40, 30)) > 0.2] = 0
    dense[5] = 0                                    # an empty row
    jcsr, tcsr = jc.dense_to_csr(dense), tc.dense_to_csr(dense,
                                                          device="cpu")
    for k, fill in ((3, None), (9, -7.0)):
        jv, ji = jm.select_k(None, jcsr, k, select_min, fill)
        tv, ti = tm.select_k(None, tcsr, k, select_min, fill)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_diagonal_ops_tfidf_bm25():
    rng = np.random.default_rng(4)
    dense = rng.integers(0, 5, (30, 25)).astype(np.float32)
    dense[rng.random((30, 25)) > 0.3] = 0
    np.fill_diagonal(dense, 2.0)
    jcsr, tcsr = jc.dense_to_csr(dense), tc.dense_to_csr(dense,
                                                          device="cpu")
    d = np.arange(1, 31, dtype=np.float32)
    for name in ("set_diagonal", "scale_by_diagonal_symmetric"):
        a = getattr(jm, name)(None, jcsr, d)
        b = getattr(tm, name)(None, tcsr, d)
        np.testing.assert_array_equal(b.values.numpy(), np.asarray(a.values))
    for name in ("encode_tfidf", "encode_bm25"):
        a = getattr(jm, name)(None, jcsr)
        b = getattr(tm, name)(None, tcsr)
        np.testing.assert_allclose(b.values.numpy(), np.asarray(a.values),
                                   rtol=2e-6, atol=1e-6)


def test_numpy_held_matrix_defaults_to_cuda():
    """A matrix that holds numpy arrays moves to cuda at the first entry
    point (raises without a card) unless a device is named."""
    _, _, r, c, v = _graph()
    A = COOMatrix(r, c, v, (120, 120))
    if torch.cuda.is_available():
        assert tl.degree(None, A).device.type == "cuda"
        return
    from raft_tpu_torch.core import DeviceError

    with pytest.raises(DeviceError):
        tl.compute_graph_laplacian(None, A)
    with pytest.raises(DeviceError):
        CSRMatrix.from_numpy(np.zeros(3, np.int32), np.zeros(0, np.int32),
                             np.zeros(0, np.float32), (2, 2))
    L = tl.compute_graph_laplacian(None, A.to("cpu"))
    assert L.values.device.type == "cpu"
