"""Parity of the port's sparse solvers (raft_tpu_torch.sparse.solver:
Cholesky-QR, the randomized sparse SVD and the Borůvka MST) with the
reference's, on the CPU.

Inputs come from a seed with numpy and go through both packages. The
randomized SVD is fed the reference's own Gaussian sketch (a threefry
stream cannot be matched), so S agrees to 1e-4 relative and U, V to 1e-3
after both packages' sign correction. The MST is held bit for bit: the
same edges in the same order, the same weights and the same component
labels, ties included.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.core.sparse_types import COOMatrix as JCOO
from raft_tpu.core.sparse_types import CSRMatrix as JCSR
from raft_tpu.sparse import solver as js
from raft_tpu_torch.core import DeviceResources, LogicError
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix
from raft_tpu_torch.sparse import linalg as tsl
from raft_tpu_torch.sparse import solver as ts

trs = importlib.import_module("raft_tpu_torch.sparse.solver.randomized_svds")

RES = DeviceResources(device="cpu")
JRES = JaxResources(seed=0)


# ---- Cholesky-QR ----

@pytest.mark.parametrize("fn", ["cholesky_qr", "cholesky_qr2"])
@pytest.mark.parametrize("rank_deficient", [False, True])
def test_cholesky_qr_matches_reference(fn, rank_deficient):
    """Q and R to 1e-4 of the reference's (same jitter eps·trace(YᵀY));
    Q orthonormal and Q R = Y. A rank-deficient Y (column 5 repeats
    column 2) factors through the jitter in both packages; after the
    second pass the repeated column's row of R is rounding under the
    jitter in both, so it is left out of the comparison there."""
    rng = np.random.default_rng(1)
    Y = rng.normal(size=(60, 8)).astype(np.float32)
    if rank_deficient:
        Y[:, 5] = Y[:, 2]
    jq, jr = getattr(js, fn)(Y)
    q, r = getattr(ts, fn)(torch.from_numpy(Y))
    jq, jr = np.asarray(jq), np.asarray(jr)
    assert np.isfinite(q.numpy()).all() and np.isfinite(jq).all()
    rows = [i for i in range(8) if not (rank_deficient and i == 5
                                        and fn == "cholesky_qr2")]
    np.testing.assert_allclose(r.numpy()[rows], jr[rows], rtol=1e-4,
                               atol=1e-4 * np.abs(jr).max())
    np.testing.assert_allclose((q @ r).numpy(), Y, atol=1e-3)
    if not rank_deficient:
        np.testing.assert_allclose(q.numpy(), jq, atol=1e-4)
        np.testing.assert_allclose((q.T @ q).numpy(), np.eye(8),
                                   atol=1e-4 if fn == "cholesky_qr2"
                                   else 1e-3)


# ---- randomized sparse SVD ----

def _sparse_dense(m, n, density, seed):
    rng = np.random.default_rng(seed)
    dense = rng.normal(size=(m, n)).astype(np.float32)
    dense[rng.random((m, n)) > density] = 0
    # a decaying spectrum, so the top singular values are separated
    dense *= np.geomspace(4.0, 0.2, n)[None, :].astype(np.float32)
    return dense


def _reference_sketch(n, cfg, m):
    ell = min(cfg.n_components + cfg.n_oversamples, min(m, n))
    return np.asarray(jax.random.normal(jax.random.key(cfg.seed), (n, ell),
                                        np.float32))


SVDS_CASES = [  # (m, n, density, k, oversamples, power iterations, format)
    (120, 50, 0.3, 5, 10, 2, "csr"), (90, 70, 0.2, 8, 6, 4, "coo"),
    (60, 40, 0.5, 3, 10, 0, "csr")]


@pytest.mark.parametrize("case", range(len(SVDS_CASES)))
def test_randomized_svds_from_the_reference_sketch(case):
    """S to 1e-4 relative; U and V to 1e-3 after sign_correction (both
    packages apply it), on CSR and COO."""
    m, n, density, k, p, iters, fmt = SVDS_CASES[case]
    dense = _sparse_dense(m, n, density, 20 + case)
    jcfg = js.SvdsConfig(n_components=k, n_oversamples=p, n_power_iters=iters,
                         seed=case)
    ju, jsv, jv = js.randomized_svds(
        JRES, JCSR.from_dense(dense) if fmt == "csr"
        else JCOO.from_dense(dense), jcfg)
    A = (CSRMatrix.from_dense(torch.from_numpy(dense)) if fmt == "csr"
         else COOMatrix.from_dense(torch.from_numpy(dense)))
    if fmt == "coo":
        from raft_tpu_torch.sparse.convert import coo_to_csr
        A = coo_to_csr(A)
    omega = torch.from_numpy(_reference_sketch(n, jcfg, m))
    u, s, v = trs._svds_from_sketch(RES, A, tsl.transpose(RES, A), omega,
                                    k, iters)
    np.testing.assert_allclose(s.numpy(), np.asarray(jsv), rtol=1e-4)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), atol=1e-3)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-3)


@pytest.mark.parametrize("fmt", ["csr", "coo"])
def test_randomized_svds_as_reference_test(fmt):
    """The reference test's case (tests/test_solvers.py): S within 5% of
    numpy's, the singular triplets to 5% of S[0], every U column's pivot
    positive, in both packages, from their own sketches."""
    r = np.random.default_rng(6)
    dense = r.normal(size=(80, 40)).astype(np.float32)
    dense[r.random((80, 40)) > 0.3] = 0
    s_ref = np.linalg.svd(dense, compute_uv=False)
    cfg = dict(n_components=5, n_oversamples=10, n_power_iters=4)
    t = torch.from_numpy(dense)
    A = CSRMatrix.from_dense(t) if fmt == "csr" else COOMatrix.from_dense(t)
    jA = JCSR.from_dense(dense) if fmt == "csr" else JCOO.from_dense(dense)
    for U, S, V in (ts.randomized_svds(RES, A, ts.SvdsConfig(**cfg)),
                    js.randomized_svds(JRES, jA, js.SvdsConfig(**cfg))):
        U, S, V = np.asarray(U), np.asarray(S), np.asarray(V)
        np.testing.assert_allclose(S, s_ref[:5], rtol=0.05)
        for i in range(3):
            np.testing.assert_allclose(dense @ V[:, i], S[i] * U[:, i],
                                       atol=0.05 * s_ref[0])
        piv = U[np.abs(U).argmax(axis=0), np.arange(U.shape[1])]
        assert (piv > 0).all()
    # seeded: the same config draws the same sketch
    a = ts.randomized_svds(RES, A, ts.SvdsConfig(**cfg))
    b = ts.randomized_svds(RES, A, ts.SvdsConfig(**cfg))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_randomized_svds_validates_as_reference():
    """A wrong-shaped At raises, as the reference's does; so does a bad
    rank and an operand that is not COO/CSR."""
    dense = _sparse_dense(30, 20, 0.4, 3)
    A = CSRMatrix.from_dense(torch.from_numpy(dense))
    cfg = ts.SvdsConfig(n_components=3)
    with pytest.raises(LogicError, match="At must be"):
        ts.randomized_svds(RES, A, cfg, At=A)
    with pytest.raises(Exception, match="At must be"):
        js.randomized_svds(JRES, JCSR.from_dense(dense),
                           js.SvdsConfig(n_components=3),
                           At=JCSR.from_dense(dense))
    with pytest.raises(LogicError):
        ts.randomized_svds(RES, A, ts.SvdsConfig(n_components=21))
    with pytest.raises(LogicError, match="item 7"):
        ts.randomized_svds(RES, torch.from_numpy(dense), cfg)
    u, s, v = ts.randomized_svds(RES, A, cfg, At=tsl.transpose(RES, A))
    assert u.shape == (30, 3) and s.shape == (3,) and v.shape == (20, 3)


def test_sign_correction_matches_reference():
    """Bit for bit, a zero column keeping its sign."""
    rng = np.random.default_rng(9)
    U = rng.normal(size=(12, 4)).astype(np.float32)
    V = rng.normal(size=(7, 4)).astype(np.float32)
    U[:, 2] = 0
    ju, jv = js.sign_correction(U, V)
    u, v = ts.sign_correction(torch.from_numpy(U), torch.from_numpy(V))
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


# ---- MST ----

def _graph(n, edges):
    dense = np.zeros((n, n), np.float32)
    for u, v, w in edges:
        dense[u, v] = dense[v, u] = w
    return dense


def _random_graph(n, seed, integer_weights):
    r = np.random.default_rng(seed)
    if integer_weights:
        dense = r.integers(1, 4, size=(n, n)).astype(np.float32)
    else:
        dense = np.abs(r.normal(size=(n, n))).astype(np.float32)
    dense = np.triu(dense, 1)
    dense = dense + dense.T
    mask = r.random((n, n)) < 0.15
    mask |= mask.T
    for i in range(n):
        mask[i, (i + 1) % n] = mask[(i + 1) % n, i] = True
    return dense * mask


GRAPHS = {
    "simple": lambda: _graph(5, [(0, 1, 1.0), (1, 2, 2.0), (0, 2, 4.0),
                                 (2, 3, 3.0), (3, 4, 1.5), (1, 4, 5.0)]),
    "random": lambda: _random_graph(40, 8, False),
    "random_ties": lambda: _random_graph(60, 9, True),
    "triangle": lambda: _graph(3, [(0, 1, 1.0), (1, 2, 1.0), (2, 0, 1.0)]),
    "forest": lambda: _graph(4, [(0, 1, 1.0), (2, 3, 2.0)]),
    "isolated": lambda: _graph(6, [(0, 1, 1.0), (1, 2, 1.0), (4, 5, 3.0)]),
}


def _same_mst(out, ref):
    np.testing.assert_array_equal(out.mst.src.numpy(),
                                  np.asarray(ref.mst.src))
    np.testing.assert_array_equal(out.mst.dst.numpy(),
                                  np.asarray(ref.mst.dst))
    np.testing.assert_array_equal(out.mst.weights.numpy(),
                                  np.asarray(ref.mst.weights))
    assert out.mst.n_edges == ref.mst.n_edges
    np.testing.assert_array_equal(out.color.numpy(), np.asarray(ref.color))
    assert out.mst.src.dtype == out.color.dtype == torch.int32


@pytest.mark.parametrize("fmt", ["csr", "coo"])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_mst_bit_for_bit(name, fmt):
    """Edges, weights, count and colors identical to the reference's; the
    forest's edge count is n minus its components, and the total weight is
    scipy's."""
    from scipy.sparse import csr_matrix as scipy_csr
    from scipy.sparse.csgraph import connected_components
    from scipy.sparse.csgraph import minimum_spanning_tree

    dense = GRAPHS[name]()
    t = torch.from_numpy(dense)
    if fmt == "csr":
        G, jG = CSRMatrix.from_dense(t), JCSR.from_dense(dense)
    else:
        G, jG = COOMatrix.from_dense(t), JCOO.from_dense(dense)
    out = ts.mst(RES, G)
    _same_mst(out, js.mst(JRES, jG))
    n_comp = connected_components(scipy_csr(dense))[0]
    assert out.mst.n_edges == dense.shape[0] - n_comp
    assert len(np.unique(out.color.numpy())) == n_comp
    ref_total = minimum_spanning_tree(scipy_csr(dense.astype(np.float64)))
    assert float(out.mst.weights.double().sum()) == pytest.approx(
        float(ref_total.sum()), rel=1e-5)


def test_mst_initial_colors_match_reference():
    """A partial forest given as initial colors: the rest of the tree, as
    the reference builds it."""
    dense = _random_graph(30, 11, False)
    colors = np.arange(30, dtype=np.int32)
    colors[[3, 4, 5]] = 3
    colors[[10, 20]] = 10
    out = ts.mst(RES, CSRMatrix.from_dense(torch.from_numpy(dense)),
                 initial_colors=colors)
    _same_mst(out, js.mst(JRES, JCSR.from_dense(dense),
                          initial_colors=colors))


def test_mst_lexsort_is_numpy_lexsort():
    from raft_tpu_torch.sparse.solver.mst import _lexsort

    r = np.random.default_rng(12)
    keys = [r.integers(0, 3, 200) for _ in range(3)] + [
        r.integers(0, 3, 200).astype(np.float32)]
    np.testing.assert_array_equal(
        _lexsort([torch.from_numpy(k) for k in keys]).numpy(),
        np.lexsort(keys))
