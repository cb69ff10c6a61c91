"""Parity of the port's NearestNeighbors estimator
(raft_tpu_torch.models.NearestNeighbors) with the reference's, on the CPU.

brute: the same exact KNN, ids identical where no two distances tie
within the expanded f32 form's rounding (the data is N(0, 1), so none
does), values within 1e-5 relative plus that rounding, 8·2⁻²⁴·(‖x‖² +
max‖y‖²). ivf_flat / ivf_pq at ``n_probes = n_lists`` are exact (the
degenerate-exact invariant): ids identical to brute force's in both
packages. At fewer probes, each package's own k-means (threefry against a
torch.Generator) builds other lists, so the reference's index is carried
across (``from_numpy``, as tests/test_torch_ivf_flat.py and
test_torch_ivf_pq.py do) and the estimators' ids compared on that one
index: identical for IVF-Flat, identical as sets for IVF-PQ (its rescored
pool, as the IVF-PQ parity test holds it).
"""

import numpy as np
import pytest
import torch

from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.models import NearestNeighbors as JNN
from raft_tpu_torch.ann import IvfFlatIndex, IvfPqIndex
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.models import NearestNeighbors

from _torch_threads import one_torch_thread  # noqa: F401

RES = DeviceResources(device="cpu")
JRES = JaxResources(seed=0)
_rng = np.random.default_rng(4)
X = _rng.normal(size=(3000, 16)).astype(np.float32)
Q = _rng.normal(size=(9, 16)).astype(np.float32)


def _floor():
    return 8 * 2.0 ** -24 * ((Q * Q).sum(1) + (X * X).sum(1).max())


def _same_values(d, jd, squared=True):
    d, jd = np.asarray(d, np.float64), np.asarray(jd, np.float64)
    floor = _floor()[:, None] if squared else np.sqrt(_floor())[:, None]
    assert np.all(np.abs(d - jd) <= 1e-5 * np.abs(jd) + floor)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product"])
def test_brute_matches_reference(metric):
    nn = NearestNeighbors(n_neighbors=6, metric=metric, res=RES).fit(X)
    d, i = nn.kneighbors(torch.from_numpy(Q))
    jd, ji = JNN(n_neighbors=6, metric=metric, res=JRES).fit(X).kneighbors(Q)
    assert i.dtype == torch.int32 and i.shape == (9, 6)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    if metric == "inner_product":
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                                   atol=1e-5)
    else:
        _same_values(d, jd, squared=metric == "sqeuclidean")
    d2, i2 = nn.kneighbors(torch.from_numpy(Q), n_neighbors=3)
    assert torch.equal(i2, i[:, :3])


def test_brute_self_neighbors_and_graph():
    nn = NearestNeighbors(n_neighbors=4, res=RES).fit(X[:200])
    d, i = nn.kneighbors(torch.from_numpy(X[:10]))
    assert i[:, 0].tolist() == list(range(10))
    g = nn.kneighbors_graph(torch.from_numpy(X[:10]))
    jg = JNN(n_neighbors=4, res=JRES).fit(X[:200]).kneighbors_graph(X[:10])
    assert tuple(g.shape) == tuple(jg.shape) == (10, 200)
    assert g.nnz == jg.nnz == 40
    np.testing.assert_array_equal(g.indptr.numpy(), np.asarray(jg.indptr))
    np.testing.assert_array_equal(g.indices.numpy(), np.asarray(jg.indices))


@pytest.mark.parametrize("algorithm", ["ivf_flat", "ivf_pq"])
def test_ivf_exact_at_all_lists(algorithm):
    """n_probes = n_lists: ids identical to brute force in both
    packages."""
    kw = dict(n_neighbors=4, algorithm=algorithm, n_lists=8, n_probes=8)
    _, bi = NearestNeighbors(n_neighbors=4, res=RES).fit(X).kneighbors(
        torch.from_numpy(Q))
    d, i = NearestNeighbors(res=RES, **kw).fit(X).kneighbors(
        torch.from_numpy(Q))
    jd, ji = JNN(res=JRES, **kw).fit(X).kneighbors(Q)
    np.testing.assert_array_equal(i.numpy(), bi.numpy())
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    _same_values(d, jd)


def _export(j, names):
    out = {n: np.asarray(getattr(j, n)) for n in names}
    for n in ("n_rows", "d_orig", "row_quantum", "n_probes_default",
              "kmeans_iters", "db_dtype"):
        out[n] = getattr(j, n)
    return out


_FLAT = ("centroids", "slab", "ids", "yy_slab", "offsets", "sizes",
         "padded_sizes")
_PQ = ("codebooks", "codes", "yy_pq", "pq_eq_rows", "pq_eq_sub",
       "pq_eq_list", "pq_rhat_list", "pq_eq_qlist")


@pytest.mark.parametrize("algorithm", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean"])
def test_ivf_probed_on_the_reference_index(algorithm, metric):
    kw = dict(n_neighbors=5, algorithm=algorithm, n_lists=16, n_probes=3,
              metric=metric)
    jnn = JNN(res=JRES, **kw).fit(X)
    jd, ji = jnn.kneighbors(Q)
    nn = NearestNeighbors(res=RES, **kw).fit(X)
    assert nn._index.n_lists == 16
    if algorithm == "ivf_flat":
        nn._index = IvfFlatIndex.from_numpy(_export(jnn._index, _FLAT),
                                            device="cpu")
    else:
        j = jnn._index
        arrays = _export(j, _FLAT + _PQ)
        arrays.update(pq_dim=j.pq_dim, pq_bits=j.pq_bits, pq_mode=j.pq_mode,
                      pq_resid_med=j.pq_resid_med,
                      pq_rot=None if j.pq_rot is None
                      else np.asarray(j.pq_rot))
        nn._index = IvfPqIndex.from_numpy(arrays, device="cpu")
    d, i = nn.kneighbors(torch.from_numpy(Q))
    if algorithm == "ivf_flat":
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    else:
        for a, b in zip(i.tolist(), np.asarray(ji).tolist()):
            assert set(a) == set(b)
    _same_values(np.sort(d.numpy(), 1), np.sort(np.asarray(jd), 1),
                 squared=metric == "sqeuclidean")


@pytest.mark.parametrize("case", ["mesh", "n_shards", "mesh_ivf"])
def test_sharded_options_raise_naming_item_7(case):
    kw = {"mesh": dict(mesh=object()), "n_shards": dict(n_shards=2),
          "mesh_ivf": dict(mesh=object(), algorithm="ivf_flat")}[case]
    with pytest.raises(NotImplementedError, match="item 7"):
        NearestNeighbors(res=RES, **kw)


def test_argument_checks_match_reference():
    for kw in (dict(algorithm="hnsw"),
               dict(algorithm="ivf_flat", metric="cosine"),
               dict(algorithm="ivf_pq", n_shards=2)):
        with pytest.raises(ValueError):
            NearestNeighbors(res=RES, **kw)
        with pytest.raises(ValueError):
            JNN(res=JRES, **kw)
