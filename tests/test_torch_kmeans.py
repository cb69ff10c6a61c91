"""Parity of the port's balanced k-means (raft_tpu_torch.cluster) with the
reference's (raft_tpu.cluster).

From the same ``init_centroids`` the Lloyd loops must agree: centroids
within 1e-4 relative (both sum in f32, in different orders), the same
iteration count, and labels equal except at near-ties, where the two
nearest (weighted) centroid scores of a point differ by less than 1e-4
of the point's scale — proven from the values. k-means++ draws from
threefry in JAX and from a torch.Generator in the port, so it is held by
statistics: the inertia within 5% of the reference's on the same data.
"""

import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans_fit as j_fit
from raft_tpu.cluster import kmeans_inertia as j_inertia
from raft_tpu.cluster import kmeans_predict as j_predict
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu_torch.cluster import kmeans_fit, kmeans_inertia, kmeans_predict
from raft_tpu_torch.core import DeviceResources

N, D, C = 4000, 16, 12


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    centers = rng.uniform(-8, 8, (C, D)).astype(np.float32)
    lab = rng.integers(0, C, N)
    X = (centers[lab] + rng.normal(0, 1.0, (N, D))).astype(np.float32)
    init = X[rng.choice(N, C, replace=False)].copy()
    return X, init


def _near_tie(X, cents, weights, a, b, rtol=1e-4):
    """True where labels a and b score within rtol of each other."""
    x = X.astype(np.float64)
    c = cents.astype(np.float64)
    da = ((x - c[a]) ** 2).sum(1) * weights[a]
    db = ((x - c[b]) ** 2).sum(1) * weights[b]
    scale = (x * x).sum(1) + (c * c).sum(1).max()
    return np.abs(da - db) <= rtol * scale


@pytest.mark.parametrize("balanced", [False, True])
def test_lloyd_matches_reference_from_same_init(data, balanced):
    X, init = data
    ref = j_fit(JaxResources(seed=0), X, C, max_iter=15, balanced=balanced,
                init_centroids=init)
    out = kmeans_fit(DeviceResources(device="cpu"), X, C, max_iter=15,
                     balanced=balanced, init_centroids=init)
    assert out.n_iter == ref.n_iter
    rc = np.asarray(ref.centroids)
    np.testing.assert_allclose(out.centroids.numpy(), rc, rtol=1e-4,
                               atol=1e-4 * np.abs(rc).max())
    assert out.inertia == pytest.approx(ref.inertia, rel=1e-5)
    lab, rlab = out.labels.numpy(), np.asarray(ref.labels)
    diff = lab != rlab
    if balanced:
        counts = np.bincount(rlab, minlength=C).astype(np.float64)
        w = ((counts + 1.0) / (counts.mean() + 1.0)) ** 0.25
    else:
        w = np.ones(C)
    assert _near_tie(X[diff], rc, w, lab[diff], rlab[diff]).all()
    assert torch.equal(out.cluster_sizes,
                       torch.bincount(out.labels.long(), minlength=C).to(
                           torch.int32))


def test_kmeanspp_inertia_matches_reference():
    """On isotropic data Lloyd's local optima lie within a few percent of
    each other, so one seed per package is a fair draw. (On separated
    blobs both packages land in optima 2-5x apart: the reference's min-d2
    carry starts at 1, so its k-means++ draws nearly uniformly — a
    reference behaviour the port keeps.)"""
    X = np.random.default_rng(5).normal(size=(N, D)).astype(np.float32)
    ref = j_fit(JaxResources(seed=0), X, C, max_iter=20, seed=1, n_init=2)
    out = kmeans_fit(DeviceResources(device="cpu"), X, C, max_iter=20,
                     seed=1, n_init=2)
    assert out.centroids.shape == (C, D)
    assert out.inertia <= 1.05 * ref.inertia
    assert ref.inertia <= 1.05 * out.inertia
    # seeded: the same seed gives the same fit
    again = kmeans_fit(DeviceResources(device="cpu"), X, C, max_iter=20,
                       seed=1, n_init=2)
    assert torch.equal(again.centroids, out.centroids)


def test_random_init_and_validation(data):
    X, _ = data
    res = DeviceResources(device="cpu")
    out = kmeans_fit(res, X, C, max_iter=10, init="random", seed=2)
    assert out.n_iter >= 1 and np.isfinite(out.inertia)
    with pytest.raises(Exception):
        kmeans_fit(res, X, C, init="bogus")
    with pytest.raises(Exception):
        kmeans_fit(res, X[:4], C)
    with pytest.raises(Exception):
        kmeans_fit(res, X, C, init_centroids=np.zeros((C, D + 1)))


def test_predict_and_inertia_match_reference(data):
    X, init = data
    jres, res = JaxResources(seed=0), DeviceResources(device="cpu")
    rl = np.asarray(j_predict(jres, init, X))
    lab = kmeans_predict(res, init, X).numpy()
    diff = lab != rl
    assert _near_tie(X[diff], init, np.ones(C), lab[diff], rl[diff]).all()
    assert kmeans_inertia(res, init, X) == pytest.approx(
        j_inertia(jres, init, X), rel=1e-5)
    assert kmeans_inertia(res, init, X, labels=rl) == pytest.approx(
        j_inertia(jres, init, X, labels=rl), rel=1e-5)


def _nonfinite_rows():
    X = np.random.default_rng(5).normal(size=(400, 16)).astype(np.float32)
    X[11, 2] = np.nan
    X[200, 5] = np.inf
    return X


@pytest.mark.parametrize("seed", [0, 1])
def test_kmeanspp_takes_nonfinite_rows_as_reference(seed):
    """A NaN and a +inf row: the reference's k-means++ draws through
    ``jax.random.categorical`` and fits; the port draws by Gumbel-max over
    the same logits (``torch.multinomial`` raised here) and fits too. The
    fits agree by distribution: some centroids are not finite in both, and
    neither package's predict finds a nearest centroid for any row (both
    label every row 2³¹ − 1)."""
    from raft_tpu_torch.cluster.kmeans import _kmeanspp_init

    X = _nonfinite_rows()
    ref = j_fit(JaxResources(seed=0), X, 8, seed=seed)
    out = kmeans_fit(DeviceResources(device="cpu"), X, 8, seed=seed)
    ref_bad = ~np.isfinite(np.asarray(ref.centroids)).all(1)
    out_bad = ~torch.isfinite(out.centroids).all(1).numpy()
    assert ref_bad.any() and out_bad.any()
    jl = np.asarray(j_predict(JaxResources(seed=0), ref.centroids, X))
    tl = kmeans_predict(DeviceResources(device="cpu"), out.centroids,
                        X).numpy()
    np.testing.assert_array_equal(tl, jl)
    assert (tl == np.iinfo(np.int32).max).all()
    # the draw ranks a NaN or +inf weight first, as categorical does: the
    # second center is the NaN row whichever the first was
    gen = torch.Generator().manual_seed(seed)
    centers = _kmeanspp_init(gen, torch.from_numpy(X), 2)
    assert torch.isnan(centers[1]).any()


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_ivf_build_refuses_nonfinite_rows(kind):
    """The reference builds its lists from the labels above, every one
    2³¹ − 1: its layout's ``np.bincount`` then makes 2³¹ list counters
    (17 GB) and is not run here. The port refuses the rows instead, with a
    LogicError naming the first of them."""
    from raft_tpu_torch.ann import build_ivf_flat, build_ivf_pq
    from raft_tpu_torch.core import LogicError

    build = build_ivf_flat if kind == "ivf_flat" else build_ivf_pq
    with pytest.raises(LogicError, match="row 11 holds a NaN or ±inf"):
        build(DeviceResources(device="cpu"), _nonfinite_rows(), n_lists=8)
