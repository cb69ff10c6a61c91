"""Parity of the port's ``stats`` (moments, metrics, cluster,
model_select, embed) and ``models.KMeans`` with the reference, on numpy
inputs from one seed.

Tolerances. Moments and metrics: both sides reduce in f32 in other
orders, rtol 1e-5 (1e-4 where the sum cancels: variances, covariances,
r²). Cluster metrics: the port reduces in f64 and the reference in f32,
so they agree to 1e-5 absolute (and the port to sklearn to 1e-10).
Embedding metrics: the reference's ``pairwise_distance`` is called with
``batched=False`` (its default reads a name jax no longer has); against
it 1e-5, against sklearn in f64 1e-9. KMeans: the two packages draw
k-means++ from different generators, so a fit is held by its quality
(the true partition, inertia no worse than the reference's by 1e-4) and
predict/transform on the same carried-across centers (labels equal,
distances within the expanded form's f32 cancellation, stated there).
"""

import functools

import numpy as np
import pytest
import torch

import raft_tpu.distance.pairwise as jpw
import raft_tpu.stats.embed as jembed
from raft_tpu import stats as js
from raft_tpu.models.kmeans import KMeans as JKMeans
from raft_tpu_torch import stats as ts
from raft_tpu_torch.core import DeviceError, DeviceResources
from raft_tpu_torch.models import KMeans
from raft_tpu_torch.ops import histogram as k9
from raft_tpu_torch.ops import unexpanded as k8
from _torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(61)
CPU = DeviceResources(device="cpu")


@pytest.fixture()
def ref_pairwise(monkeypatch):
    """The reference's embed metrics through ``batched=False``."""
    monkeypatch.setattr(jembed, "pairwise_distance",
                        functools.partial(jpw.pairwise_distance,
                                          batched=False))
    monkeypatch.setattr(jpw, "pairwise_distance",
                        functools.partial(jpw.pairwise_distance,
                                          batched=False))


def _close(got, want, rtol=1e-5, atol=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def test_moments_match_reference():
    X = rng.normal(loc=2.0, size=(200, 5)).astype(np.float32)
    mu = X.mean(0)
    _close(ts.sum_stat(CPU, X), js.sum_stat(None, X))
    _close(ts.sum_stat(CPU, X, along_rows=False),
           js.sum_stat(None, X, along_rows=False))
    for sample in (False, True):
        _close(ts.mean(CPU, X, sample), js.mean(None, X, sample))
        _close(ts.vars_(CPU, X, sample=sample),
               js.vars_(None, X, sample=sample), rtol=1e-4)
        _close(ts.vars_(CPU, X, mu, sample=sample),
               js.vars_(None, X, mu, sample=sample), rtol=1e-4)
        _close(ts.stddev(CPU, X, sample=sample),
               js.stddev(None, X, sample=sample), rtol=1e-4)
        for a, b in zip(ts.meanvar(CPU, X, sample),
                        js.meanvar(None, X, sample)):
            _close(a, b, rtol=1e-4)
    _close(ts.mean_center(CPU, X), js.mean_center(None, X), atol=1e-5)
    _close(ts.mean_center(CPU, X, mu), js.mean_center(None, X, mu),
           atol=1e-5)
    _close(ts.mean_add(CPU, X, mu), js.mean_add(None, X, mu))
    for a, b in zip(ts.minmax(CPU, X), js.minmax(None, X)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_weighted_mean_and_cov_match_reference():
    X = rng.normal(size=(300, 4)).astype(np.float32)
    w = np.abs(rng.normal(size=300)).astype(np.float32)
    wc = np.abs(rng.normal(size=4)).astype(np.float32)
    _close(ts.weighted_mean(CPU, X, w), js.weighted_mean(None, X, w))
    _close(ts.weighted_mean(CPU, X, wc, along_rows=False),
           js.weighted_mean(None, X, wc, along_rows=False))
    for sample in (False, True):
        for stable in (False, True):
            _close(ts.cov(CPU, X, sample=sample, stable=stable),
                   js.cov(None, X, sample=sample, stable=stable),
                   rtol=1e-4, atol=1e-5)
    _close(ts.cov(CPU, X, X.mean(0)), js.cov(None, X, X.mean(0)), rtol=1e-4,
           atol=1e-5)


def test_moments_f64_and_device_rule():
    X = rng.normal(size=(50, 3))
    out = ts.mean(CPU, X)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), X.mean(0), rtol=1e-14)
    assert ts.mean(None, torch.from_numpy(X)).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            ts.mean(None, X)


@pytest.mark.parametrize("n", [100, 101])          # even and odd medians
def test_metrics_match_reference(n):
    y = rng.normal(size=n).astype(np.float32)
    y_hat = y + 0.1 * rng.normal(size=n).astype(np.float32)
    assert ts.r2_score(CPU, y, y_hat) == pytest.approx(
        js.r2_score(None, y, y_hat), rel=1e-4)
    got = ts.regression_metrics(CPU, y_hat, y)
    want = js.regression_metrics(None, y_hat, y)
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=1e-5)
    assert got.median_abs_error == pytest.approx(
        float(np.median(np.abs(y_hat - y))), rel=1e-6)
    p = rng.integers(0, 4, n)
    r = rng.integers(0, 4, n)
    assert ts.accuracy(CPU, p, r) == pytest.approx(js.accuracy(None, p, r))
    _close(ts.mean_squared_error(CPU, y, y_hat, 2.0),
           js.mean_squared_error(None, y, y_hat, 2.0))


def test_cluster_metrics_match_reference_and_sklearn():
    from sklearn import metrics as sk

    a = rng.integers(0, 4, 300)
    b = rng.integers(0, 3, 300)
    np.testing.assert_array_equal(ts.contingency_matrix(CPU, a, b).numpy(),
                                  np.asarray(js.contingency_matrix(None, a,
                                                                   b)))
    np.testing.assert_array_equal(
        ts.contingency_matrix(CPU, a, b, 5, 4).numpy(),
        np.asarray(js.contingency_matrix(None, a, b, 5, 4)))
    assert ts.get_contingency_matrix_shape(CPU, a, b) == \
        js.get_contingency_matrix_shape(None, a, b)
    pairs = [(ts.rand_index, js.rand_index, sk.rand_score),
             (ts.adjusted_rand_index, js.adjusted_rand_index,
              sk.adjusted_rand_score),
             (ts.mutual_info_score, js.mutual_info_score,
              sk.mutual_info_score),
             (ts.homogeneity_score, js.homogeneity_score,
              sk.homogeneity_score),
             (ts.completeness_score, js.completeness_score,
              sk.completeness_score),
             (ts.v_measure, js.v_measure, sk.v_measure_score)]
    for port, ref, skf in pairs:
        got = port(CPU, a, b)
        assert isinstance(got, float)
        assert got == pytest.approx(ref(None, a, b), abs=1e-5)
        assert got == pytest.approx(skf(a, b), abs=1e-10)
    assert ts.adjusted_rand_index(CPU, a, a) == 1.0
    assert ts.v_measure(CPU, a, b, beta=2.0) == pytest.approx(
        js.v_measure(None, a, b, beta=2.0), abs=1e-5)
    assert ts.entropy(CPU, a) == pytest.approx(js.entropy(None, a),
                                               abs=1e-5)
    assert ts.entropy(CPU, np.zeros(5, np.int64)) == 0.0
    assert ts.entropy(CPU, a, n_classes=7) == pytest.approx(
        js.entropy(None, a, n_classes=7), abs=1e-5)
    p = np.abs(rng.normal(size=10)).astype(np.float32)
    q = np.abs(rng.normal(size=10)).astype(np.float32)
    p[2] = 0.0
    q[5] = 0.0
    p, q = p / p.sum(), q / q.sum()
    assert ts.kl_divergence(CPU, p, q) == pytest.approx(
        js.kl_divergence(None, p, q), abs=1e-5)


def test_model_select_matches_reference():
    c = rng.normal(size=(5, 3)).astype(np.float32)
    sizes = rng.integers(1, 20, 5).astype(np.float32)
    g = rng.normal(size=3).astype(np.float32)
    assert ts.dispersion(CPU, c, sizes) == pytest.approx(
        js.dispersion(None, c, sizes), rel=1e-5)
    assert ts.dispersion(CPU, c, sizes, g, 40) == pytest.approx(
        js.dispersion(None, c, sizes, g, 40), rel=1e-5)
    ll = rng.normal(-50.0, 10.0, 6).astype(np.float32)
    for ic in ts.IC_Type:
        _close(ts.information_criterion_batched(CPU, ll, ic, 3, 6, 50),
               js.information_criterion_batched(
                   None, ll, js.IC_Type[ic.name], 3, 6, 50), rtol=1e-6)


def _blobs(n_per, centers, d, std=0.6):
    X = np.vstack([rng.normal(c, std, (n_per, d)) for c in centers])
    return X.astype(np.float32), np.repeat(np.arange(len(centers)), n_per)


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "l1",
                                    "cosine", "canberra"])
def test_silhouette_matches_reference(metric, ref_pairwise):
    X, labels = _blobs(25, [0.0, 3.0, -2.0], 4)
    want = js.silhouette_score(None, X, labels, metric=metric)
    assert ts.silhouette_score(CPU, X, labels, metric=metric) == \
        pytest.approx(want, abs=1e-5)
    for chunk in (17, 1024):
        assert ts.silhouette_score_batched(
            CPU, X, labels, metric=metric, chunk=chunk) == pytest.approx(
            js.silhouette_score_batched(None, X, labels, metric=metric,
                                        chunk=chunk), abs=1e-5)


def test_silhouette_sklearn_f64_and_singletons():
    from sklearn.metrics import silhouette_score as sk_sil

    X, labels = _blobs(20, [0.0, 2.0, 4.0], 5, std=1.0)
    X = X.astype(np.float64)
    labels[0] = 3                                   # a singleton cluster
    for metric, skm in (("euclidean", "euclidean"), ("l1", "cityblock"),
                        ("sqeuclidean", "sqeuclidean")):
        want = sk_sil(X, labels, metric=skm)
        assert ts.silhouette_score(CPU, X, labels, metric=metric) == \
            pytest.approx(want, abs=1e-9)
        assert ts.silhouette_score_batched(CPU, X, labels, metric=metric,
                                           chunk=7) == \
            pytest.approx(want, abs=1e-9)


def test_trustworthiness_matches_reference_and_sklearn(ref_pairwise):
    from sklearn.manifold import trustworthiness as sk_trust

    X = rng.normal(size=(60, 8)).astype(np.float32)
    E = X[:, :2] + 0.5 * rng.normal(size=(60, 2)).astype(np.float32)
    assert ts.trustworthiness_score(CPU, X, X, 5) == pytest.approx(1.0,
                                                                  abs=1e-12)
    for metric in ("sqeuclidean", "euclidean", "l1"):
        assert ts.trustworthiness_score(CPU, X, E, 5, metric=metric) == \
            pytest.approx(js.trustworthiness_score(None, X, E, 5,
                                                   metric=metric), abs=1e-5)
    X64, E64 = X.astype(np.float64), E.astype(np.float64)
    assert ts.trustworthiness_score(CPU, X64, E64, 5, metric="euclidean") \
        == pytest.approx(sk_trust(X64, E64, n_neighbors=5), abs=1e-9)
    with pytest.raises(Exception):
        ts.trustworthiness_score(CPU, X[:8], E[:8], 5)


def test_neighborhood_recall_matches_reference():
    a = rng.integers(0, 30, (20, 6))
    b = rng.integers(0, 30, (20, 6))
    assert ts.neighborhood_recall(CPU, a, b) == pytest.approx(
        js.neighborhood_recall(None, a, b), abs=1e-7)
    assert ts.neighborhood_recall(CPU, a, a) == 1.0


def test_kmeans_estimator_matches_reference(ref_pairwise):
    X, truth = _blobs(60, [0.0, 6.0, -6.0, 12.0], 6, std=0.8)
    ref = JKMeans(n_clusters=4, random_state=0).fit(X)
    est = KMeans(n_clusters=4, random_state=0, res=CPU).fit(X)
    # the reference's k-means++ draws near-uniformly (ROADMAP queue 3) and
    # may stop in a worse optimum; the port's fit must be no worse
    assert ts.adjusted_rand_index(CPU, est.labels_, truth) == 1.0
    assert est.inertia_ <= ref.inertia_ * (1 + 1e-4)
    assert est.n_iter_ >= 1
    torch.testing.assert_close(est.fit_predict(X), est.labels_)
    # the reference's fitted centers carried across
    port = KMeans.from_numpy({"cluster_centers_": np.asarray(
        ref.cluster_centers_), "labels_": np.asarray(ref.labels_),
        "inertia_": ref.inertia_, "n_iter_": ref.n_iter_}, device="cpu")
    assert port.n_clusters == 4 and port.inertia_ == ref.inertia_
    Q = X + 0.3 * rng.normal(size=X.shape).astype(np.float32)
    np.testing.assert_array_equal(port.predict(Q).numpy(),
                                  np.asarray(ref.predict(Q)))
    # euclidean by the expanded form on both sides: the f32 cancellation
    # |Δd²| ≤ 4·(d + 2)·2⁻²⁴·(‖q‖² + ‖c‖²), carried through the sqrt
    got, want = port.transform(Q).numpy(), np.asarray(ref.transform(Q))
    c = np.asarray(ref.cluster_centers_)
    e2 = 4 * (Q.shape[1] + 2) * 2.0 ** -24 * (
        (Q * Q).sum(1)[:, None] + (c * c).sum(1)[None, :])
    assert np.all(np.abs(got - want)
                  <= e2 / np.maximum(want, np.sqrt(e2)) + 2.0 ** -23 * want)
    with pytest.raises(RuntimeError):
        KMeans(res=CPU).predict(X)
    with pytest.raises(RuntimeError):
        KMeans(res=CPU).transform(X)


def test_stats_path_on_cpu_launches_no_kernel():
    before = (k8.LAUNCHES, k9.LAUNCHES)
    X, labels = _blobs(20, [0.0, 3.0], 4)
    ts.silhouette_score(CPU, X, labels, metric="l1")
    ts.histogram(CPU, labels, 2, hist_type=ts.HistType.Blocked)
    ts.value_histogram(CPU, X.ravel(), 16)
    assert (k8.LAUNCHES, k9.LAUNCHES) == before == (0, 0)


def test_entry_points_default_to_cuda():
    X, labels = _blobs(10, [0.0, 3.0], 3)
    if torch.cuda.is_available():
        return
    for call in (lambda: ts.histogram(None, labels, 2),
                 lambda: ts.value_histogram(None, X.ravel(), 8),
                 lambda: ts.silhouette_score(None, X, labels),
                 lambda: ts.adjusted_rand_index(None, labels, labels),
                 lambda: ts.r2_score(None, X[:, 0], X[:, 1]),
                 lambda: ts.cov(None, X),
                 lambda: KMeans(2).fit(X)):
        with pytest.raises(DeviceError):
            call()
    assert ts.histogram(None, torch.from_numpy(labels), 2).device.type \
        == "cpu"


def test_kernel_failure_raises(monkeypatch):
    """A K9 (or K8) failure reaches the caller through the stats path."""
    import importlib

    from raft_tpu_torch.ops import _build

    th = importlib.import_module("raft_tpu_torch.stats.histogram")

    def broken(*a, **kw):
        raise DeviceError("histogram_blocked: launch failed with CUDA "
                          "error 700")

    monkeypatch.setattr(th, "histogram_blocked", broken)
    with pytest.raises(DeviceError, match="700"):
        ts.histogram(CPU, np.zeros(10, np.int32), 4,
                     hist_type=ts.HistType.Blocked)
    monkeypatch.setattr(k8, "unexpanded_pairwise_tiled", broken)
    X, labels = _blobs(5, [0.0, 3.0], 3)
    with pytest.raises(DeviceError, match="700"):
        ts.silhouette_score(CPU, X, labels, metric="l1")

    def no_build(name):
        raise DeviceError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(k9, "_FN", None)
    with pytest.raises(DeviceError, match="histogram.cu"):
        k9._launcher()
    # a tensor on no card is refused, not counted by the twin
    with pytest.raises(DeviceError):
        k9.histogram_blocked(torch.zeros((4, 2), dtype=torch.int32,
                                         device="meta"), 3)
