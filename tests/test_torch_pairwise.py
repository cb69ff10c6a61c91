"""Parity of the port's ``distance.pairwise_distance`` with the
reference's, called with ``batched=False`` (the reference's default
``batched=None`` reads a name jax no longer has), for every metric name,
every ``DistanceType``, Minkowski p = 3, and f64 inputs under x64.

Tolerances. f32 inputs: both sides take f32 products (the port TF32-free)
or sum the same unexpanded terms in other orders: rtol 1e-5 with atol
1e-5·(1 + max|ref|); the unexpanded metrics are also held to the module
bound of K8 (``ops.unexpanded.error_bound``). f64 inputs: the unexpanded
metrics agree with the reference to 1e-12; for the expanded ones the
reference itself takes an f32 product, so they agree to f32 rounding of
it, and the port is held to 1e-12 of a numpy/scipy evaluation in f64.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.distance import cdist

from raft_tpu.distance.pairwise import pairwise_distance as jpd
from raft_tpu.distance.types import DistanceType as JDT
from raft_tpu_torch.core import DeviceError, DeviceResources, LogicError
from raft_tpu_torch.distance import (METRIC_NAMES, DistanceType,
                                     pairwise_distance)
from raft_tpu_torch.ops import unexpanded as k8
from _torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(5)
CPU = DeviceResources(device="cpu")
N, M, D = 24, 40, 19


def _inputs(t, dtype=np.float32):
    x = rng.standard_normal((N, D))
    y = rng.standard_normal((M, D))
    if t in (DistanceType.KLDivergence, DistanceType.JensenShannon,
             DistanceType.HellingerExpanded):
        x, y = np.abs(x), np.abs(y)
        x[rng.random(x.shape) < 0.2] = 0.0
        x, y = x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    elif t in (DistanceType.HammingUnexpanded,):
        x, y = np.round(x), np.round(y)
    elif t in (DistanceType.RussellRaoExpanded, DistanceType.JaccardExpanded,
               DistanceType.DiceExpanded):
        x, y = (x > 0.3) * x, (y > 0.3) * y          # planted zeros
    return x.astype(dtype), y.astype(dtype)


def _assert_f32(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * (1.0 + np.abs(want).max()))


@pytest.mark.parametrize("name", sorted(METRIC_NAMES))
def test_every_metric_name_matches_reference(name):
    t = METRIC_NAMES[name]
    x, y = _inputs(t)
    p = 3.0 if t == DistanceType.LpUnexpanded else 2.0
    want = jpd(None, x, y, metric=name, p=p, batched=False)
    got = pairwise_distance(CPU, x, y, metric=name, p=p)
    assert got.dtype == torch.float32 and got.shape == (N, M)
    _assert_f32(got.numpy(), want)
    if t in k8.SUPPORTED:
        bound = k8.error_bound(x, y, t, p, got).numpy()
        assert np.all(np.abs(got.numpy() - np.asarray(want)) <= bound)


@pytest.mark.parametrize("t", list(DistanceType), ids=lambda t: t.name)
def test_every_distance_type_matches_reference(t):
    x, y = _inputs(t)
    want = jpd(None, x, y, metric=JDT[t.name], p=2.0, batched=False)
    got = pairwise_distance(None, torch.from_numpy(x), torch.from_numpy(y),
                            metric=t)
    _assert_f32(got.numpy(), want)


def test_minkowski_p3_and_scipy():
    x, y = _inputs(DistanceType.LpUnexpanded)
    got = pairwise_distance(CPU, x, y, metric="minkowski", p=3.0).numpy()
    want = jpd(None, x, y, metric="minkowski", p=3.0, batched=False)
    _assert_f32(got, want)
    np.testing.assert_allclose(got, cdist(x.astype(np.float64),
                                          y.astype(np.float64),
                                          "minkowski", p=3.0), rtol=1e-5)


def test_y_defaults_to_x_and_self_distance():
    x, _ = _inputs(DistanceType.L1)
    got = pairwise_distance(CPU, x, metric="l1")
    np.testing.assert_array_equal(np.diag(got.numpy()), 0.0)
    _assert_f32(got.numpy(), jpd(None, x, metric="l1", batched=False))
    sq = pairwise_distance(CPU, x, metric="sqeuclidean").numpy()
    assert np.all(sq >= 0.0)                     # clamped at 0, as the ref


@pytest.fixture()
def x64():
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)


_SCIPY = {"euclidean": "euclidean", "sqeuclidean": "sqeuclidean",
          "cosine": "cosine", "correlation": "correlation",
          "l1": "cityblock", "linf": "chebyshev", "canberra": "canberra",
          "braycurtis": "braycurtis", "hamming": "hamming",
          "jensenshannon": "jensenshannon"}


@pytest.mark.parametrize("name", sorted(METRIC_NAMES))
def test_f64_inputs(name, x64):
    t = METRIC_NAMES[name]
    x, y = _inputs(t, np.float64)
    p = 3.0 if t == DistanceType.LpUnexpanded else 2.0
    got = pairwise_distance(CPU, x, y, metric=name, p=p)
    assert got.dtype == torch.float64
    want = np.asarray(jpd(None, x, y, metric=name, p=p, batched=False))
    if t in k8.SUPPORTED:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12,
                                   atol=1e-12)
    else:
        _assert_f32(got.numpy(), want)
    if name in _SCIPY:
        np.testing.assert_allclose(got.numpy(), cdist(x, y, _SCIPY[name]),
                                   rtol=1e-12, atol=1e-12)
    if name == "inner_product":
        np.testing.assert_allclose(got.numpy(), x @ y.T, rtol=1e-12,
                                   atol=1e-12)


def test_unknown_metric_and_shape_checks():
    x = np.ones((3, 4), np.float32)
    with pytest.raises(LogicError):
        pairwise_distance(CPU, x, x, metric="nope")
    with pytest.raises(LogicError):
        pairwise_distance(CPU, x, np.ones((2, 5), np.float32))


def test_device_rule():
    """Numpy inputs go to the handle's device, or to cuda without one;
    ``device`` and CPU tensors choose the CPU."""
    x = np.ones((3, 4), np.float32)
    if torch.cuda.is_available():
        assert pairwise_distance(None, x, metric="l1").device.type == "cuda"
        return
    with pytest.raises(DeviceError):
        pairwise_distance(None, x, metric="l1")
    with pytest.raises(DeviceError):
        pairwise_distance(None, x, metric="euclidean")
    assert pairwise_distance(None, x, device="cpu").device.type == "cpu"
    assert pairwise_distance(CPU, x).device.type == "cpu"
    assert pairwise_distance(None, torch.ones(3, 4)).device.type == "cpu"


def test_kernel_failure_raises(monkeypatch):
    """A K8 failure reaches the caller: nothing turns it into the twin."""
    def broken(*a, **kw):
        raise DeviceError("unexpanded_pairwise_tiled: launch failed with "
                          "CUDA error 700")

    monkeypatch.setattr(k8, "unexpanded_pairwise_tiled", broken)
    with pytest.raises(DeviceError, match="700"):
        pairwise_distance(CPU, np.ones((3, 4), np.float32), metric="l1")
    from raft_tpu_torch.ops import _build

    def no_build(name):
        raise DeviceError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(k8, "_FN", None)
    with pytest.raises(DeviceError, match="unexpanded.cu"):
        k8._launcher()
