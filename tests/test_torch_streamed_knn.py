"""Parity of the port's streamed KNN sweeps, fused L2-NN and select_k with
the reference's (both on the CPU, same numpy inputs).

Both sides compute the same f32 expanded distances in different summation
orders, so values agree to 1e-5 relative (1e-4 absolute near zero) and ids
exactly on this tie-free random data.
"""

import numpy as np
import pytest
import torch

from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.distance import fused_l2_nn_argmin as j_argmin
from raft_tpu.distance import knn as j_knn
from raft_tpu.matrix import select_k as j_select_k
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.distance import fused_l2_nn, fused_l2_nn_argmin, knn
from raft_tpu_torch.matrix import SelectAlgo, select_k

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def res():
    return DeviceResources(device="cpu")


@pytest.fixture(scope="module")
def jres():
    return JaxResources(seed=0)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    x = rng.normal(size=(40, 24)).astype(np.float32)
    y = rng.normal(size=(3000, 24)).astype(np.float32)
    y[17] = 0.0                      # a zero-norm index row
    x[5] = 0.0                       # and a zero-norm query
    return x, y


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine"])
def test_streamed_knn_matches_reference(res, jres, data, metric):
    x, y = data
    v_ref, i_ref = j_knn(jres, y, x, 12, metric=metric, algo="streamed",
                         tile=512)
    v, i = knn(res, y, x, 12, metric=metric, algo="streamed", tile=512)
    v_ref, i_ref = np.asarray(v_ref), np.asarray(i_ref)
    np.testing.assert_allclose(v.numpy(), v_ref, rtol=RTOL, atol=ATOL)
    rows = np.ones(len(x), bool)
    if metric in ("cosine", "inner_product"):
        # the zero query is at the same distance from every row: its ids
        # are a tie the values above already prove
        rows[5] = False
    np.testing.assert_array_equal(i.numpy()[rows], i_ref[rows])


def test_cosine_zero_norm_convention(res, data):
    x, y = data
    v, i = knn(res, y, x, 5, metric="cosine", algo="streamed")
    # a zero query normalizes to the zero vector: 1 − cos = 0.5 to every
    # unit row, and 0 to the zero index row
    assert int(i[5, 0]) == 17 and float(v[5, 0]) == 0.0
    np.testing.assert_allclose(v[5, 1:].numpy(), 0.5, rtol=1e-6)


def test_certified_sweep_matches_reference(res, jres, data):
    # n ≥ 16·tile routes both sides through the certified sweep
    x, y = data
    v_ref, i_ref = j_knn(jres, y, x, 8, algo="streamed", tile=128)
    v, i = knn(res, y, x, 8, algo="streamed", tile=128)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_auto_routes_streamed_on_cpu(res, data):
    x, y = data
    v_auto, i_auto = knn(res, y, x, 7)
    v, i = knn(res, y, x, 7, algo="streamed")
    torch.testing.assert_close(v_auto, v)
    torch.testing.assert_close(i_auto, i)
    with pytest.raises(Exception, match="certify"):
        knn(res, y, x, 7, certify="f32")


@pytest.mark.parametrize("sqrt", [False, True])
def test_fused_l2_nn_argmin_matches_reference(res, jres, data, sqrt):
    x, y = data
    v_ref, i_ref = j_argmin(jres, x, y, sqrt=sqrt, tile=256)
    v, i = fused_l2_nn_argmin(res, x, y, sqrt=sqrt, tile=256)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    kvp = fused_l2_nn(res, x, y, sqrt=sqrt)
    np.testing.assert_array_equal(kvp.key.numpy(), np.asarray(i_ref))


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("with_idx", [False, True])
def test_select_k_matches_reference(res, select_min, with_idx):
    rng = np.random.default_rng(4)
    vals = rng.normal(size=(9, 700)).astype(np.float32)
    idx = (rng.permutation(9 * 700).reshape(9, 700).astype(np.int32)
           if with_idx else None)
    v_ref, i_ref = j_select_k(None, vals, idx, k=33, select_min=select_min)
    v, i = select_k(res, vals, idx, k=33, select_min=select_min)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_select_k_algos(res):
    vals = torch.from_numpy(
        np.random.default_rng(8).normal(size=(4, 300)).astype(np.float32))
    v0, i0 = select_k(res, vals, k=10)
    for algo in (SelectAlgo.XLA_TOPK, SelectAlgo.CHUNKED, SelectAlgo.RADIX,
                 SelectAlgo.APPROX):
        v, i = select_k(res, vals, k=10, algo=algo)
        torch.testing.assert_close(v, v0)
        torch.testing.assert_close(i, i0)
    for algo in (SelectAlgo.SLOTTED, SelectAlgo.BITONIC):
        with pytest.raises(NotImplementedError, match="K3"):
            select_k(res, vals, k=10, algo=algo)
