"""Parity of the port's pylibraft-compatible surface
(raft_tpu_torch.compat) with the reference's, on the CPU.

The array adapters are held on CPU tensors and numpy arrays (zero copy
where the reference's is: the same data pointer). ``eigsh`` and ``svds``
run the port's Lanczos and randomized sparse SVD, whose starting vector
and sketch come from a torch.Generator, not threefry: both packages are
held to scipy's f64 answer at the reference tests' tolerances (eigsh
2e-3 absolute at ``tol=1e-6``, svds 5% relative), and the port's
``svds`` equals its ``randomized_svds`` on the same seed bit for bit (on
the CPU, whose ``index_add_`` sums in order; the card's atomics do not).
``rmat`` fills its output in place with edges in range, as the
reference's.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import eigsh as scipy_eigsh

from raft_tpu import compat as jc
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu_torch import compat as tc
from raft_tpu_torch.core import DeviceError, DeviceResources
from raft_tpu_torch.sparse.solver import SvdsConfig, randomized_svds

from _torch_threads import one_torch_thread  # noqa: F401

CPU = DeviceResources(device="cpu")
JRES = JaxResources(seed=0)


def _sym(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, n)).astype(np.float32)
    d = (d + d.T) / 2
    return sp.csr_matrix(d * (np.abs(d) > 0.5))


def test_device_ndarray_round_trip():
    host = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = tc.device_ndarray(host, device="cpu")
    j = jc.device_ndarray(host)
    assert a.shape == j.shape == (2, 3) and a.ndim == j.ndim == 2
    np.testing.assert_array_equal(a.copy_to_host(), j.copy_to_host())
    np.testing.assert_array_equal(np.asarray(a), host)
    assert isinstance(a.to_torch(), torch.Tensor)
    for name in ("zeros", "ones", "empty"):
        z = getattr(tc.device_ndarray, name)((3, 2), dtype=np.int32,
                                             device="cpu")
        assert z.shape == (3, 2) and z.dtype == torch.int32
    assert tc.device_ndarray.zeros((3,), device="cpu").copy_to_host().sum() \
        == 0
    assert "device_ndarray(shape=(2, 3)" in repr(a)
    assert not hasattr(a, "__cuda_array_interface__")   # not on a card
    # a CPU tensor stays where it is; numpy defaults to the card
    assert tc.device_ndarray(torch.ones(2)).to_torch().device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            tc.device_ndarray(host)


def test_ai_and_cai_wrappers():
    host = np.arange(6, dtype=np.float32).reshape(2, 3)
    a = tc.ai_wrapper(host)
    ja = jc.ai_wrapper(host)
    assert a.shape == ja.shape and a.dtype == ja.dtype
    assert a.c_contiguous == ja.c_contiguous is True
    assert a.to_torch().data_ptr() == host.ctypes.data      # zero copy
    assert not tc.ai_wrapper(host.T).c_contiguous
    t = torch.arange(8, dtype=torch.float32)
    c = tc.cai_wrapper(t)
    assert c.shape == (8,) and c.dtype == torch.float32 and c.c_contiguous
    assert c.to_torch() is t
    s = tc.cai_wrapper(t[::2])                    # strided: kept as is
    assert s.to_torch().data_ptr() == t.data_ptr() and not s.c_contiguous
    np.testing.assert_array_equal(s.to_torch().numpy(),
                                  np.asarray(jc.cai_wrapper(
                                      np.arange(8, dtype=np.float32)[::2])
                                      .to_jax()))
    d = tc.device_ndarray(t, device="cpu")
    assert tc.cai_wrapper(d).to_torch() is d.to_torch()
    n = tc.cai_wrapper(np.arange(4, dtype=np.float32)[::2])   # a copy
    np.testing.assert_array_equal(n.to_torch().numpy(), [0, 2])


def test_auto_sync_handle():
    calls = {}

    @tc.auto_sync_handle
    def fn(x, handle=None):
        calls["handle"] = handle
        return torch.as_tensor(x) * 2

    out = fn(torch.ones(3), handle=CPU)
    assert calls["handle"] is CPU
    assert out.tolist() == [2.0, 2.0, 2.0]
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):     # the default handle: the card
            fn(torch.ones(3))
    assert tc.Handle is tc.DeviceResources is DeviceResources


@pytest.mark.parametrize("which", ["SA", "LA", "LM"])
def test_eigsh_against_scipy_as_the_reference(which):
    A = _sym(50, 0)
    ref = scipy_eigsh(A.toarray().astype(np.float64), k=4, which=which)[0]
    vals, vecs = tc.eigsh(A, k=4, which=which, ncv=24, tol=1e-6,
                          handle=CPU)
    jvals, _ = jc.eigsh(A, k=4, which=which, ncv=24, tol=1e-6, handle=JRES)
    assert vecs.shape == (50, 4) and vals.device.type == "cpu"
    key = np.abs if which == "LM" else (lambda v: v)
    for got in (vals.numpy(), np.asarray(jvals)):
        np.testing.assert_allclose(np.sort(key(got)), np.sort(key(ref)),
                                   atol=2e-3)


def test_eigsh_takes_dense_and_port_sparse():
    A = _sym(40, 1)
    ref = np.sort(np.abs(scipy_eigsh(A.toarray().astype(np.float64), k=3,
                                     which="LM")[0]))
    from raft_tpu_torch.sparse.convert import dense_to_csr

    for op in (torch.from_numpy(A.toarray()),
               tc.device_ndarray(A.toarray(), device="cpu"),
               dense_to_csr(A.toarray(), device="cpu")):
        vals, _ = tc.eigsh(op, k=3, ncv=20, handle=CPU)
        np.testing.assert_allclose(np.sort(np.abs(vals.numpy())), ref,
                                   atol=5e-3)


def test_svds_against_scipy_and_randomized_svds():
    A = sp.random(60, 40, density=0.2, random_state=1, dtype=np.float32)
    s_ref = np.linalg.svd(A.toarray(), compute_uv=False)[:3]
    U, S, V = tc.svds(A, k=3, n_power_iters=4, handle=CPU)
    _, jS, _ = jc.svds(A, k=3, n_power_iters=4, handle=JRES)
    assert U.shape == (60, 3) and V.shape == (40, 3)
    np.testing.assert_allclose(S.numpy(), s_ref, rtol=0.05)
    np.testing.assert_allclose(np.asarray(jS), s_ref, rtol=0.05)
    from raft_tpu_torch.compat.pylibraft import _sparse_operand

    _, S2, _ = randomized_svds(CPU, _sparse_operand(A, CPU.device),
                               SvdsConfig(3, n_power_iters=4, seed=42))
    assert torch.equal(S, S2)


def test_rmat_fills_in_place():
    out = tc.device_ndarray.zeros((1000, 2), dtype=np.int32, device="cpu")
    before = out.to_torch().data_ptr()
    got = tc.rmat(out, None, 8, 6, seed=3, handle=CPU)
    assert got is out and out.to_torch().data_ptr() == before
    arr = out.copy_to_host()
    assert arr.shape == (1000, 2) and arr[:, 0].max() < 256 \
        and arr[:, 1].max() < 64 and arr.min() >= 0
    jout = jc.device_ndarray(np.zeros((1000, 2), np.int32))
    jarr = jc.rmat(jout, None, 8, 6, seed=3, handle=JRES).copy_to_host()
    assert jarr.shape == arr.shape and jarr[:, 0].max() < 256
    t = torch.zeros(500, 2, dtype=torch.int64)
    assert tc.rmat(t, None, 5, 5, seed=1, handle=CPU) is t
    assert int(t.max()) < 32
    e = tc.rmat(300, None, 4, 4, seed=1, handle=CPU)
    assert e.shape == (300, 2)
