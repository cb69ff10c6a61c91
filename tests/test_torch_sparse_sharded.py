"""Parity of the port's row-sharded SpMV and SpMM (raft_tpu_torch.sparse.
sharded: ``shard_spmv_operand``, ``spmv_sharded``, ``spmm_sharded``)
with the reference's (raft_tpu/sparse/sharded.py over
``jax.devices()[:p]``, its K6 Pallas kernels in interpret mode), on the
CPU through K6a's and K6c's twins.

Tolerances are tests/test_torch_spmv.py's. SpMV: per row
``(nnz_i + 2)·2⁻²⁴·Σ_j |a_ij·x_j|`` against the reference and an f64
product alike, and the sharded result bit for bit the port's unsharded
``spmv_tiled`` (a row block's sums run in the same order). SpMM: against
the reference ``2⁻¹⁵·Σ_j |a_ij·b_jv|`` (its one-hot selects are bf16×3),
against f64 the f32 bound.
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu.parallel import make_mesh as jmake_mesh
from raft_tpu.sparse import sharded as jsh
from raft_tpu_torch.parallel import make_mesh
from raft_tpu_torch.sparse import linalg as tl
from raft_tpu_torch.sparse import sharded as tsh

from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_spmv import _bound, _both, _f64, _matrix


@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("shape,density,pattern",
                         [((1000, 700), 0.01, "uniform"),
                          ((800, 800), 0.01, "powerlaw")])
def test_spmv_and_spmm_sharded_match_reference(p, shape, density, pattern):
    m = _matrix(*shape, density, pattern)
    jA, A = _both(m)
    jS = jsh.shard_spmv_operand(
        jA, jmake_mesh({"x": p}, devices=jax.devices()[:p]))
    S = tsh.shard_spmv_operand(A, make_mesh({"x": p}, devices=["cpu"] * p))
    assert S.n_shards == p and S.rb == jS.rb and S.shape == jS.shape
    rng = np.random.default_rng(5)
    x = rng.normal(size=shape[1]).astype(np.float32)
    y = tsh.spmv_sharded(S, torch.from_numpy(x)).numpy()
    ref = np.asarray(jsh.spmv_sharded(jS, x))
    tol = _bound(m, x)[:, 0]
    assert np.all(np.abs(y - ref) <= tol)
    assert np.all(np.abs(y - _f64(m, x)[:, 0]) <= tol)
    assert torch.equal(tl.spmv(None, S, torch.from_numpy(x)),
                       torch.from_numpy(y))
    B = rng.normal(size=(shape[1], 5)).astype(np.float32)
    Y = tsh.spmm_sharded(S, torch.from_numpy(B)).numpy()
    jY = np.asarray(jsh.spmm_sharded(jS, B))
    a_b = np.abs(m).astype(np.float64) @ np.abs(B.astype(np.float64))
    assert np.all(np.abs(Y - jY) <= 2.0 ** -15 * a_b + 1e-30)
    assert np.all(np.abs(Y - _f64(m, B)) <= _bound(m, B))
    np.testing.assert_array_equal(
        tl.spmm(None, S, torch.from_numpy(B), alpha=2.0).numpy(), 2.0 * Y)


def test_sharded_operand_refuses_f64_and_dense():
    m = _matrix(300, 200, 0.05, "uniform")
    _, A = _both(m)
    mesh = make_mesh({"x": 2}, devices=["cpu"] * 2)
    A64 = type(A)(A.indptr, A.indices, A.values.double(), A.shape)
    with pytest.raises(ValueError, match="f32"):
        tsh.shard_spmv_operand(A64, mesh)
    with pytest.raises(TypeError):
        tsh.shard_spmv_operand(torch.zeros(3, 3), mesh)
