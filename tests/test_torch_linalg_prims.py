"""Parity of the port's linalg primitive layer (raft_tpu_torch.linalg: map,
eltwise, matrix_vector, norm, reduce, reduce_by_key, blas, transpose, init,
contractions) with the reference's, on the CPU.

Both packages get the same seeded numpy arrays at odd shapes (257 × 67).
Tolerances, each with its reason:
- one IEEE operation an element (add, multiply, divide, where,
  max/min, gather, transpose): bit for bit;
- ``sqrt`` and ``power`` (libm's against XLA's, which rounds sqrt one ulp
  off on ~0.5% of inputs): 1 and 2 ulp relative;
- a sum, product or product-sum of n terms, whose order XLA and torch
  choose differently: (n + 2)·2⁻²⁴·Σ|terms| per output (the f32 summation
  bound);
- the generic ``reduce_op`` branch, folded by the port as a pairwise tree
  and by the reference's ``jax.lax.reduce`` in XLA's order: the same bound
  for an associative sum, bit for bit for max;
- bf16 results: the f32 bound plus half a bf16 ulp (2⁻⁹ relative), where
  the two f32 sums may round to neighbouring bf16 values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import linalg as jl
from raft_tpu.core import operators as jops
from raft_tpu.linalg import contractions as jcon
from raft_tpu_torch import linalg as tl
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.core import operators as tops

from _torch_threads import one_torch_thread  # noqa: F401

RES = DeviceResources(device="cpu")
M, N = 257, 67
U = 2.0 ** -24
_rng = np.random.default_rng(0)
A = _rng.normal(size=(M, N)).astype(np.float32)
B = _rng.normal(size=(M, N)).astype(np.float32)
C = _rng.normal(size=(M, N)).astype(np.float32)
POS = _rng.uniform(0.5, 2.0, size=(M, N)).astype(np.float32)
VEC_R = _rng.normal(size=N).astype(np.float32)        # spans a row
VEC_C = _rng.normal(size=M).astype(np.float32)        # spans a column
VEC_R[::7] = 0.0
VEC_C[::5] = 0.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _exact(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert got.dtype == want.dtype or (got.dtype.kind == want.dtype.kind)
    np.testing.assert_array_equal(got, want)


def _within(got, want, bound):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= np.asarray(bound))


# ---------------------------------------------------------------- map
@pytest.mark.parametrize("case", ["map", "map_offset", "unary", "write_only",
                                  "binary", "ternary"])
def test_map_family_bit_for_bit(case):
    if case == "map":
        got = tl.map(RES, lambda a, b: a * b, _t(A), _t(B))
        want = jl.map(None, lambda a, b: a * b, A, B)
    elif case == "map_offset":
        got = tl.map_offset(RES, None, lambda i, a: a * (i % 7), _t(A))
        want = jl.map_offset(None, None, lambda i, a: a * (i % 7), A)
    elif case == "unary":
        got = tl.unary_op(RES, _t(A), lambda a: a * a)
        want = jl.unary_op(None, A, lambda a: a * a)
    elif case == "write_only":
        got = tl.write_only_unary_op(RES, (M, N), torch.int32,
                                     lambda i: i * 3)
        want = jl.write_only_unary_op(None, (M, N), jnp.int32,
                                      lambda i: i * 3)
    elif case == "binary":
        got = tl.binary_op(RES, _t(A), _t(B), lambda a, b: a - b)
        want = jl.binary_op(None, A, B, lambda a, b: a - b)
    else:
        got = tl.ternary_op(RES, _t(A), _t(B), _t(C),
                            lambda a, b, c: torch.where(a > b, c, a))
        want = jl.ternary_op(None, A, B, C,
                             lambda a, b, c: jnp.where(a > b, c, a))
    _exact(got, want)


# ---------------------------------------------------------------- eltwise
_BINARY = ["add", "subtract", "multiply", "divide", "eltwise_add",
           "eltwise_sub", "eltwise_multiply", "eltwise_divide",
           "eltwise_divide_check_zero"]
_SCALAR = ["add_scalar", "subtract_scalar", "multiply_scalar",
           "divide_scalar", "scalar_add", "scalar_multiply"]


@pytest.mark.parametrize("name", _BINARY)
def test_eltwise_binary_bit_for_bit(name):
    b = B.copy()
    b[::3, ::4] = 0.0                  # the check-zero division's zeros
    _exact(getattr(tl, name)(RES, _t(A), _t(b)),
           getattr(jl, name)(None, A, b))


@pytest.mark.parametrize("name", _SCALAR)
def test_eltwise_scalar_bit_for_bit(name):
    _exact(getattr(tl, name)(RES, _t(A), 1.75),
           getattr(jl, name)(None, A, 1.75))


def test_eltwise_sqrt_and_power():
    # XLA's CPU sqrt is not correctly rounded: one ulp apart on ~0.5%
    np.testing.assert_allclose(_np(tl.sqrt(RES, _t(POS))),
                               _np(jl.sqrt(None, POS)), rtol=2 * U)
    for got, want in ((tl.power(RES, _t(POS), _t(B)),
                       jl.power(None, POS, B)),
                      (tl.power_scalar(RES, _t(POS), 2.5),
                       jl.power_scalar(None, POS, 2.5))):
        np.testing.assert_allclose(_np(got), _np(want), rtol=2 * 2 * U)


# ---------------------------------------------------------------- matrix-vector
_MV = ["binary_mult", "binary_mult_skip_zero", "binary_div",
       "binary_div_skip_zero", "binary_add", "binary_sub"]


@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
@pytest.mark.parametrize("name", _MV)
def test_matrix_vector_bit_for_bit(name, apply):
    vec = VEC_R if apply == "ALONG_ROWS" else VEC_C
    _exact(getattr(tl, name)(RES, _t(A), _t(vec), getattr(tl.Apply, apply)),
           getattr(jl, name)(None, A, vec, getattr(jl.Apply, apply)))


@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_matrix_vector_op_generic(apply):
    vec = VEC_R if apply == "ALONG_ROWS" else VEC_C
    ta, ja = getattr(tl.Apply, apply), getattr(jl.Apply, apply)
    _exact(tl.matrix_vector_op(RES, _t(A), _t(vec), lambda m, v: m * v - v,
                               ta),
           jl.matrix_vector_op(None, A, vec, lambda m, v: m * v - v, ja))
    _exact(tl.matrix_vector_op2(RES, _t(A), _t(vec), _t(vec),
                                lambda m, v, w: (m + v) * w, ta),
           jl.matrix_vector_op2(None, A, vec, vec,
                                lambda m, v, w: (m + v) * w, ja))
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError):
        tl.matrix_vector_op(RES, _t(A), _t(vec[:-1]), lambda m, v: m + v,
                            ta)


def test_matrix_vector_skip_zero_return_zero():
    for apply in ("ALONG_ROWS", "ALONG_COLUMNS"):
        vec = VEC_R if apply == "ALONG_ROWS" else VEC_C
        _exact(tl.binary_div_skip_zero(RES, _t(A), _t(vec),
                                       getattr(tl.Apply, apply),
                                       return_zero=True),
               jl.binary_div_skip_zero(None, A, vec,
                                       getattr(jl.Apply, apply),
                                       return_zero=True))


# ---------------------------------------------------------------- norms
@pytest.mark.parametrize("final_sqrt", [False, True])
@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
@pytest.mark.parametrize("norm_type", ["L1", "L2", "LINF"])
def test_norm(norm_type, apply, final_sqrt):
    got = tl.norm(RES, _t(A), getattr(tl.NormType, norm_type),
                  getattr(tl.Apply, apply), final_sqrt)
    want = jl.norm(None, A, getattr(jl.NormType, norm_type),
                   getattr(jl.Apply, apply), final_sqrt)
    if norm_type == "LINF":
        _exact(got, want)
        return
    axis = 1 if apply == "ALONG_ROWS" else 0
    n = A.shape[axis]
    terms = np.abs(A) if norm_type == "L1" else A * A
    bound = (n + 2) * U * terms.astype(np.float64).sum(axis)
    if final_sqrt and norm_type == "L2":
        bound = bound / np.sqrt(terms.sum(axis))        # d√s = ds / 2√s
    _within(got, want, bound)


def test_row_col_norm_final_op():
    got = tl.row_norm(RES, _t(A), tl.NormType.L1,
                      final_op=lambda x: x * 0.5)
    want = jl.row_norm(None, A, jl.NormType.L1, final_op=lambda x: x * 0.5)
    _within(got, want, (N + 2) * U * np.abs(A).sum(1))
    _exact(tl.col_norm(RES, _t(A), tl.NormType.LINF),
           jl.col_norm(None, A, jl.NormType.LINF))


@pytest.mark.parametrize("norm_type", ["L1", "L2", "LINF"])
def test_normalize(norm_type):
    a = A.copy()
    a[3] = 0.0                                   # a zero row stays zero
    got = tl.normalize(RES, _t(a), getattr(tl.NormType, norm_type))
    want = jl.normalize(None, a, getattr(jl.NormType, norm_type))
    # each entry x/‖x‖ (|·| ≤ 1): the norm's relative bound plus the
    # quotient's rounding
    _within(got, want, (N + 3) * U)
    assert not _np(got)[3].any()


# ---------------------------------------------------------------- reductions
def _sum_bound(terms, axis):
    n = terms.shape[axis] if terms.ndim > 1 else terms.shape[0]
    return (n + 2) * U * np.abs(terms).astype(np.float64).sum(axis)


@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_reduce_sum_with_index_op_and_inplace(apply):
    ta, ja = getattr(tl.Apply, apply), getattr(jl.Apply, apply)
    axis = 1 if apply == "ALONG_ROWS" else 0
    extent = M if axis == 1 else N
    target = _rng.normal(size=extent).astype(np.float32)
    got = tl.reduce(RES, _t(A), ta, init=1.5,
                    main_op=lambda v, i: v * (i % 3),
                    final_op=lambda x: x * 2.0,
                    inplace_target=_t(target))
    want = jl.reduce(None, A, ja, init=1.5,
                     main_op=lambda v, i: v * (i % 3),
                     final_op=lambda x: x * 2.0, inplace_target=target)
    idx = np.arange(A.shape[axis])
    mapped = A * ((idx % 3)[None, :] if axis == 1 else (idx % 3)[:, None])
    _within(got, want, 2 * _sum_bound(mapped, axis) + 4 * U * (
        np.abs(target) + 1.5))


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_reduce_min_max_bit_for_bit(op, apply):
    ta, ja = getattr(tl.Apply, apply), getattr(jl.Apply, apply)
    init = 10.0 if op == "min" else -10.0
    _exact(tl.reduce(RES, _t(A), ta, init, reduce_op=getattr(
        tops, f"{op}_op")),
        jl.reduce(None, A, ja, init, reduce_op=getattr(jops, f"{op}_op")))


@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_reduce_product(apply):
    ta, ja = getattr(tl.Apply, apply), getattr(jl.Apply, apply)
    axis = 1 if apply == "ALONG_ROWS" else 0
    got = tl.reduce(RES, _t(POS), ta, 1, reduce_op=tops.mul_op)
    want = jl.reduce(None, POS, ja, 1, reduce_op=jops.mul_op)
    # a product of n terms: n roundings, each relative
    n = POS.shape[axis]
    np.testing.assert_allclose(_np(got), _np(want), rtol=2 * (n + 2) * U)


@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_reduce_generic_tree_fold(apply):
    """A reduce_op that is not one of core.operators' monoids: the port's
    pairwise tree against the reference's jax.lax.reduce."""
    ta, ja = getattr(tl.Apply, apply), getattr(jl.Apply, apply)
    axis = 1 if apply == "ALONG_ROWS" else 0
    got = tl.reduce(RES, _t(A), ta, 0.0, reduce_op=lambda a, b: a + b)
    want = jl.reduce(None, A, ja, 0.0, reduce_op=lambda a, b: a + b)
    _within(got, want, 2 * _sum_bound(A, axis))
    _exact(tl.reduce(RES, _t(A), ta, -np.inf,
                     reduce_op=lambda a, b: torch.maximum(a, b)),
           jl.reduce(None, A, ja, -np.inf,
                     reduce_op=lambda a, b: jnp.maximum(a, b)))


def test_reduce_bf16_accumulates_in_f32():
    a16 = torch.from_numpy(A).to(torch.bfloat16)
    got = tl.reduce(RES, a16)
    want = jl.reduce(None, jnp.asarray(A, jnp.bfloat16))
    assert got.dtype == torch.float32 and np.asarray(want).dtype == np.float32
    _within(got, want, _sum_bound(_np(a16), 1))


def test_reduce_one_dimensional_and_empty_tree():
    v = A[0]
    _within(tl.reduce(RES, _t(v)), jl.reduce(None, v), _sum_bound(v, 0))
    got = tl.reduce(RES, torch.zeros((3, 0)), reduce_op=lambda a, b: a + b,
                    init=2.0)
    want = jl.reduce(None, np.zeros((3, 0), np.float32),
                     reduce_op=lambda a, b: a + b, init=2.0)
    _exact(got, want)


def test_coalesced_and_strided_reductions():
    _within(tl.coalesced_reduction(RES, _t(A)),
            jl.coalesced_reduction(None, A), _sum_bound(A, 1))
    _within(tl.strided_reduction(RES, _t(A)),
            jl.strided_reduction(None, A), _sum_bound(A, 0))


def test_map_then_reduce_and_mse():
    got = tl.map_then_reduce(RES, _t(A), _t(B), map_op=lambda a, b: a * b)
    want = jl.map_then_reduce(None, A, B, map_op=lambda a, b: a * b)
    _within(got, want, _sum_bound((A * B).ravel(), 0))
    got = tl.map_reduce(RES, _t(A), reduce_op=lambda a, b: a + b,
                        final_op=lambda x: x * 3.0)
    want = jl.map_reduce(None, A, reduce_op=lambda a, b: a + b,
                         final_op=lambda x: x * 3.0)
    _within(got, want, 6 * _sum_bound(A.ravel(), 0))
    _exact(tl.map_then_reduce(RES, _t(A), reduce_op=tops.max_op,
                              init=-np.inf),
           jl.map_then_reduce(None, A, reduce_op=jops.max_op, init=-np.inf))
    got = tl.mean_squared_error(RES, _t(A), _t(B), weight=0.5)
    want = jl.mean_squared_error(None, A, B, weight=0.5)
    _within(got, want, _sum_bound(((A - B) ** 2).ravel(), 0) / A.size)


def test_stats_reexports_the_one_mean_squared_error():
    from raft_tpu_torch import stats

    assert stats.mean_squared_error is tl.mean_squared_error


# ---------------------------------------------------------------- by key
def test_reduce_rows_by_key():
    keys = _rng.integers(0, 9, M)
    w = _rng.uniform(0.5, 1.5, M).astype(np.float32)
    for weights in (None, w):
        got = tl.reduce_rows_by_key(
            RES, _t(A), _t(keys), 9,
            weights=None if weights is None else _t(weights))
        want = jl.reduce_rows_by_key(None, A, keys, 9, weights=weights)
        terms = A if weights is None else A * w[:, None]
        counts = np.bincount(keys, minlength=9)[:, None]
        absum = np.zeros((9, N))
        np.add.at(absum, keys, np.abs(terms))
        _within(got, want, (counts + 2) * U * absum)


def test_reduce_cols_by_key():
    keys = _rng.integers(0, 5, N)
    got = tl.reduce_cols_by_key(RES, _t(A), _t(keys), 5)
    want = jl.reduce_cols_by_key(None, A, keys, 5)
    absum = np.zeros((M, 5))
    np.add.at(absum.T, keys, np.abs(A).T)
    _within(got, want, (np.bincount(keys, minlength=5)[None, :] + 2) * U
            * absum)


# ---------------------------------------------------------------- BLAS
def _mm_bound(a, b):
    k = a.shape[-1]
    return (k + 2) * U * (np.abs(a).astype(np.float64) @ np.abs(b))


@pytest.mark.parametrize("trans", [(False, False), (True, False),
                                   (False, True), (True, True)])
def test_gemm_f32(trans):
    ta, tb = trans
    a = A if not ta else A.T.copy()
    b = B.T.copy() if not tb else B.copy()
    c = _rng.normal(size=(M, M)).astype(np.float32)
    got = tl.gemm(RES, _t(a), _t(b), _t(c), alpha=0.5, beta=2.0,
                  trans_a=ta, trans_b=tb)
    want = jl.gemm(None, a, b, c, alpha=0.5, beta=2.0, trans_a=ta,
                   trans_b=tb)
    assert got.dtype == torch.float32
    _within(got, want, 0.5 * _mm_bound(A, B.T) + 4 * U * np.abs(c) * 2)


@pytest.mark.parametrize("pet", [None, "f32"])
def test_gemm_bf16_accumulates_in_f32(pet):
    a16 = torch.from_numpy(A).to(torch.bfloat16)
    b16 = torch.from_numpy(B.T.copy()).to(torch.bfloat16)
    got = tl.gemm(RES, a16, b16,
                  preferred_element_type=None if pet is None
                  else torch.float32)
    want = jl.gemm(None, jnp.asarray(A, jnp.bfloat16),
                   jnp.asarray(B.T, jnp.bfloat16),
                   preferred_element_type=None if pet is None
                   else jnp.float32)
    bound = _mm_bound(_np(a16), _np(b16))
    if pet is None:
        assert got.dtype == torch.bfloat16
        bound = bound + 2.0 ** -8 * np.abs(_np(want))
    else:
        assert got.dtype == torch.float32
    _within(got, want, bound)


def test_gemv_axpy_dot():
    x = _rng.normal(size=N).astype(np.float32)
    y = _rng.normal(size=M).astype(np.float32)
    got = tl.gemv(RES, _t(A), _t(x), _t(y), alpha=2.0, beta=-1.0)
    want = jl.gemv(None, A, x, y, alpha=2.0, beta=-1.0)
    _within(got, want, 2 * _mm_bound(A, x[:, None])[:, 0]
            + 4 * U * np.abs(y))
    got = tl.gemv(RES, _t(A), _t(y), trans_a=True)
    want = jl.gemv(None, A, y, trans_a=True)
    _within(got, want, _mm_bound(A.T, y[:, None])[:, 0])
    _exact(tl.axpy(RES, 3.0, _t(A), _t(B)), jl.axpy(None, 3.0, A, B))
    _within(tl.dot(RES, _t(A[0]), _t(B[0])), jl.dot(None, A[0], B[0]),
            _mm_bound(A[:1], B[:1].T)[0, 0])


def test_gemv_inner_dim_checked():
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError):
        tl.gemv(RES, _t(A), torch.zeros(N + 1))


# ---------------------------------------------------------------- transpose, init
def test_transpose_and_range_fill():
    got = tl.transpose(RES, _t(A))
    _exact(got, jl.transpose(None, A))
    assert got.is_contiguous()
    _exact(tl.transpose_inplace(RES, _t(A)), jl.transpose_inplace(None, A))
    _exact(tl.range_fill(RES, 3, 70), jl.range_fill(None, 3, 70))
    assert tl.range_fill(RES, 0, 4).device.type == "cpu"


# ---------------------------------------------------------------- contractions
def _sqdist_epilogue(xp):
    def epilogue(ip, xt, yt):
        return ((xt * xt).sum(1)[:, None] + (yt * yt).sum(1)[None, :]
                - 2.0 * ip)
    return epilogue


def test_tiled_contraction_concatenates_tiles():
    y = _rng.normal(size=(300, N)).astype(np.float32)
    tp = tl.KernelPolicy(m_tile=64, n_tile=128)
    jp = jcon.KernelPolicy(m_tile=64, n_tile=128)
    got = tl.tiled_contraction(RES, _t(A), _t(y), _sqdist_epilogue(torch),
                               policy=tp)
    want = jl.tiled_contraction(None, A, y, _sqdist_epilogue(jnp),
                                policy=jp)
    norms = (A * A).sum(1)[:, None] + (y * y).sum(1)[None, :]
    _within(got, want, 2 * (N + 4) * U * norms)


def test_tiled_contraction_accumulates():
    y = _rng.normal(size=(300, N)).astype(np.float32)

    def acc_fn(lib):
        def accumulate(acc, out, m0, n0):
            tile_max = out.max()
            return tile_max if acc is None else lib.maximum(acc, tile_max)
        return accumulate

    got = tl.tiled_contraction(RES, _t(A), _t(y), lambda ip, xt, yt: ip,
                               policy=tl.KernelPolicy(64, 128),
                               accumulate=acc_fn(torch))
    want = jl.tiled_contraction(None, A, y, lambda ip, xt, yt: ip,
                                policy=jcon.KernelPolicy(64, 128),
                                accumulate=acc_fn(jnp))
    _within(got, want, _mm_bound(A, y.T).max())


def test_kernel_policy_from_workspace():
    """The column tile from the handle's budget, as the reference sizes
    it from ``res.workspace.allocation_limit``."""

    class _Budget:
        class workspace:
            allocation_limit = 1 << 20

    small = DeviceResources(device="cpu", workspace_limit=1 << 20)
    for n_cols in (1, 67, 4096):
        t = tl.KernelPolicy.from_workspace(small, n_cols)
        j = jcon.KernelPolicy.from_workspace(_Budget, n_cols)
        assert (t.m_tile, t.n_tile) == (j.m_tile, j.n_tile)
    got = tl.tiled_contraction(None, _t(A[:5]), _t(B[:7]),
                               lambda ip, xt, yt: ip)
    assert got.device.type == "cpu" and got.shape == (5, 7)
