"""Parity of the port's select_k order (raft_tpu_torch.matrix.select_k and
raft_tpu_torch.sparse.matrix.select_k) with the reference's on rows where
the order is all that is tested: exact ties, ±0, ±inf, +NaN and −NaN.

The dense reference answers with ``jax.lax.top_k`` (IEEE total order,
ties at the lower position); its sparse select_k ranks by a stable
``jnp.lexsort`` (−0 equal to +0, every NaN last, ties in storage order).
Both packages get the same numpy inputs; values must be the reference's
bit for bit (NaN payloads and the sign of zero included) and ids
identical (tolerance 0).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.sparse_types import CSRMatrix as JCSR
from raft_tpu.matrix import SelectAlgo as JAlgo
from raft_tpu.matrix import select_k as j_select_k
from raft_tpu.sparse import matrix as jm
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.core.kvp import (flip_sign, order_key, smallest_by_key,
                                     total_order)
from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.matrix import SelectAlgo, select_k
from raft_tpu_torch.matrix.select_k_slotted import slotted_envelope
from raft_tpu_torch.sparse import matrix as tm

NEG_NAN = np.uint32(0xFFC00000).view(np.float32)
POS_NAN = np.uint32(0x7FC00000).view(np.float32)
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, POS_NAN, NEG_NAN],
                    np.float32)


@pytest.fixture(scope="module")
def res():
    return DeviceResources(device="cpu")


def _tied_rows(B: int, L: int, seed: int, specials: bool = True):
    """[B, L] f32 rows of small integers (many exact ties), with ±0, ±inf
    and ±NaN planted where ``specials``; row 0 is the probe row
    [3, 1, 1, −NaN, 2, 1, 0.5, 5] repeated."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 4, (B, L)).astype(np.float32)
    if specials:
        where = rng.random((B, L)) < 0.15
        v[where] = rng.choice(SPECIALS, int(where.sum()))
        probe = np.array([3, 1, 1, NEG_NAN, 2, 1, 0.5, 5], np.float32)
        v[0] = np.resize(probe, L)
    return v


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.itemsize])


def _same(tv, ti, jv, ji):
    np.testing.assert_array_equal(_bits(tv), _bits(jv))
    np.testing.assert_array_equal(np.asarray(ti), np.asarray(ji))


def _both(res, v, idx, k, select_min, algo, expect_warning):
    ctx = (pytest.warns(RuntimeWarning) if expect_warning
           else warnings.catch_warnings())
    with ctx:
        if not expect_warning:
            warnings.simplefilter("error")
        jv, ji = j_select_k(None, jnp.asarray(v),
                            None if idx is None else jnp.asarray(idx), k,
                            select_min, algo=JAlgo[algo.name])
    ctx = (pytest.warns(RuntimeWarning) if expect_warning
           else warnings.catch_warnings())
    with ctx:
        if not expect_warning:
            warnings.simplefilter("error")
        tv, ti = select_k(res, torch.from_numpy(v),
                          None if idx is None else torch.from_numpy(idx), k,
                          select_min, algo=algo)
    return tv, ti, jv, ji


# (algo, row length, k, explicit out-of-envelope): AUTO and XLA_TOPK on
# a short and a long row; SLOTTED past its pool capacity; RADIX (CHUNKED)
# on a row too short to chunk
CASES = [("AUTO", 32, 6, False), ("AUTO", 600, 40, False),
         ("XLA_TOPK", 32, 6, False), ("XLA_TOPK", 600, 40, False),
         ("SLOTTED", 600, None, True), ("RADIX", 15, 4, True)]


@pytest.mark.parametrize("with_idx", [False, True])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("algo,L,k,outside", CASES)
def test_select_k_ties_and_nans_match_reference(res, algo, L, k, outside,
                                                 select_min, with_idx):
    if k is None:
        k = slotted_envelope(L, L)[2] + 1
    for specials in (False, True):
        v = _tied_rows(5, L, 40 + L, specials)
        idx = None
        if with_idx:
            idx = np.random.default_rng(41).permutation(
                5 * L).reshape(5, L).astype(np.int32)
        _same(*_both(res, v, idx, k, select_min, SelectAlgo[algo],
                     outside))


def test_select_k_probe_row(res):
    """The probe row: the −NaNs first, then 0.5 twice, at the lower
    positions."""
    v = _tied_rows(1, 32, 0)
    tv, ti = select_k(res, torch.from_numpy(v), k=6)
    np.testing.assert_array_equal(ti.numpy(), [[3, 11, 19, 27, 6, 14]])


def _typed(dtype: str, v):
    """The same values in the reference's and the port's type (16-bit
    floats carried as bit patterns, so a NaN keeps its sign)."""
    if dtype == "float16":
        a = v.astype(np.float16)
        return jnp.asarray(a), torch.from_numpy(a)
    if dtype == "bfloat16":
        u = (v.view(np.uint32) >> 16).astype(np.uint16)   # exact: small ints
        return (jnp.asarray(u.view(jnp.bfloat16)),
                torch.from_numpy(u.view(np.int16)).view(torch.bfloat16))
    if dtype == "float64":
        a = v.astype(np.float64)
        return jnp.asarray(a), torch.from_numpy(a)
    a = np.where(np.isfinite(v), v, 7).astype(np.int32) - 1
    a[0, :3] = np.iinfo(np.int32).min                 # the negation's wrap
    return jnp.asarray(a), torch.from_numpy(a)


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float64",
                                   "int32"])
def test_select_k_other_types_match_reference(res, dtype, select_min):
    import jax

    if dtype == "float64":
        jax.config.update("jax_enable_x64", True)
    try:
        jv_in, tv_in = _typed(dtype, _tied_rows(4, 48, 7))
        jv, ji = j_select_k(None, jv_in, None, 10, select_min,
                            algo=JAlgo.XLA_TOPK)
        tv, ti = select_k(res, tv_in, None, 10, select_min)
        assert tv.dtype == tv_in.dtype
        got = tv.view(torch.int16) if dtype == "bfloat16" else tv
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(
            np.asarray(jv).view(np.uint16) if dtype == "bfloat16"
            else jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    finally:
        if dtype == "float64":
            jax.config.update("jax_enable_x64", False)


def test_total_order_and_key():
    """total_order is monotone in IEEE total order at every width, and an
    order key over a 64-bit type is refused."""
    f32 = np.array([NEG_NAN, -np.inf, -1, -0.0, 0.0, 0.25, 2, np.inf,
                    POS_NAN], np.float32)
    for t in (torch.from_numpy(f32), torch.from_numpy(f32).double(),
              torch.from_numpy(f32).half()):
        o = total_order(t)
        assert o.dtype == torch.int64
        assert bool((o[1:] > o[:-1]).all()), t.dtype
    assert torch.equal(total_order(torch.tensor([-3, 0, 5])),
                       torch.tensor([-3, 0, 5]))
    with pytest.raises(ValueError, match="stable sort"):
        order_key(torch.zeros(1, 3, dtype=torch.float64))
    v = torch.tensor([[2.0, 1.0, 1.0, 0.0]], dtype=torch.float64)
    got, pos = smallest_by_key(v, 3)
    assert pos.tolist() == [[3, 1, 2]]
    got, pos = smallest_by_key(v, 3, descending=True)
    assert pos.tolist() == [[0, 1, 2]]


def _csr(seed: int, n_rows: int = 12, n_cols: int = 9):
    """A CSR with tied values, ±0, ±inf, ±NaN, empty rows and rows shorter
    than k, in both packages (the same arrays)."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n_cols + 1, n_rows)
    counts[[2, 7]] = 0
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    indices = np.concatenate([np.sort(rng.choice(n_cols, c, replace=False))
                              for c in counts]).astype(np.int32)
    vals = rng.integers(0, 3, indptr[-1]).astype(np.float32)
    where = rng.random(indptr[-1]) < 0.3
    vals[where] = rng.choice(SPECIALS, int(where.sum()))
    shape = (n_rows, n_cols)
    j = JCSR(jnp.asarray(indptr), jnp.asarray(indices), jnp.asarray(vals),
             shape)
    t = CSRMatrix(torch.from_numpy(indptr), torch.from_numpy(indices),
                  torch.from_numpy(vals), shape)
    return j, t


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sparse_select_k_ties_match_reference(res, seed, select_min):
    jcsr, tcsr = _csr(seed)
    for k, fill in ((4, None), (11, -7.0)):
        jv, ji = jm.select_k(None, jcsr, k, select_min, fill)
        tv, ti = tm.select_k(res, tcsr, k, select_min, fill)
        _same(tv.numpy(), ti.numpy(), jv, ji)


def test_flip_sign_reverses_total_order():
    """flip_sign is the exact reversal of IEEE total order and its own
    inverse, bit for bit, on the specials and on random bit patterns (every
    NaN payload included)."""
    rng = np.random.default_rng(3)
    bits = np.concatenate([SPECIALS.view(np.int32),
                           rng.integers(-2 ** 31, 2 ** 31, 4096,
                                        dtype=np.int64).astype(np.int32)])
    v = torch.from_numpy(bits.view(np.float32).copy())
    f = flip_sign(v)
    assert torch.equal(total_order(f), ~total_order(v))
    assert torch.equal(flip_sign(f).view(torch.int32), v.view(torch.int32))
    o = torch.argsort(total_order(v))
    assert bool((total_order(f)[o][1:] < total_order(f)[o][:-1]).all())


@pytest.mark.parametrize("algo,L,k", [("SLOTTED", 16384, 16),
                                      ("BITONIC", 8192, 64),
                                      ("SLOTTED", 2048, 8)])
def test_select_k_slotted_largest_of_signed_rows(res, algo, L, k):
    """select_k through the slotted algorithm at select_min=False on rows
    of N(0, 1) beside tied integer rows with ±0, ±inf and ±NaN: ids and
    value bits are the reference's select_k's with the same algorithm
    (rows with a NaN re-solve exactly; on short rows the reference's slot
    fold keeps a poisoned candidate there, so those rows are held to its
    XLA_TOPK)."""
    rng = np.random.default_rng(L + k)
    v = rng.normal(size=(136, L)).astype(np.float32)
    v[128:] = _tied_rows(8, L, 7, specials=True)
    jv, ji = j_select_k(None, jnp.asarray(v), None, k, False,
                        algo=JAlgo[algo])
    jv, ji = np.asarray(jv), np.asarray(ji)
    if L < 4096:
        xv, xi = j_select_k(None, jnp.asarray(v), None, k, False,
                            algo=JAlgo.XLA_TOPK)
        nan = np.isnan(v).any(1)[:, None]
        jv = np.where(nan, np.asarray(xv), jv)
        ji = np.where(nan, np.asarray(xi), ji)
    tv, ti = select_k(res, torch.from_numpy(v), None, k, False,
                      algo=SelectAlgo[algo])
    _same(tv, ti, jv, ji)
