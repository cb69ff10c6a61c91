"""Parity of the port's selection (raft_tpu_torch.matrix.select_k with the
slotted, chunked and top-k algorithms, K3's twin, fold_group_top2) with the
reference's (raft_tpu.matrix, its Pallas K3 in interpret mode on the CPU).

Both packages get the same numpy inputs. K3's twin runs the reference's
min/max network on the same packed values, so its outputs are the
reference kernel's bit for bit; NaN slots must be NaN in both (a NaN's
payload may differ). The selections return values gathered from the input
and positions, which must be identical to the reference's (tolerance 0).
"""

import importlib
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.matrix import SelectAlgo as JAlgo
from raft_tpu.matrix import select_k as j_select_k
from raft_tpu.matrix import select_k_types as jtypes
from raft_tpu.matrix.select_k_chunked import select_k_chunked as j_chunked
from raft_tpu.matrix.select_k_slotted import select_k_slotted as j_slotted
from raft_tpu.matrix.select_k_slotted import slotted_envelope as j_envelope
from raft_tpu.ops.folds import fold_group_top2 as j_fold
from raft_tpu.ops.select_slotted_pallas import select_slot_topk_packed as jk3
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.matrix import SelectAlgo, select_k
from raft_tpu_torch.matrix import select_k_types as ttypes
from raft_tpu_torch.matrix.select_k import _algo_in_envelope
from raft_tpu_torch.matrix.select_k_chunked import select_k_chunked
from raft_tpu_torch.matrix.select_k_slotted import (lax_top_k,
                                                    select_k_slotted,
                                                    slotted_envelope)
from raft_tpu_torch.ops import fold_group_top2
from raft_tpu_torch.ops import select_slotted as tk3
from raft_tpu_torch.ops.fused_l2_topk import _PACK_PAD

T_SEL, BB = 8192, 8


@pytest.fixture(scope="module")
def res():
    return DeviceResources(device="cpu")


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_packed_equal(got, ref):
    """Bit for bit on every non-NaN slot, NaN exactly where ref is NaN."""
    for a, b in zip(got, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        nan_a, nan_b = np.isnan(a), np.isnan(b)
        np.testing.assert_array_equal(nan_a, nan_b)
        np.testing.assert_array_equal(a.view(np.int32)[~nan_a],
                                      b.view(np.int32)[~nan_b])


def _k3_ref(v, tpg):
    """The reference kernel on ``v`` padded as select_k_slotted pads it
    (columns to whole tiles and rows to Bb with _PACK_PAD), cut back."""
    B, L = v.shape
    Lp, Bp = -(-L // T_SEL) * T_SEL, -(-B // BB) * BB
    w = np.full((Bp, Lp), _PACK_PAD, np.float32)
    w[:B, :L] = v
    return [np.asarray(a)[:B] for a in jk3(jnp.asarray(w), T=T_SEL, Bb=BB,
                                           tpg=tpg)]


@pytest.mark.parametrize("shape", [(8, 16384), (16, 8192)])
@pytest.mark.parametrize("tpg", [1, 4])
def test_k3_twin_matches_pallas_kernel(shape, tpg):
    v = _normal(shape, 1)
    got = tk3.select_slot_topk_packed_ref(torch.from_numpy(v), T=T_SEL,
                                          tpg=tpg)
    _assert_packed_equal([a.numpy() for a in got], _k3_ref(v, tpg))


@pytest.mark.parametrize("tpg", [1, 4])
def test_k3_twin_nonfinite(tpg):
    v = _normal((8, 16384), 2)
    v[1, 5] = np.inf            # code 0: stays +inf
    v[1, 300] = np.inf          # a code OR'd in: NaN
    v[2, 700] = -np.inf
    v[3, 9000] = np.nan
    v[6, 128] = -np.inf
    got = tk3.select_slot_topk_packed_ref(torch.from_numpy(v), T=T_SEL,
                                          tpg=tpg)
    ref = _k3_ref(v, tpg)
    assert np.isnan(ref[2]).any()       # the planted values show up
    _assert_packed_equal([a.numpy() for a in got], ref)


def test_k3_wrapper_ragged_rows():
    """A ragged L (and B off a multiple of 8) through the port's wrapper,
    against the reference kernel on the padded input."""
    v = _normal((5, 3 * T_SEL + 1001), 3)
    v[4, 2 * T_SEL + 17] = np.nan
    for tpg in (1, 4):
        got = tk3.select_slot_topk_packed(torch.from_numpy(v), T=T_SEL,
                                          tpg=tpg)
        assert tk3.LAUNCHES == 0        # the CPU takes the twin
        _assert_packed_equal([a.numpy() for a in got], _k3_ref(v, tpg))


def test_k3_wrapper_checks():
    v = torch.zeros(2, 4096)
    with pytest.raises(ValueError, match="packing envelope"):
        tk3.select_slot_topk_packed(v, T=8192, tpg=8)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk3.select_slot_topk_packed(v, T=1000, tpg=1)
    with pytest.raises(ValueError, match="f32"):
        tk3.select_slot_topk_packed(v.double(), T=8192, tpg=1)


@pytest.mark.parametrize("g", [1, 4, 8, 64])
def test_fold_group_top2_matches_reference(g):
    v = _normal((6, 256), 4)
    v[0, :8] = v[0, 8]                  # ties: the first id stays
    v[2, 40] = np.inf
    ids = np.random.default_rng(5).permutation(6 * 256).reshape(6, 256)
    ids = ids.astype(np.int32)
    ref = j_fold(jnp.asarray(v), jnp.asarray(ids), g)
    got = fold_group_top2(torch.from_numpy(v), torch.from_numpy(ids), g)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---- select_k_slotted: the K3 path (L ≥ 4096) and the slot fold ----
SLOTTED_CASES = [(4, 16384, 16), (3, 5000, 8), (2, 65536, 256),
                 (8, 2048, 64), (5, 700, 8), (4, 4096, 100)]


@pytest.mark.parametrize("B,L,k", SLOTTED_CASES)
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("with_idx", [False, True])
def test_select_k_slotted_matches_reference(B, L, k, select_min, with_idx):
    v = _normal((B, L), 10 + L % 97)
    idx = (np.random.default_rng(6).permutation(B * L).reshape(B, L)
           .astype(np.int32) if with_idx else None)
    jv, ji = j_slotted(jnp.asarray(v), None if idx is None
                       else jnp.asarray(idx), k, select_min)
    tv, ti = select_k_slotted(torch.from_numpy(v), None if idx is None
                              else torch.from_numpy(idx), k, select_min)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_slotted_duplicates_take_the_exact_path():
    """Heavy duplicates put many of the top-k in one bucket: the
    certificate fails and the re-solve keeps the reference's answer,
    ties in position order."""
    v = np.tile(_normal((2, 64), 7), (1, 128))
    jv, ji = j_slotted(jnp.asarray(v), None, 32, True)
    tv, ti, n_fail = select_k_slotted(torch.from_numpy(v), None, 32, True,
                                      with_stats=True)
    assert n_fail == 2
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("bad", [-np.inf, np.inf, np.nan])
@pytest.mark.parametrize("L", [16384, 5000, 2048])
@pytest.mark.parametrize("select_min", [True, False])
def test_slotted_nonfinite_rows(bad, L, select_min):
    """±inf and NaN rows take the exact path and give the reference's
    answer. One reference fault is pinned instead of copied: on the short
    path a NaN poisons a group minimum without failing the certificate,
    and the reference returns another entry in its place for
    select_min=False; there the port answers as the reference's own exact
    top-k (XLA_TOPK) does."""
    v = _normal((8, L), 8)
    v[3, 1234] = bad
    v[5, 17] = bad if np.isnan(bad) else -bad
    tv, ti, n_fail = select_k_slotted(torch.from_numpy(v), None, 8,
                                      select_min, with_stats=True)
    if L < 4096 and np.isnan(bad) and not select_min:
        jv, ji = j_select_k(None, jnp.asarray(v), None, 8, select_min,
                            algo=JAlgo.XLA_TOPK)
    else:
        jv, ji = j_slotted(jnp.asarray(v), None, 8, select_min)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    # K3 packs code 9 into row 3's entry (NaN: the row fails); row 5's
    # entry has code 0 and keeps its value. The slot fold fails NaN rows
    assert n_fail >= (1 if L >= 4096 else 2 if np.isnan(bad) else 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("L", [8192, 1000])
def test_half_keys(dtype, L):
    v = torch.from_numpy(_normal((3, L), 9)).to(dtype)
    ref = v.float().numpy()
    jv, ji = j_slotted(jnp.asarray(ref).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float16), None, 16,
        True)
    tv, ti = select_k_slotted(v, None, 16, True)
    assert tv.dtype == dtype
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv).astype(np.float32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("dtype", [torch.float64, torch.int32])
def test_wide_and_integer_keys_raise(dtype):
    v = torch.arange(2 * 8192).reshape(2, 8192).to(dtype)
    with pytest.raises(NotImplementedError, match="f32/bf16/f16"):
        select_k_slotted(v, None, 8, True)
    with pytest.raises(NotImplementedError, match="f32/bf16/f16"):
        select_k_chunked(v, None, 8, True)


@pytest.mark.parametrize("L,k", [(8192, 16), (65536, 65), (3000, 40),
                                 (900, 5)])
def test_envelope_matches_reference(L, k):
    assert slotted_envelope(L, k) == j_envelope(L, k)
    assert slotted_envelope(L) == j_envelope(L)


# ---- select_k_chunked ----
@pytest.mark.parametrize("nc", [2, 8])
@pytest.mark.parametrize("B,L,k", [(4, 1000, 16), (3, 4099, 300),
                                   (2, 40, 30)])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_chunked_matches_reference(nc, B, L, k, select_min):
    v = _normal((B, L), 20 + L)
    v[0, 3] = v[0, 4]                       # a tie, kept in position order
    jv, ji = j_chunked(jnp.asarray(v), None, k, select_min, nc=nc)
    tv, ti = select_k_chunked(torch.from_numpy(v), None, k, select_min,
                              nc=nc)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_chunked_short_row_raises():
    with pytest.raises(NotImplementedError, match="too short"):
        select_k_chunked(torch.zeros(1, 15), None, 2, True, nc=8)


# ---- select_k: dispatch and envelope behaviour ----
@pytest.mark.parametrize("algo", list(SelectAlgo))
@pytest.mark.parametrize("L", [16384, 1500])
def test_select_k_every_algo_matches_reference(res, algo, L):
    v = _normal((6, L), 30)
    idx = np.random.default_rng(31).integers(0, 10**6, size=(6, L)).astype(
        np.int32)
    jv, ji = j_select_k(None, jnp.asarray(v), jnp.asarray(idx), 24, True,
                        algo=JAlgo[algo.name])
    tv, ti = select_k(res, torch.from_numpy(v), torch.from_numpy(idx), 24,
                      algo=algo)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_select_k_bitonic_takes_k3(res, monkeypatch):
    """BITONIC is SLOTTED's alias: a long row reaches K3's wrapper."""
    calls = []
    real = tk3.select_slot_topk_packed

    def spy(v, T, tpg):
        calls.append((tuple(v.shape), T, tpg))
        return real(v, T=T, tpg=tpg)

    monkeypatch.setattr(
        importlib.import_module("raft_tpu_torch.matrix.select_k_slotted"),
        "select_slot_topk_packed", spy)
    select_k(res, torch.from_numpy(_normal((2, 8192), 32)), k=100,
             algo=SelectAlgo.BITONIC)
    assert calls == [((2, 8192), 8192, 1)]        # k > 64: tpg 1


def test_explicit_request_outside_envelope_warns(res):
    v = torch.from_numpy(_normal((2, 600), 33))
    big_k = slotted_envelope(600, 500)[2] + 1
    with pytest.warns(RuntimeWarning, match="SLOTTED"):
        tv, ti = select_k(res, v, k=big_k, algo=SelectAlgo.SLOTTED)
    ref_v, ref_i = torch.topk(v, big_k, largest=False)
    torch.testing.assert_close(tv, ref_v)
    with pytest.warns(RuntimeWarning, match="CHUNKED"):
        select_k(res, v[:, :15], k=4, algo=SelectAlgo.RADIX)
    with pytest.warns(RuntimeWarning, match="SLOTTED"):
        select_k(res, v.double(), k=4, algo=SelectAlgo.BITONIC)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        select_k(res, v, k=big_k)                  # AUTO: silent


@pytest.mark.parametrize("algo", ["SLOTTED", "CHUNKED", "XLA_TOPK"])
@pytest.mark.parametrize("L,k", [(8192, 64), (8192, 600), (20, 4),
                                 (10, 4)])
def test_algo_in_envelope_matches_reference(algo, L, k):
    from raft_tpu.matrix.select_k import _algo_in_envelope as j_env

    for dt_t, dt_j in ((torch.float32, np.float32),
                       (torch.float64, np.float64)):
        assert (_algo_in_envelope(SelectAlgo[algo], L, k, dt_t)
                == j_env(JAlgo[algo], L, k, dt_j))


def test_types_match_reference():
    for name in ("kAuto", "kRadix8bits", "kRadix11bitsExtraPass",
                 "kWarpImmediate", "kWarpDistributedShm", "warpauto"):
        assert (ttypes.SelectAlgo.from_reference_name(name).value
                == jtypes.SelectAlgo.from_reference_name(name).value)
    for dt in (np.float32, np.float16, np.float64, np.int32, np.int8):
        assert (ttypes.f32_comparable_keys(dt)
                == jtypes.f32_comparable_keys(dt))
    assert ttypes.f32_comparable_keys(torch.bfloat16)


def test_lax_top_k_order():
    """NaN by sign at either end, ±inf inside, ties to the lower
    position: jax.lax.top_k's order."""
    import jax

    v = np.array([[3., np.nan, 1., -np.inf, 2., np.inf, -np.nan, 0.5, 1.]],
                 np.float32)
    jv, jp = jax.lax.top_k(jnp.asarray(v), 9)
    tv, tp = lax_top_k(torch.from_numpy(v), 9)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


# ---- select_min=False on tied rows holding ±0, ±inf and ±NaN ----
NEG_NAN = np.uint32(0xFFC00000).view(np.float32)
POS_NAN = np.uint32(0x7FC00000).view(np.float32)
SIGNED = np.array([0.0, -0.0, np.inf, -np.inf, POS_NAN, NEG_NAN],
                  np.float32)


def _signed_rows(L: int, k: int, seed: int, nan: bool):
    """[136, L] rows: 128 of N(0, 1) (few fail the certificate), then 8
    rows of small integers (exact ties everywhere) with ±0 and ±inf
    planted, and +NaN and −NaN too where ``nan``. Row 129 is zeros of both
    signs with a few positives: with ``nan`` it also holds +NaN and −NaN,
    fails the certificate and is re-solved with its ±0 inside the top k;
    without, k + 2 positives keep the ±0 (equal to the slot fold's
    compares) out of it. Row 130 holds a run of tied maxima. More than 128
    rows and few failures: the reference re-solves only its failed rows
    (its fallback tiers), as the port does, so each row is compared
    alone."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(136, L)).astype(np.float32)
    t = rng.integers(-3, 4, (8, L)).astype(np.float32)
    specials = SIGNED if nan else SIGNED[:4]
    where = rng.random((8, L)) < 0.1
    t[where] = rng.choice(specials, int(where.sum()))
    t[1] = np.where(rng.random(L) < 0.5, 0.0, -0.0)
    t[1, rng.choice(L, 3 if nan else k + 2, replace=False)] = 2.0
    if nan:
        t[1, [L // 3, L // 2]] = POS_NAN, NEG_NAN
    t[2, ::7] = 3.0
    v[128:] = t
    return v


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("L,k", [(16384, 16), (8192, 100), (2048, 8),
                                 (700, 6)])
@pytest.mark.parametrize("nan", [False, True])
def test_slotted_signed_ties_match_reference(L, k, nan):
    """The largest (select_min=False: the port ranks the sign-flipped
    bits, the reference −v) of tied rows with ±0, ±inf and ±NaN, through
    the streamed K3 route (L ≥ 4096, its CPU twin) and the plain slot
    fold: ids and value bits are the reference's. Rows with a NaN at
    L < 4096 re-solve in the port; the reference's slot fold keeps a
    poisoned candidate there for select_min=False (pinned in
    test_slotted_nonfinite_rows), so those rows are held to its own exact
    top-k."""
    v = _signed_rows(L, k, 90 + L + k, nan)
    tv, ti, n_fail = select_k_slotted(torch.from_numpy(v), None, k, False,
                                      with_stats=True)
    jv, ji = j_slotted(jnp.asarray(v), None, k, False)
    jv, ji = np.asarray(jv), np.asarray(ji)
    if L < 4096 and nan:
        xv, xi = j_select_k(None, jnp.asarray(v), None, k, False,
                            algo=JAlgo.XLA_TOPK)
        pinned = np.isnan(v).any(1)
        jv = np.where(pinned[:, None], np.asarray(xv), jv)
        ji = np.where(pinned[:, None], np.asarray(xi), ji)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), ji)
    if nan:
        assert n_fail >= 1             # NaN rows take the fallback


@pytest.mark.parametrize("L", [16384, 2048])
def test_slotted_fallback_rows_of_signed_zeros(L):
    """Rows that fail the certificate and are re-solved (the fallback
    alone): ±0 rows holding a +NaN and a −NaN (each a row's largest and
    smallest in total order), so the order of the ±0 inside the top k is
    the sign bit's and the position's."""
    rng = np.random.default_rng(5)
    v = rng.normal(size=(136, L)).astype(np.float32)
    z = np.where(rng.random((8, L)) < 0.5, 0.0, -0.0).astype(np.float32)
    z[:, 3], z[:, L - 5] = POS_NAN, NEG_NAN
    z[:4, 7] = np.inf
    v[128:] = z
    tv, ti, n_fail = select_k_slotted(torch.from_numpy(v), None, 12,
                                      False, with_stats=True)
    jv, ji = j_select_k(None, jnp.asarray(v), None, 12, False,
                        algo=JAlgo.XLA_TOPK)
    assert n_fail >= 8
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
