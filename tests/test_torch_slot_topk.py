"""Parity of K1's slot forms in the port (``fused_l2_slot_topk`` and its
d-chunked form, ``raft_tpu_torch.ops.fused_l2_topk``) with the
reference's Pallas kernels (``raft_tpu/ops/fused_l2_topk_pallas.py:406,
:474``), run in interpret mode on the CPU. The wrappers are called on CPU
tensors, where they take their twins and launch nothing.

Tolerance. Both sides sum the same exact bf16 products in f32, in other
orders, so x·y may differ by 2·(d + 2)·2⁻²⁴·‖x‖·max‖y‖ (doubled: an
accumulation need not round to nearest), and d2 = (xx + yy) − 2·x·y by
twice that plus four units of the norms' rounding, 4·2⁻²⁴·(‖x‖² +
max‖y‖²): the stated bound for m1 and m2min. An id may differ only where
the two rows it names score within twice that bound in f64 (a tie the
rounding may break either way); non-finite entries must be equal in kind.
Integer-valued data makes every sum exact, and there the outputs must
agree bit for bit and keep the earlier row on a tie.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import fused_l2_topk_pallas as jk
from raft_tpu_torch.ops import fused_l2_topk as tk

Q, M, M_REAL, T, QB, D = 16, 1024, 1000, 256, 8, 128
D_WIDE, DC = 512, 256


def _data(d, seed, integer=False):
    """x [Q, d] and y [M, d], the rows past M_REAL zero (as a prepared
    index pads them)."""
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-2, 3, size=(Q, d)).astype(np.float32)
        y = rng.integers(-2, 3, size=(M, d)).astype(np.float32)
    else:
        x = rng.normal(size=(Q, d)).astype(np.float32)
        y = rng.normal(size=(M, d)).astype(np.float32)
    y[M_REAL:] = 0.0
    return x, y


def _norms(x, y):
    with np.errstate(invalid="ignore", over="ignore"):
        return ((x * x).sum(1).astype(np.float32),
                (y * y).sum(1).astype(np.float32))


def _reference(x, y, xx, yy, passes, m_real=M_REAL, dchunk=False, **kw):
    hi, lo = jk.split_hi_lo(jnp.asarray(y))
    fn = jk.fused_l2_slot_topk_dchunk if dchunk else jk.fused_l2_slot_topk
    return [np.asarray(a) for a in fn(
        jnp.asarray(x), hi, lo, jnp.asarray(xx)[:, None],
        jnp.asarray(yy)[None, :], jnp.full((1,), m_real, jnp.int32), T=T,
        Qb=QB, passes=passes, **kw)]


def _port(x, y, xx, yy, passes, m_real=M_REAL, dchunk=False, **kw):
    """The wrapper on CPU tensors, which must equal the twin bit for bit
    and launch nothing."""
    hi, lo = tk.split_hi_lo(torch.from_numpy(y))
    args = (torch.from_numpy(x), hi, lo, torch.from_numpy(xx),
            torch.from_numpy(yy), m_real)
    kw = dict(T=T, Qb=QB, passes=passes, **kw)
    if dchunk:
        got = tk.fused_l2_slot_topk_dchunk(*args, **kw)
        twin = tk.fused_l2_slot_topk_dchunk_ref(*args, **kw)
    else:
        got = tk.fused_l2_slot_topk(*args, **kw)
        twin = tk.fused_l2_slot_topk_ref(*args, **kw)
    assert tk.LAUNCHES_SLOT == tk.LAUNCHES_SLOT_DCHUNK == 0
    for a, b in zip(got, twin):
        assert torch.equal(a.isnan(), b.isnan())
        assert torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
    assert got[1].dtype == torch.int32
    return [t.numpy() for t in got]


def _bound(x, y):
    """[Q, 1] bound of |Δd2| over the finite rows (module doc)."""
    d = x.shape[1]
    fin_x = np.isfinite(x).all(1)
    fin_y = np.isfinite(y).all(1)
    xn = np.where(fin_x, np.linalg.norm(np.where(np.isfinite(x), x, 0),
                                        axis=1), 0.0)
    ymax = np.linalg.norm(y[fin_y], axis=1).max()
    return (4 * (d + 2) * 2.0 ** -24 * xn * ymax
            + 4 * 2.0 ** -24 * (xn * xn + ymax * ymax))[:, None]


def _score64(x, y, q, r, passes):
    """f64 d2 of query rows q against rows r from the bf16 factors the
    kernels multiply."""
    xt, yt = torch.from_numpy(x[q]), torch.from_numpy(y[r])
    xh = xt.to(torch.bfloat16)
    xl = (xt - xh.float()).to(torch.bfloat16)
    yh = yt.to(torch.bfloat16)
    yl = (yt - yh.float()).to(torch.bfloat16)
    s = (xh.double() * yh.double()).sum(1)
    if passes == 3:
        s += (xh.double() * yl.double()).sum(1)
        s += (xl.double() * yh.double()).sum(1)
    return ((xt.double() ** 2).sum(1) + (yt.double() ** 2).sum(1)
            - 2 * s).numpy()


def _assert_close(got, ref, x, y, passes, track=True):
    m1, i1, m2 = got
    r1, j1, r2 = ref
    S = (M // T) * 128
    assert m1.shape == r1.shape == i1.shape == (Q, S)
    assert m2.shape == r2.shape == (Q, 128)
    tol = _bound(x, y)
    for a, b in ((m1, r1), (m2, r2)):
        for kind in (np.isnan, np.isposinf, np.isneginf):
            assert np.array_equal(kind(a), kind(b))
        fin = np.isfinite(b)
        diff = np.abs(np.where(fin, a, 0.0) - np.where(fin, b, 0.0))
        assert np.all(diff <= np.broadcast_to(tol, a.shape))
    if not track:
        assert not i1.any() and not j1.any()
        return
    q, s = np.nonzero(i1 != j1)
    assert np.all(np.isfinite(r1[q, s]))       # −1 and ±inf slots agree
    gap = np.abs(_score64(x, y, q, i1[q, s], passes)
                 - _score64(x, y, q, j1[q, s], passes))
    assert np.all(gap <= 2 * tol[q, 0])


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("track", [True, False])
def test_slot_twin_matches_pallas_kernel(passes, mask, track):
    x, y = _data(D, 21)
    xx, yy = _norms(x, y)
    kw = dict(mask=mask, track=track)
    ref = _reference(x, y, xx, yy, passes, **kw)
    got = _port(x, y, xx, yy, passes, **kw)
    _assert_close(got, ref, x, y, passes, track)
    if mask and track:
        # no slot names a masked row
        assert got[1].max() < M_REAL and got[1].min() >= 0


@pytest.mark.parametrize("passes", [1, 3])
def test_slot_dchunk_twin_matches_pallas_kernel(passes):
    x, y = _data(D_WIDE, 22)
    xx, yy = _norms(x, y)
    ref = _reference(x, y, xx, yy, passes, dchunk=True, dc=DC)
    got = _port(x, y, xx, yy, passes, dchunk=True, dc=DC)
    _assert_close(got, ref, x, y, passes)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("form", ["track", "min_only", "dchunk"])
def test_slot_nonfinite_rows(form, passes):
    """±inf and NaN planted in query and index rows, and a −inf norm: the
    NaN stays in a2 (min-only: in a1) until displaced and reaches m2min,
    ±inf where the reference has it, the rest within the bound."""
    d = D_WIDE if form == "dchunk" else D
    x, y = _data(d, 23)
    x[3, 5], x[7, 0], x[11, 9] = np.inf, -np.inf, np.nan
    y[10, 4], y[300, 2], y[700, 100] = np.inf, -np.inf, np.nan
    xx, yy = _norms(x, y)
    yy[517] = -np.inf
    kw = ({"dchunk": True, "dc": DC} if form == "dchunk"
          else {"track": form == "track"})
    ref = _reference(x, y, xx, yy, passes, **kw)
    got = _port(x, y, xx, yy, passes, **kw)
    assert np.isnan(ref[2]).any() and np.isneginf(ref[0]).any()
    _assert_close(got, ref, x, y, passes, form != "min_only")


@pytest.mark.parametrize("passes", [1, 3])
def test_slot_exact_ties_keep_the_first_id(passes):
    """Integer data: every sum is exact, so the outputs agree bit for bit,
    and a tie within a lane (row r + 128 a copy of row r, the same slot)
    keeps the earlier row, as a numpy fold of the exact d2 says."""
    x, y = _data(D, 24, integer=True)
    for r in (0, 5, 260, 600):
        y[r + 128] = y[r]
    xx, yy = _norms(x, y)
    ref = _reference(x, y, xx, yy, passes)
    got = _port(x, y, xx, yy, passes)
    for a, b in zip(got, ref):
        assert np.array_equal(a, b)
    d2 = (xx[:, None] + yy[None, :] - 2 * (x @ y.T)).astype(np.float64)
    d2[:, M_REAL:] = np.inf
    c = d2.reshape(Q, M // T, T // 128, 128)
    first = np.argmin(c, axis=2)               # the first of equal minima
    want = ((np.arange(M // T)[:, None] * T)[None] + first * 128
            + np.arange(128)[None, None, :]).reshape(Q, -1)
    assert np.array_equal(got[1], want)
    for r in (0, 5, 260, 600):
        assert (got[1][:, (r // T) * 128 + r % 128] != r + 128).all()


def test_slot_pads_only_slots_keep_inf_and_no_id():
    """m_real = 800: lanes 32–127 of the last tile hold only pads."""
    x, y = _data(D, 25)
    y[800:] = 0.0
    xx, yy = _norms(x, y)
    ref = _reference(x, y, xx, yy, 1, m_real=800)
    got = _port(x, y, xx, yy, 1, m_real=800)
    _assert_close(got, ref, x, y, 1)
    pads = slice(3 * 128 + 32, 4 * 128)
    assert np.all(np.isposinf(got[0][:, pads])) and np.all(
        got[1][:, pads] == -1)


@pytest.mark.parametrize("bad", [{"T": 200}, {"Qb": 12}, {"dc": 384}])
def test_slot_errors_match_reference(bad):
    x, y = _data(D_WIDE, 26)
    xx, yy = _norms(x, y)
    kw = dict(T=T, Qb=QB, passes=1)
    kw.update(bad)
    hi, lo = jk.split_hi_lo(jnp.asarray(y))
    with pytest.raises(ValueError) as want:
        jk.fused_l2_slot_topk_dchunk(
            jnp.asarray(x), hi, lo, jnp.asarray(xx)[:, None],
            jnp.asarray(yy)[None], jnp.full((1,), M_REAL, jnp.int32), **kw)
    th, tl = tk.split_hi_lo(torch.from_numpy(y))
    args = (torch.from_numpy(x), th, tl, torch.from_numpy(xx),
            torch.from_numpy(yy), M_REAL)
    for fn in (tk.fused_l2_slot_topk_dchunk,
               tk.fused_l2_slot_topk_dchunk_ref):
        with pytest.raises(ValueError) as got:
            fn(*args, **kw)
        assert str(got.value) == str(want.value)
    if "dc" not in bad:          # the resident form checks the tiling too
        kw.pop("dc", None)
        for fn in (tk.fused_l2_slot_topk, tk.fused_l2_slot_topk_ref):
            with pytest.raises(ValueError) as got:
                fn(*args, **kw)
            assert str(got.value) == str(want.value)


def test_slot_rows_must_be_whole_tiles():
    """The port refuses a ragged M (the reference's grid would drop the
    tail rows without a word, the fault ``_check_tiling`` guards T
    against)."""
    x, y = _data(D, 27)
    xx, yy = _norms(x, y)
    hi, lo = tk.split_hi_lo(torch.from_numpy(y[:1000]))
    with pytest.raises(ValueError, match="whole number of T"):
        tk.fused_l2_slot_topk(torch.from_numpy(x), hi, lo,
                              torch.from_numpy(xx),
                              torch.from_numpy(yy[:1000]), M_REAL, T=T,
                              Qb=QB, passes=1)


@pytest.mark.parametrize("blocks,n_tiles,chunks,n_sm,want", [
    (32, 489, 16, 132, 15),     # the ladder: 16 query blocks × 2 halves
    (8, 64, 16, 132, 4),        # phase 2's resident shape, 512 queries
    (16, 489, 16, 132, 15),     # d-chunked: 16 query blocks, clusters of 2
    (2, 489, 16, 132, 8),       # one query block
    (32, 1, 16, 132, 1),        # one tile
    (4, 4, 2, 132, 1)])         # this file's shapes: every tile a range
def test_slot_tiles_per_block_fills_the_card(blocks, n_tiles, chunks, n_sm,
                                             want):
    """The slot kernels' grid: ranges of consecutive tiles that cover
    every tile, none empty, whose blocks fill the card (at least 90% of
    the SMs where there is that much work) and finish within 10% and one
    tile of an even spread of the tiles over the SMs."""
    tpb = tk.slot_range_tiles(blocks, n_tiles, chunks, n_sm)
    assert tpb == want
    ranges = -(-n_tiles // tpb)
    assert (ranges - 1) * tpb < n_tiles <= ranges * tpb
    assert blocks * ranges >= min(0.9 * n_sm, blocks * n_tiles)
    waves = -(-blocks * ranges // n_sm)
    assert waves * tpb <= 1.1 * blocks * n_tiles / n_sm + 1
