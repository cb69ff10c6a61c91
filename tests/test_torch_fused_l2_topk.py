"""Parity of the port's K1 twin (raft_tpu_torch.ops.fused_l2_topk) with the
reference's Pallas kernel (interpret mode on the CPU).

Both get the same numpy inputs. They sum the same exact bf16 products in
f32 in different orders, so a value may differ by that accumulation error
plus the truncation unit of the packed mantissa, 2^(pbits−23)·|v|, which a
last-bit difference can cross; decoded codes of a1/a2 agree on ≥ 99.9% of
slots (a near-tie may flip). a3's code means nothing under ``pair``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import fused_l2_topk_pallas as jk
from raft_tpu_torch.ops import fused_l2_topk as tk

Q, M, D, T, G, PBITS = 64, 8192, 128, 512, 8, 8


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(Q, D)).astype(np.float32)
    y = rng.normal(size=(M, D)).astype(np.float32)
    yyh = (0.5 * (y * y).sum(1)).astype(np.float32)
    yyh[-300:] = tk._PACK_PAD          # a padded tail: never wins
    xxh = (0.5 * (x * x).sum(1)).astype(np.float32)
    return x, y, yyh, xxh


def _jax_out(x, y, yyh, xxh, passes, pair):
    hi, lo = jk.split_hi_lo(jnp.asarray(y))
    out = jk.fused_l2_group_topk_packed(
        jnp.asarray(x), hi, lo, jnp.broadcast_to(jnp.asarray(yyh)[None],
                                                 (8, M)),
        jnp.full((1,), M, jnp.int32), T=T, Qb=64, passes=passes, tpg=G,
        pair=pair, stream=True, pbits=PBITS, xxh=jnp.asarray(xxh)[:, None])
    return [np.asarray(a) for a in out]


def _torch_out(x, y, yyh, xxh, passes, pair):
    hi, lo = tk.split_hi_lo(torch.from_numpy(y))
    out = tk.fused_l2_group_topk_packed(
        torch.from_numpy(x), hi, lo, torch.from_numpy(yyh), T=T, g=G,
        passes=passes, pair=pair, pbits=PBITS, xxh=torch.from_numpy(xxh))
    return [a.numpy() for a in out]


def _split(a):
    bits = a.view(np.int32)
    mask = (1 << PBITS) - 1
    return bits & mask, (bits & ~mask).view(np.float32)


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("pair", [False, True])
def test_twin_matches_pallas_kernel(data, passes, pair):
    x, y, yyh, xxh = data
    ref = _jax_out(x, y, yyh, xxh, passes, pair)
    got = _torch_out(x, y, yyh, xxh, passes, pair)
    acc = 2 * D * 2.0 ** -24 * np.linalg.norm(x, axis=1)[:, None] \
        * np.linalg.norm(y, axis=1).max()
    for n, (a, b) in enumerate(zip(got, ref)):
        assert a.shape == b.shape == (Q, -(-(M // T) // G) * 128)
        ca, va = _split(a)
        cb, vb = _split(b)
        if n < 2 or not pair:
            assert (ca == cb).mean() >= 0.999
        tol = 2 * 2.0 ** (PBITS - 23) * np.abs(vb) + acc
        assert np.all(np.abs(va - vb) <= tol)


def test_padded_tail_never_wins(data):
    x, y, yyh, xxh = data
    a1, a2, _ = _torch_out(x, y, yyh, xxh, 1, False)
    # the last group holds the 300 sentinel rows: decode every real slot
    # and check no sentinel row is among the bucket top-2
    n_ch = T // 128
    S = a1.shape[1]
    for a in (a1, a2):
        codes, vals = _split(a)
        real = vals < tk._PACK_PAD * 0.25
        slot = np.broadcast_to(np.arange(S), a.shape)
        col = ((slot // 128) * G + codes // n_ch) * T \
            + (codes % n_ch) * 128 + slot % 128
        assert np.all(col[real] < M - 300)
        assert np.all(~real[:, :] | (col < M))


def test_split_hi_lo_matches_reference():
    rng = np.random.default_rng(3)
    y = (rng.normal(size=(257, 130)) * 25).astype(np.float32)
    jhi, jlo = jk.split_hi_lo(jnp.asarray(y))
    thi, tlo = tk.split_hi_lo(torch.from_numpy(y))
    assert thi.dtype == tlo.dtype == torch.bfloat16
    np.testing.assert_array_equal(thi.float().numpy(),
                                  np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(tlo.float().numpy(),
                                  np.asarray(jlo.astype(jnp.float32)))
    # the lo half carries the residual: hi + lo is f32-grade
    resid = y - (thi.float() + tlo.float()).numpy()
    assert np.abs(resid).max() <= np.abs(y).max() * 2.0 ** -16


def test_wrapper_checks_envelope(data):
    x, y, yyh, xxh = data
    hi, lo = tk.split_hi_lo(torch.from_numpy(y))
    args = (torch.from_numpy(x), hi, lo, torch.from_numpy(yyh))
    with pytest.raises(ValueError, match="packing envelope"):
        tk.fused_l2_group_topk_packed(*args, T=T, g=128, passes=1,
                                      pbits=PBITS)
    with pytest.raises(ValueError, match="multiple of 128"):
        tk.fused_l2_group_topk_packed(*args, T=500, g=G, passes=1)
    with pytest.raises(ValueError, match="even chunk count"):
        tk.fused_l2_group_topk_packed(
            torch.from_numpy(x), hi[:384 * 4], lo[:384 * 4],
            torch.from_numpy(yyh[:384 * 4]), T=384, g=G, passes=1,
            pair=True)
