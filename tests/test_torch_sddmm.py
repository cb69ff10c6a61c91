"""Parity of the port's K7 twin (raft_tpu_torch.ops.sddmm), ``sddmm`` and
``masked_matmul`` (bitmap and bitset masks) with the reference (its Pallas
kernel in interpret mode on the CPU), and the ``beta`` and ``d``
envelopes.

Tolerances. The port sums each d-long dot in f32; the reference forms the
dense block on the MXU at bf16×3 (≈ 2⁻¹⁶ relative): against the reference
``2⁻¹⁵·Σ_k |a_k·b_k|`` per entry, against the exact (f64) value
``(d + 2)·2⁻²⁴·Σ_k |a_k·b_k|``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from raft_tpu.core.bitset import Bitset as JBitset
from raft_tpu.core.bitset import BitmapView as JBitmap
from raft_tpu.sparse import CSRMatrix as JCSR
from raft_tpu.sparse import linalg as jl
from raft_tpu_torch.core.bitset import BitmapView, BitsetView
from raft_tpu_torch.core.sparse_types import CSRMatrix
from raft_tpu_torch.ops import sddmm as k7
from raft_tpu_torch.sparse import linalg as tl
from raft_tpu_torch.sparse import tiled as tt
from _torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(13)
TILE = dict(R=64, C=128, E=512)


def _structure(m, n, density, seed):
    s = sp.random(m, n, density=density, random_state=seed,
                  dtype=np.float32, format="csr")
    ip, ix = s.indptr.astype(np.int32), s.indices.astype(np.int32)
    v = s.data.astype(np.float32)
    return (JCSR(ip, ix, v, (m, n)),
            CSRMatrix.from_numpy(ip, ix, v, (m, n), device="cpu"), s)


def _scales(A, B, rows, cols):
    """Σ_k |a_k·b_k| and the exact value of each entry, in f64."""
    a = A.astype(np.float64)[rows]
    b = B.astype(np.float64).T[cols]
    return np.abs(a * b).sum(1), (a * b).sum(1)


@pytest.mark.parametrize("m,n,d,density", [
    (300, 420, 64, 0.02),       # unaligned shapes → padded tiles
    (256, 256, 3, 0.05),        # d not a multiple of 4
    (200, 150, 130, 0.04),
])
def test_sddmm_tiled_twin_matches_reference(m, n, d, density):
    A = rng.normal(size=(m, d)).astype(np.float32)
    B = rng.normal(size=(d, n)).astype(np.float32)
    J, T, s = _structure(m, n, density, 1)
    ref = jl.sddmm(None, A, B, jl.prepare_sddmm(J, **TILE), alpha=2.0)
    out = tl.sddmm(None, torch.from_numpy(A), torch.from_numpy(B),
                   tl.prepare_sddmm(T, **TILE), alpha=2.0)
    rows, cols = np.asarray(J.row_ids()), np.asarray(J.indices)
    np.testing.assert_array_equal(out.rows.numpy(), rows)
    np.testing.assert_array_equal(out.cols.numpy(), cols)
    scale, exact = _scales(A, B, rows, cols)
    got = out.values.numpy()
    assert np.all(np.abs(got - np.asarray(ref.values))
                  <= 2.0 * 2.0 ** -15 * scale)
    assert np.all(np.abs(got - 2.0 * exact)
                  <= 2.0 * (d + 2) * 2.0 ** -24 * scale)
    # the twin on the reference's own layout, carried across
    t2 = tt.TiledPairs.from_numpy(jl.prepare_sddmm(J, **TILE), device="cpu")
    got2 = k7.sddmm_tiled(t2, A, B).numpy()
    assert np.all(np.abs(got2 - exact) <= (d + 2) * 2.0 ** -24 * scale)
    # and the gather path on the CSR structure
    g = tl.sddmm(None, A, B, T, alpha=2.0).values.numpy()
    assert np.all(np.abs(g - 2.0 * exact) <= 2.0 * (d + 2) * 2.0 ** -24
                  * scale)


def test_sddmm_gather_alpha_beta_matches_reference():
    A = rng.normal(size=(30, 6)).astype(np.float32)
    B = rng.normal(size=(6, 40)).astype(np.float32)
    J, T, s = _structure(30, 40, 0.2, 4)
    ref = jl.sddmm(None, A, B, J, alpha=2.0, beta=0.5)
    out = tl.sddmm(None, A, B, T, alpha=2.0, beta=0.5)
    assert isinstance(out, CSRMatrix)
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(out.indptr.numpy(), np.asarray(J.indptr))


def test_beta_and_d_envelopes():
    J, T, _ = _structure(256, 256, 0.03, 6)
    tp = tl.prepare_sddmm(T, **TILE)
    A = rng.normal(size=(256, 16)).astype(np.float32)
    B = rng.normal(size=(16, 256)).astype(np.float32)
    from raft_tpu.core.error import LogicError as JLogic
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(JLogic):
        jl.sddmm(None, A, B, jl.prepare_sddmm(J, **TILE), beta=0.5)
    with pytest.raises(LogicError):
        tl.sddmm(None, A, B, tp, beta=0.5)
    A6 = np.zeros((256, 600), np.float32)
    B6 = np.zeros((600, 256), np.float32)
    with pytest.raises(NotImplementedError):
        jl.sddmm(None, A6, B6, jl.prepare_sddmm(J, **TILE))
    with pytest.raises(NotImplementedError):
        tl.sddmm(None, A6, B6, tp)
    out = k7.sddmm_tiled(tp, np.ones((256, 512), np.float32),
                         np.ones((512, 256), np.float32))   # the edge of it
    assert torch.all(out == 512.0)
    with pytest.raises(ValueError):
        k7.sddmm_tiled(tp, A[:100], B)
    # an empty structure gives an empty result
    empty = CSRMatrix.from_numpy(np.zeros(257, np.int32),
                                 np.zeros(0, np.int32),
                                 np.zeros(0, np.float32), (256, 256),
                                 device="cpu")
    assert tl.sddmm(None, A, B, tl.prepare_sddmm(empty)).values.shape == (0,)


def test_masked_matmul_bitmap_and_bitset_match_reference():
    m, n, d = 64, 96, 16
    A = rng.normal(size=(m, d)).astype(np.float32)
    B = rng.normal(size=(n, d)).astype(np.float32)
    dense_mask = rng.random((m, n)) < 0.1
    jbm = JBitmap.from_dense(dense_mask)
    bm = BitmapView.from_dense(dense_mask, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbm.words).view(np.int32),
                                  bm.words.numpy())
    ref = jl.masked_matmul(None, A, B, jbm)
    out = tl.masked_matmul(None, A, B, bm)
    np.testing.assert_array_equal(out.indptr.numpy(), np.asarray(ref.indptr))
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-5, atol=1e-5)
    # prepared: the K7 twin over the mask's structure, same values
    from raft_tpu_torch.sparse.convert import bitmap_to_csr

    prep = tl.prepare_sddmm(bitmap_to_csr(bm), R=8, C=128, E=512)
    out2 = tl.masked_matmul(None, A, B, bm, prepared=prep)
    np.testing.assert_allclose(out2.values.numpy(), out.values.numpy(),
                               rtol=1e-5, atol=1e-5)
    # a bitset mask: one row pattern repeated for each row of A
    bits = rng.random(n) < 0.3
    jbs = JBitset.from_dense(bits)
    bs = BitsetView.from_dense(bits, device="cpu")
    np.testing.assert_array_equal(np.asarray(jbs.words).view(np.int32),
                                  bs.words.numpy())
    assert int(bs.count()) == int(jbs.count()) == int(bits.sum())
    ref = jl.masked_matmul(None, A, B, jbs, alpha=0.5)
    out = tl.masked_matmul(None, A, B, bs, alpha=0.5)
    np.testing.assert_array_equal(out.indices.numpy(),
                                  np.asarray(ref.indices))
    np.testing.assert_allclose(out.values.numpy(), np.asarray(ref.values),
                               rtol=1e-5, atol=1e-5)


def test_cpu_twin_launches_no_kernel():
    _, T, _ = _structure(100, 100, 0.05, 2)
    before = k7.LAUNCHES
    tl.sddmm(None, np.ones((100, 4), np.float32),
             np.ones((4, 100), np.float32), tl.prepare_sddmm(T, **TILE))
    assert k7.LAUNCHES == before


def test_entry_twin_and_the_kernel_off_the_card():
    """The entry-order twin equals the layout twin on the reference's own
    layout, and the kernel's entry point raises for CPU tensors."""
    J, _, _ = _structure(120, 90, 0.05, 9)
    A = torch.from_numpy(rng.normal(size=(120, 10)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(10, 90)).astype(np.float32))
    t = tt.TiledPairs.from_numpy(jl.prepare_sddmm(J, **TILE), device="cpu")
    assert torch.equal(k7.sddmm_entries_ref(A, B, t.rows, t.cols),
                       k7.sddmm_tiled_ref(t, A, B))
    from raft_tpu_torch.core.error import DeviceError

    with pytest.raises(DeviceError):
        k7.sddmm_entries(A, B, t.rows, t.cols)
