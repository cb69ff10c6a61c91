"""Parity of the port's K8 twin (raft_tpu_torch.ops.unexpanded) with the
reference: its Pallas kernel ``unexpanded_pairwise_tiled`` in interpret
mode and its jitted XLA path ``_unexpanded_jit``, for all ten unexpanded
metrics, odd shapes, d = 0, KL/JS inputs with zeros and inf/NaN rows.

Tolerance: the kernel-vs-twin bound of the module,
``ops.unexpanded.error_bound`` — (d + 2 + U)·2⁻²⁴·Σ_k |term_k| on the sum
carried through each finalize (U covers logf/powf), 0 for Linf and
Hamming — here between the twin and each reference implementation, which
sum the same terms in other orders. Non-finite entries must match in
kind (NaN, +inf, −inf) exactly.
"""

import numpy as np
import pytest
import torch

from raft_tpu.distance.pairwise import _unexpanded_jit
from raft_tpu.distance.types import DistanceType as JDT
from raft_tpu.ops.unexpanded_pallas import \
    unexpanded_pairwise_tiled as ref_kernel
from raft_tpu_torch.core import DeviceError
from raft_tpu_torch.distance import DistanceType as DT
from raft_tpu_torch.ops import unexpanded as k8
from _torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(17)
P = 3.0


def _prob(a, zero_frac=0.2):
    """Non-negative rows summing to 1, with exact zeros planted."""
    p = np.abs(a)
    p[rng.random(p.shape) < zero_frac] = 0.0
    return (p / np.maximum(p.sum(1, keepdims=True), 1e-30)).astype(np.float32)


def _inputs(t, n, m, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    y = rng.standard_normal((m, d)).astype(np.float32)
    if t in (DT.KLDivergence, DT.JensenShannon):
        return _prob(x), _prob(y)
    if t == DT.HammingUnexpanded:
        return np.round(x), np.round(y)
    return x, y


def _check(got, want, bound):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = np.asarray(bound, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~fin & ~np.isnan(want)],
                                  want[~fin & ~np.isnan(want)])
    diff = np.abs(got[fin] - want[fin])
    assert np.all(diff <= bound[fin]), float((diff - bound[fin]).max())


@pytest.mark.parametrize("t", k8.SUPPORTED, ids=lambda t: t.name)
def test_twin_matches_reference_kernel_and_xla(t):
    n, m, d = 37, 131, 19                    # ragged against every block
    x, y = _inputs(t, n, m, d)
    twin = k8.unexpanded_pairwise_tiled(torch.from_numpy(x),
                                        torch.from_numpy(y), t, P)
    assert twin.dtype == torch.float32 and twin.shape == (n, m)
    bound = k8.error_bound(x, y, t, P, twin).numpy()
    jt = JDT[t.name]
    _check(twin.numpy(), np.asarray(ref_kernel(x, y, jt, P)), bound)
    _check(twin.numpy(), np.asarray(_unexpanded_jit(x, y, jt, P, d, 8)),
           bound)
    if t in (DT.Linf, DT.HammingUnexpanded):      # exact in any order
        np.testing.assert_array_equal(
            twin.numpy(), np.asarray(_unexpanded_jit(x, y, jt, P, d, 8)))


@pytest.mark.parametrize("shape", [(1, 1, 1), (9, 257, 17), (64, 64, 32),
                                   (5, 3, 40)])
def test_twin_odd_shapes(shape):
    n, m, d = shape
    for t in (DT.L1, DT.Canberra, DT.BrayCurtis):
        x, y = _inputs(t, n, m, d)
        twin = k8.unexpanded_pairwise_tiled_ref(x, y, t, P)
        want = _unexpanded_jit(x, y, JDT[t.name], P, d, 4)
        _check(twin.numpy(), np.asarray(want),
               k8.error_bound(x, y, t, P, twin).numpy())


def test_twin_small_workspace_tiles_rows():
    """A workspace of one row a tile gives the same answer."""
    x, y = _inputs(DT.L1, 10, 50, 33)
    full = k8.unexpanded_pairwise_tiled_ref(x, y, DT.L1)
    one = k8.unexpanded_pairwise_tiled_ref(x, y, DT.L1, workspace=1)
    torch.testing.assert_close(one, full, rtol=0, atol=0)


def test_d_zero_gives_zeros():
    x = np.zeros((4, 0), np.float32)
    y = np.zeros((6, 0), np.float32)
    for t in k8.SUPPORTED:
        out = k8.unexpanded_pairwise_tiled(x, y, t)
        assert out.shape == (4, 6) and not out.any()
    np.testing.assert_array_equal(np.asarray(ref_kernel(x, y, JDT.L1, 2.0)),
                                  np.zeros((4, 6)))


@pytest.mark.parametrize("t", [DT.KLDivergence, DT.JensenShannon],
                         ids=lambda t: t.name)
def test_kl_js_with_zeros(t):
    """Zero entries on either side, whole zero rows and a row equal to
    another: the reference's zero handling of ``_kl_term``."""
    x, y = _inputs(t, 12, 20, 24)
    x[0] = 0.0
    x[1, :12] = 0.0
    y[3] = x[2]
    y[4, ::2] = 0.0
    twin = k8.unexpanded_pairwise_tiled(x, y, t)
    jt = JDT[t.name]
    bound = k8.error_bound(x, y, t, 2.0, twin).numpy()
    _check(twin.numpy(), np.asarray(_unexpanded_jit(x, y, jt, 2.0, 24, 4)),
           bound)
    _check(twin.numpy(), np.asarray(ref_kernel(x, y, jt, 2.0)), bound)
    if t == DT.KLDivergence:
        assert np.all(twin.numpy()[0] == 0.0)         # a ≤ 0 → 0


@pytest.mark.parametrize("t", k8.SUPPORTED, ids=lambda t: t.name)
def test_nonfinite_rows_follow_ieee(t):
    """inf, −inf and NaN planted in x and y: non-finite entries match the
    XLA path in kind (Linf propagates NaN as jnp.max does), the rest
    within the bound."""
    x, y = _inputs(t, 9, 14, 21)
    x[1, 3] = np.inf
    x[2, 0] = -np.inf
    x[3, 5] = np.nan
    y[4, 7] = np.inf
    y[5, 2] = np.nan
    y[6, :] = np.inf
    twin = k8.unexpanded_pairwise_tiled(x, y, t, P)
    want = np.asarray(_unexpanded_jit(x, y, JDT[t.name], P, 21, 4))
    _check(twin.numpy(), want, k8.error_bound(x, y, t, P, twin).numpy())
    assert np.isnan(twin.numpy()).any() or t in (DT.HammingUnexpanded,
                                                 DT.KLDivergence,
                                                 DT.JensenShannon)


def test_f64_stays_f64():
    x = rng.standard_normal((6, 9))
    y = rng.standard_normal((8, 9)).astype(np.float32)
    out = k8.unexpanded_pairwise_tiled(x, y, DT.L1)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(
        out.numpy(), np.abs(x[:, None, :] - y[None, :, :].astype(
            np.float64)).sum(2), rtol=1e-14, atol=1e-13)


def test_wrapper_checks_and_cpu_path_launches_nothing():
    before = k8.LAUNCHES
    k8.unexpanded_pairwise_tiled(np.ones((3, 4), np.float32),
                                 np.ones((2, 4), np.float32), DT.L1)
    assert k8.LAUNCHES == before == 0
    with pytest.raises(ValueError):
        k8.unexpanded_pairwise_tiled(np.ones((3, 4)), np.ones((2, 5)), DT.L1)
    with pytest.raises(ValueError):
        k8.unexpanded_pairwise_tiled(np.ones((3, 4)), np.ones((2, 4)),
                                     DT.CosineExpanded)
    # the launch path refuses a tensor that is not on a card: it never
    # turns into the twin
    with pytest.raises(DeviceError):
        k8._launch(torch.ones(3, 4), torch.ones(2, 4), DT.L1, 2.0)
