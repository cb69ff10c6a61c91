"""Parity of the port's K9 twin (raft_tpu_torch.ops.histogram) with the
reference's Pallas ``histogram_blocked`` in interpret mode, and of
``stats.histogram`` (every ``HistType``) and ``value_histogram`` with the
reference's. Counts are integers: every comparison is exact."""

import numpy as np
import pytest
import torch

from raft_tpu import stats as jstats
from raft_tpu.ops.histogram_pallas import histogram_blocked as ref_blocked
from raft_tpu_torch import stats
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.ops import histogram as k9
from raft_tpu_torch.stats.histogram import HistType, _choose_hist_type
from _torch_threads import one_torch_thread  # noqa: F401

rng = np.random.default_rng(31)
CPU = DeviceResources(device="cpu")


@pytest.mark.parametrize("n,batch,n_bins", [
    (1500, 3, 16),      # ragged tail against the reference's 1024-row block
    (2048, 1, 64),
    (777, 8, 5),
    (0, 4, 7),          # no rows
])
def test_twin_matches_reference_kernel(n, batch, n_bins):
    # −1 (the reference's pad id) and ids ≥ n_bins are ignored
    bins = rng.integers(-3, n_bins + 4, size=(n, batch)).astype(np.int32)
    want = np.asarray(ref_blocked(bins, n_bins))
    got = k9.histogram_blocked(torch.from_numpy(bins), n_bins)
    assert got.dtype == torch.int32 and got.shape == (n_bins, batch)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        k9.histogram_blocked_ref(bins, n_bins).numpy(), want)


def test_twin_steps_and_wrapper_checks():
    """Steps of the twin's one-hot fold (a big n_bins·batch gives
    one-row steps) give the bincount's answer."""
    bins = rng.integers(0, 3000, size=(40, 7)).astype(np.int32)
    want = np.stack([np.bincount(bins[:, c], minlength=3000)
                     for c in range(7)], axis=1)
    old = k9._TWIN_ELEMS
    try:
        k9._TWIN_ELEMS = 3000 * 7
        np.testing.assert_array_equal(
            k9.histogram_blocked_ref(bins, 3000).numpy(), want)
    finally:
        k9._TWIN_ELEMS = old
    with pytest.raises(ValueError):
        k9.histogram_blocked(np.zeros((4,), np.int32), 3)
    with pytest.raises(ValueError):
        k9.histogram_blocked(np.zeros((4, 2), np.float32), 3)
    before = k9.LAUNCHES
    k9.histogram_blocked(bins, 3000)
    assert k9.LAUNCHES == before == 0       # the CPU path launches nothing


@pytest.mark.parametrize("ht", list(HistType), ids=lambda h: h.name)
def test_histogram_every_strategy_matches_reference(ht):
    data = rng.integers(-5, 40, size=(3000, 5)).astype(np.int32)
    jht = jstats.HistType[ht.name]
    want = np.asarray(jstats.histogram(None, data, 32, hist_type=jht))
    got = stats.histogram(CPU, data, 32, hist_type=ht)
    np.testing.assert_array_equal(got.numpy(), want)
    # 1-D data gives [n_bins]
    got1 = stats.histogram(CPU, data[:, 0], 32, hist_type=ht)
    want1 = np.asarray(jstats.histogram(None, data[:, 0], 32,
                                        hist_type=jht))
    assert got1.shape == (32,)
    np.testing.assert_array_equal(got1.numpy(), want1)


def test_histogram_custom_binner():
    data = rng.normal(size=(500, 3)).astype(np.float32) * 4.0
    want = np.asarray(jstats.histogram(
        None, data, 10, binner=lambda x, row: (x + 5.0).astype(np.int32)))
    got = stats.histogram(CPU, data, 10,
                          binner=lambda x, row: (x + 5.0).to(torch.int32))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_bins,lohi", [(64, None), (7, (-1.0, 2.5))])
def test_value_histogram_matches_reference(n_bins, lohi):
    values = rng.normal(size=(4099,)).astype(np.float32)
    kw = {} if lohi is None else dict(lo=lohi[0], hi=lohi[1])
    want = np.asarray(jstats.value_histogram(None, values, n_bins, **kw))
    got = stats.value_histogram(None, torch.from_numpy(values), n_bins, **kw)
    assert got.shape == (n_bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == values.size


def test_auto_rule():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    # the card takes K9 for every batch while n_bins ≤ 1024
    assert _choose_hist_type(cuda, 1, 64) is HistType.Blocked
    assert _choose_hist_type(cuda, 128, 1024) is HistType.Blocked
    assert _choose_hist_type(cuda, 8, 1025) is HistType.SegmentSum
    # the CPU follows the reference's non-TPU rule
    assert _choose_hist_type(cpu, 1, 64) is HistType.SegmentSum
    assert _choose_hist_type(cpu, 8, 64) is HistType.OneHot
    assert _choose_hist_type(cpu, 8, 2000) is HistType.SegmentSum
    # OneHot is K9's twin: the CPU's strategy, never the card's
    assert _choose_hist_type(cpu, 8, 64, HistType.OneHot) is HistType.OneHot
    assert _choose_hist_type(cuda, 8, 64, HistType.OneHot) is HistType.Blocked
    assert (_choose_hist_type(cuda, 8, 20000, HistType.OneHot)
            is HistType.SegmentSum)
    for ht in (HistType.Blocked, HistType.SegmentSum):
        assert _choose_hist_type(cuda, 8, 64, ht) is ht
    assert HistType.GlobalAtomics is HistType.SegmentSum
    assert HistType.SmemBits is HistType.Blocked
