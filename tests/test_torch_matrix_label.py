"""Parity of the port's row gather and scatter, matrix manipulation
(raft_tpu_torch.matrix: gather, manip) and label utilities
(raft_tpu_torch.label) with the reference's, on the CPU. Every function
here copies, selects or compares values, or takes one IEEE operation an
element, so the two packages agree bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import label as jlab
from raft_tpu import matrix as jm
from raft_tpu.linalg import Apply as JApply
from raft_tpu_torch import label as tlab
from raft_tpu_torch import matrix as tm
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.core.error import LogicError
from raft_tpu_torch.linalg import Apply

from _torch_threads import one_torch_thread  # noqa: F401

RES = DeviceResources(device="cpu")
_rng = np.random.default_rng(3)
A = _rng.normal(size=(37, 23)).astype(np.float32)
SQ = _rng.normal(size=(19, 19)).astype(np.float32) + 3.0


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- gather
def test_gather_and_transform():
    idx = _rng.integers(0, 37, 50)
    _same(tm.gather(RES, _t(A), _t(idx)), jm.gather(None, A, idx))
    _same(tm.gather(RES, _t(A), _t(idx), transform_op=lambda r: r * 2.0),
          jm.gather(None, A, idx, transform_op=lambda r: r * 2.0))
    _same(tm.gather_inplace(RES, _t(A), _t(idx)),
          jm.gather_inplace(None, A, idx))


def test_gather_if():
    idx = _rng.integers(0, 37, 50)
    stencil = _rng.normal(size=50).astype(np.float32)
    _same(tm.gather_if(RES, _t(A), _t(idx), _t(stencil), lambda s: s > 0),
          jm.gather_if(None, A, idx, stencil, lambda s: s > 0))


def test_scatter():
    perm = _rng.permutation(37)
    _same(tm.scatter(RES, _t(A), _t(perm)), jm.scatter(None, A, perm))
    with pytest.raises(LogicError):
        tm.scatter(RES, _t(A), _t(perm[:-1]))


# ---------------------------------------------------------------- manip
def test_slice_reverse():
    _same(tm.slice(RES, _t(A), 3, 2, 30, 21), jm.slice(None, A, 3, 2, 30, 21))
    with pytest.raises(LogicError):
        tm.slice(RES, _t(A), 5, 2, 5, 21)
    for along in (True, False):
        _same(tm.reverse(RES, _t(A), along), jm.reverse(None, A, along))
    _same(tm.col_reverse(RES, _t(A)), jm.col_reverse(None, A))
    _same(tm.row_reverse(RES, _t(A)), jm.row_reverse(None, A))


@pytest.mark.parametrize("offset", [0, 4, -5, 23, -37])
@pytest.mark.parametrize("along", [True, False])
def test_shift(offset, along):
    extent = 37 if along else 23
    if abs(offset) > extent:
        with pytest.raises(LogicError):
            tm.shift(RES, _t(A), offset, along)
        return
    _same(tm.shift(RES, _t(A), offset, along, fill_value=-7.5),
          jm.shift(None, A, offset, along, fill_value=-7.5))


@pytest.mark.parametrize("mat", ["square", "tall", "wide"])
def test_diagonal_helpers(mat):
    m = {"square": SQ, "tall": A, "wide": A.T.copy()}[mat]
    diag = _rng.normal(size=min(m.shape) + 2).astype(np.float32)
    _same(tm.get_diagonal(RES, _t(m)), jm.get_diagonal(None, m))
    _same(tm.set_diagonal(RES, _t(m), _t(diag)),
          jm.set_diagonal(None, m, diag))
    _same(tm.invert_diagonal(RES, _t(m)), jm.invert_diagonal(None, m))
    _same(tm.upper_triangular(RES, _t(m)), jm.upper_triangular(None, m))
    _same(tm.lower_triangular(RES, _t(m)), jm.lower_triangular(None, m))


def test_set_diagonal_copies():
    m = _t(SQ)
    out = tm.set_diagonal(RES, m, torch.zeros(19))
    assert torch.equal(m, _t(SQ)) and not out.diagonal().any()


def test_eye_fill_on_the_handle_device():
    _same(tm.eye(RES, 5, 7), jm.eye(None, 5, 7))
    _same(tm.eye(RES, 6), jm.eye(None, 6))
    _same(tm.fill(RES, (3, 4), 2.5), jm.fill(None, (3, 4), 2.5))
    _same(tm.fill(RES, (2, 2), 7, dtype=torch.int32),
          jm.fill(None, (2, 2), 7, dtype=jnp.int32))
    assert tm.eye(RES, 3).device.type == "cpu"


@pytest.mark.parametrize("apply", ["ALONG_ROWS", "ALONG_COLUMNS"])
def test_linewise_op(apply):
    n = 23 if apply == "ALONG_ROWS" else 37
    v0 = _rng.normal(size=n).astype(np.float32)
    v1 = _rng.normal(size=n).astype(np.float32)
    _same(tm.linewise_op(RES, _t(A), _t(v0), _t(v1),
                         op=lambda m, a, b: m * a + b,
                         apply=getattr(Apply, apply)),
          jm.linewise_op(None, A, v0, v1, op=lambda m, a, b: m * a + b,
                         apply=getattr(JApply, apply)))


def test_print_matrix():
    m = np.arange(6, dtype=np.float32).reshape(2, 3)
    for kw in ({}, {"name": "M"}, {"h_separator": ",", "v_separator": ";"}):
        assert tm.print_matrix(_t(m), **kw) == jm.print_matrix(m, **kw)


# ---------------------------------------------------------------- labels
def test_get_unique_labels_and_make_monotonic():
    labels = _rng.choice([3, 17, -4, 9, 100], size=200)
    _same(tlab.get_unique_labels(RES, _t(labels)),
          jlab.get_unique_labels(None, labels))
    for zero_based in (True, False):
        tmono, tcls = tlab.make_monotonic(RES, _t(labels),
                                          zero_based=zero_based)
        jmono, jcls = jlab.make_monotonic(None, labels,
                                          zero_based=zero_based)
        _same(tmono, jmono)
        _same(tcls, jcls)
        assert tmono.dtype == torch.int32
    classes = np.array([100, 3, 17, -4, 9, 55])   # unsorted, one unused
    tmono, tcls = tlab.make_monotonic(RES, _t(labels), _t(classes))
    jmono, jcls = jlab.make_monotonic(None, labels, classes)
    _same(tmono, jmono)
    _same(tcls, jcls)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_labels(seed):
    rng = np.random.default_rng(seed)
    n = 300
    a = rng.integers(0, n // 6, n)
    b = rng.integers(0, n // 6, n)
    # labels must name a member: relabel each class by its least index
    a = np.array([np.flatnonzero(a == x).min() for x in a])
    b = np.array([np.flatnonzero(b == x).min() for x in b])
    got = tlab.merge_labels(RES, _t(a), _t(b))
    want = jlab.merge_labels(None, a, b)
    _same(got, want)
    assert got.dtype == torch.int32


def test_merge_labels_iteration_cap():
    """A chain that needs many rounds: the cap stops both packages after
    the same number of rounds."""
    n = 64
    a = np.arange(n) // 2 * 2                # pairs (0,1), (2,3), ...
    b = np.concatenate([[0], (np.arange(1, n) - 1) // 2 * 2 + 1])
    for cap in (1, 3, 100):
        _same(tlab.merge_labels(RES, _t(a), _t(b), max_iters=cap),
              jlab.merge_labels(None, a, b, max_iters=cap))
