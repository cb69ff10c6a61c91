"""Parity of the port's linear assignment solver (raft_tpu_torch.solver)
with the reference's, on the CPU.

The auction's every step is elementwise arithmetic, a max or argmax
(first maximal column), or an order-free scatter max/min, each exact in
f32, so the port's assignments equal the reference's bit for bit, ties
included; only the objective and the certificate are sums, whose order
differs (tolerance (n + 2)·2⁻²⁴·Σ|terms|). The exact Jonker–Volgenant
tail's twin (``ops.lap_jv.lap_jv_solve_ref``, the CPU path of the CUDA kernel)
repeats the reference's ``_jv_solve`` operation for operation: its
assignment and duals, hence its f64 certificate, are identical.
Objectives are also held within the certified gap of scipy's optimum.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from raft_tpu import solver as js
from raft_tpu.core import DeviceResources as JaxResources
from raft_tpu.solver import linear_assignment as jla
from raft_tpu_torch import solver as ts
from raft_tpu_torch.core import DeviceResources
from raft_tpu_torch.ops import lap_jv as tjv
from raft_tpu_torch.solver import linear_assignment as tla

from _torch_threads import one_torch_thread  # noqa: F401

RES = DeviceResources(device="cpu")
JRES = JaxResources(seed=0)
U = 2.0 ** -24


def _costs(n, batch, kind, seed):
    rng = np.random.default_rng(seed)
    c = rng.random((batch, n, n)).astype(np.float32) * 100.0
    return np.floor(c) if kind == "int" else c


def _optimum(c):
    r, col = linear_sum_assignment(c)
    return float(c.astype(np.float64)[r, col].sum())


@pytest.mark.parametrize("kind", ["float", "int"])
@pytest.mark.parametrize("n,batch", [(8, 4), (64, 3), (256, 2)])
def test_auction_matches_reference(n, batch, kind):
    cost = _costs(n, batch, kind, seed=n)
    lap = ts.LinearAssignmentProblem(RES, n, batch)
    a, obj = lap.solve(torch.from_numpy(cost))
    jlap = js.LinearAssignmentProblem(JRES, n, batch)
    ja, jobj = jlap.solve(cost)
    assert a.dtype == torch.int32 and a.shape == (batch, n)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    bound = (n + 2) * U * 100.0 * n
    np.testing.assert_allclose(obj.numpy(), np.asarray(jobj), rtol=0,
                               atol=bound)
    gap = lap.get_optimality_gap_bound().numpy()
    np.testing.assert_allclose(gap, np.asarray(
        jlap.get_optimality_gap_bound()), rtol=0, atol=bound)
    for b in range(batch):
        got = float(cost[b].astype(np.float64)[np.arange(n),
                                               a[b].long().numpy()].sum())
        opt = _optimum(cost[b])
        assert opt - 1e-9 <= got <= opt + gap[b] + bound
    assert torch.equal(lap.get_assignments(), a)
    assert torch.equal(lap.get_objective(), obj)


def test_single_instance_and_solve_lap():
    cost = _costs(40, 1, "float", seed=1)[0]
    a, obj = ts.solve_lap(RES, cost)
    ja, jobj = js.solve_lap(JRES, cost)
    assert a.shape == (40,) and obj.shape == ()
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert abs(float(obj) - float(jobj)) <= 42 * U * 100 * 40
    known = np.array([[4, 1, 3], [2, 0, 5], [3, 2, 2]], np.float32)
    a, obj = ts.solve_lap(RES, known)
    assert a.tolist() == [1, 0, 2] and float(obj) == 5.0


@pytest.mark.parametrize("n", [16, 64, 200])
def test_jv_twin_matches_reference_jv(n):
    cost = _costs(n, 1, "float", seed=100 + n)[0]
    ja, ju = jla._jv_solve(cost, n)
    ta, tu = tjv.lap_jv_solve(torch.from_numpy(cost)[None])    # CPU: the twin
    np.testing.assert_array_equal(ta[0].numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tu[0].numpy(), np.asarray(ju))
    tg = tla._certify_f64(cost[None], ta.numpy(), tu.numpy())
    jg = jla._certify_f64(cost[None], np.asarray(ja)[None],
                          np.asarray(ju)[None])
    np.testing.assert_array_equal(tg, jg)
    got = float(cost.astype(np.float64)[np.arange(n),
                                        ta[0].long().numpy()].sum())
    assert abs(got - _optimum(cost)) <= tg[0] + 1e-9


def test_jv_twin_counts_steps_and_batches():
    cost = _costs(24, 3, "float", seed=7)
    a, u, steps = tjv.lap_jv_solve_ref(torch.from_numpy(cost), with_steps=True)
    assert a.shape == u.shape == (3, 24) and steps.shape == (3,)
    assert bool((steps >= 24).all())        # one step at least a row
    for b in range(3):
        ja, ju = jla._jv_solve(cost[b], 24)
        np.testing.assert_array_equal(a[b].numpy(), np.asarray(ja))
    assert tjv.LAUNCHES == 0
    with pytest.raises(ValueError):
        tjv.lap_jv_solve(torch.zeros(3, 4))


@pytest.mark.parametrize("kind", ["float", "int"])
def test_tol_contract_matches_reference(kind):
    """A tol below the auction's certificate re-solves exactly the
    instances that miss it, through the exact tail, in both packages."""
    n, batch = 48, 3
    cost = _costs(n, batch, kind, seed=5)
    lap = ts.LinearAssignmentProblem(RES, n, batch)
    lap.solve(torch.from_numpy(cost))
    gap0 = lap.get_optimality_gap_bound().numpy()
    # float: a tol between the smallest and the largest certificate, so
    # that some instances keep the auction's answer
    tol = 0.5 * float(gap0.min() + gap0.max()) if kind == "float" else 0.0
    a, obj = lap.solve(torch.from_numpy(cost), tol=tol)
    jlap = js.LinearAssignmentProblem(JRES, n, batch)
    ja, jobj = jlap.solve(cost, tol=tol)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    gap = lap.get_optimality_gap_bound().numpy()
    jgap = np.asarray(jlap.get_optimality_gap_bound())
    bound = (n + 2) * U * 100.0 * n
    # re-solved instances carry the f64 certificate, bit for bit
    redo = gap0 > tol
    assert redo.any()
    np.testing.assert_array_equal(gap[redo], jgap[redo])
    np.testing.assert_allclose(gap[~redo], jgap[~redo], rtol=0, atol=bound)
    assert np.all(gap <= tol)
    for b in range(batch):
        assert abs(float(obj[b]) - _optimum(cost[b])) <= gap[b] + bound


def test_value_error_beyond_the_tail_envelope(monkeypatch):
    cost = _costs(8, 1, "float", seed=9)[0]
    monkeypatch.setattr(tla, "_EXACT_TAIL_MAX_N", 4)
    with pytest.raises(ValueError, match="beyond the exact tail"):
        ts.LinearAssignmentProblem(RES, 8).solve(cost, tol=0.0)
    monkeypatch.setattr(jla, "_EXACT_TAIL_MAX_N", 4)
    with pytest.raises(ValueError, match="beyond the exact tail"):
        js.LinearAssignmentProblem(JRES, 8).solve(cost, tol=0.0)


def test_exact_tail_envelope_is_the_kernel_s():
    """One limit: the solver's envelope is the wrapper's, which is the
    kernel's shared-memory one, which is the reference's."""
    import pathlib
    import re

    from raft_tpu_torch.ops import lap_jv

    src = (pathlib.Path(lap_jv.__file__).parent / "csrc" / "lap_jv.cu")
    k_max = int(re.search(r"constexpr int kMaxN = (\d+);",
                          src.read_text()).group(1))
    assert tla._EXACT_TAIL_MAX_N == lap_jv.MAX_N == k_max
    assert tla._EXACT_TAIL_MAX_N == jla._EXACT_TAIL_MAX_N


def test_value_error_below_dual_resolution():
    cost = _costs(8, 1, "float", seed=10)[0]
    with pytest.raises(ValueError, match="even after the exact tail"):
        ts.LinearAssignmentProblem(RES, 8).solve(cost, tol=-1.0)
    with pytest.raises(ValueError, match="even after the exact tail"):
        js.LinearAssignmentProblem(JRES, 8).solve(cost, tol=-1.0)


def test_shape_checked():
    from raft_tpu_torch.core.error import LogicError

    with pytest.raises(LogicError):
        ts.LinearAssignmentProblem(RES, 5).solve(torch.zeros(4, 4))


def test_bid_count_and_check_interval(monkeypatch):
    """The stop condition read every CHECK_EVERY bids changes no answer:
    a bid with no unassigned row is a no-op."""
    cost = torch.from_numpy(_costs(32, 2, "float", seed=11))
    a1, _ = ts.LinearAssignmentProblem(RES, 32, 2).solve(cost)
    monkeypatch.setattr(tla, "CHECK_EVERY", 1)
    tla.BIDS = 0
    a2, _ = ts.LinearAssignmentProblem(RES, 32, 2).solve(cost)
    assert torch.equal(a1, a2) and tla.BIDS > 0
