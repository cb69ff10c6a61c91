"""Linear assignment problem (LAP) of the port (counterpart of
``raft_tpu/solver/linear_assignment.py``; ref: cpp/include/raft/solver/
linear_assignment.cuh:60 ``LinearAssignmentProblem``, ``solve()`` at :125).

The reference's design, kept: the auction algorithm (Bertsekas) with
ε-scaling, every unassigned row bidding at once, batched over instances;
then six sweeps of parallel improving 2-swaps; then a duality certificate,
a proven bound on ``objective − optimum``. A ``tol`` below the certificate
re-solves those instances exactly with the Jonker–Volgenant tail, whose
certificate is recomputed in f64 on the host.

In the port the auction is PyTorch operations on the cost's device. Its
``while_loop`` condition becomes one host read of "any row unassigned"
every :data:`CHECK_EVERY` bids: a bid with no unassigned row changes
nothing (every write goes through ``has_w``), so the extra bids of a
finished stage are no-ops and the iteration cap ``60·n + 2000`` holds
exactly. ``segment_max``/``segment_min`` become ``scatter_reduce`` with
``amax``/``amin`` (order-free: the same result every run); a row's best
column is the first maximal one (``torch.max``, as ``jnp.argmax``). The
exact tail is one hand-written CUDA kernel on the card
(``ops.lap_jv``), its twin on the CPU.

``solve_lap`` is the ``solver.solve_lap`` span and carries the
``solve_lap`` fault site, as the reference's does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.ops.lap_jv import MAX_N, lap_jv_solve
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point

#: bids between two host reads of the auction's stop condition
CHECK_EVERY = 32
#: the ε-scaling stages and the 2-swap sweeps (the reference's)
N_STAGES = 12
N_SWEEPS = 6
#: largest n the exact Jonker–Volgenant tail accepts (the reference's
#: envelope, and the CUDA kernel's shared-memory one)
_EXACT_TAIL_MAX_N = MAX_N

_BIG = 1e30

# auction bids run since import (or since a caller reset them), the
# no-op bids of finished stages included
BIDS = 0


def _stage(value, prices, eps, max_iters: int):
    """One ε stage of the auction from ``prices`` [b, n]: (prices, col_of
    [b, n] row → column), every row assigned (a capped stage completes
    its leftover rows onto the free columns in order)."""
    global BIDS
    b, n, _ = value.shape
    dev = value.device
    rows = torch.arange(n, device=dev).expand(b, n)
    cols = rows
    col_of = torch.full((b, n + 1), -1, dtype=torch.long, device=dev)
    row_of = torch.full((b, n), -1, dtype=torch.long, device=dev)
    big = torch.tensor(_BIG, dtype=value.dtype, device=dev)
    it = 0
    while it < max_iters:
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            unassigned = col_of[:, :n] < 0
            net = value - prices[:, None, :]
            v1, best_col = net.max(dim=2)            # first maximal column
            if n > 1:
                net.scatter_(2, best_col[:, :, None], -_BIG)
                v2 = net.amax(dim=2)
            else:
                v2 = torch.full_like(v1, -_BIG)
            bid = prices.gather(1, best_col) + (v1 - v2) + eps[:, None]
            seg = torch.where(unassigned, best_col, n)   # idle rows: slot n
            col_best = torch.full((b, n + 1), -torch.inf, dtype=value.dtype,
                                  device=dev).scatter_reduce_(
                1, seg, torch.where(unassigned, bid, -big), "amax")
            at_max = unassigned & (bid >= col_best.gather(1, best_col))
            winner = torch.full((b, n + 1), n, dtype=torch.long,
                                device=dev).scatter_reduce_(
                1, seg, torch.where(at_max, rows, n), "amin")[:, :n]
            has_w = winner < n
            # evict the previous owners of won columns, then assign
            col_of.scatter_(1, torch.where(has_w & (row_of >= 0), row_of, n),
                            -1)
            col_of.scatter_(1, torch.where(has_w, winner, n), cols)
            row_of = torch.where(has_w, winner, row_of)
            prices = torch.where(has_w, col_best[:, :n], prices)
        BIDS += min(CHECK_EVERY, max_iters - it)
        it += min(CHECK_EVERY, max_iters - it)
        if not bool((col_of[:, :n] < 0).any()):
            break
    col_of = col_of[:, :n]
    # a capped stage may leave rows unassigned: give them the free
    # columns in order, so that later stages and the certificate always
    # see a complete assignment
    unassigned_row = col_of < 0
    rank_r = (torch.cumsum(unassigned_row.long(), 1) - 1).clamp_min(0)
    free_ids = torch.sort((row_of >= 0).to(torch.uint8), dim=1,
                          stable=True).indices
    col_of = torch.where(unassigned_row, free_ids.gather(1, rank_r), col_of)
    return prices, col_of


def _sweep(cost, a):
    """Every mutually best improving pair swap of assignment ``a`` [b, n],
    applied at once."""
    b, n, _ = cost.shape
    rows = torch.arange(n, device=cost.device).expand(b, n)
    cii = cost.gather(2, a[:, :, None])[:, :, 0]
    cij = cost.gather(2, a[:, None, :].expand(b, n, n))   # cost[i, a_j]
    delta = cij + cij.transpose(1, 2) - cii[:, :, None] - cii[:, None, :]
    delta.diagonal(dim1=1, dim2=2).add_(_BIG)
    bestd, bestj = delta.min(dim=2)
    ok = (bestd < 0) & (rows < bestj) & (bestj.gather(1, bestj) == rows)
    a_new = torch.cat([torch.where(ok, a.gather(1, bestj), a),
                       a.new_zeros((b, 1))], dim=1)
    a_new.scatter_(1, torch.where(ok, bestj, n), a)
    return a_new[:, :n]


def _auction_solve(cost):
    """Min-cost assignment of cost [b, n, n] f32 by the auction:
    (row → column [b, n] int64, certified gap [b] f32)."""
    b, n, _ = cost.shape
    value = -cost
    max_iters = 60 * n + 2000
    # ε-scaling: the final ε bounds the objective error by n·ε, 1/(n + 1)
    # making integer costs exact; ε is floored at the f32 resolution of
    # the prices (max_abs·2⁻²⁰), below which bids no longer move them
    max_abs = value.abs().amax(dim=(1, 2)).clamp_min(1e-12)
    eps_floor = max_abs * (2.0 ** -20)
    eps_list = [torch.maximum(max_abs / (4.0 ** i), eps_floor)
                for i in range(1, N_STAGES)]
    eps_list.append(torch.maximum(torch.minimum(
        torch.full_like(max_abs, 1.0 / (n + 1)),
        max_abs / (4.0 ** N_STAGES)), eps_floor))
    prices = torch.zeros((b, n), dtype=torch.float32, device=cost.device)
    for eps in eps_list:
        prices, assign = _stage(value, prices, eps, max_iters)
    for _ in range(N_SWEEPS):
        assign = _sweep(cost, assign)
    # certificate: with the final prices p, row i's slack
    # σᵢ = max_k(value[i, k] − p[k]) − (value[i, aᵢ] − p[aᵢ]) ≥ 0, and Σσ
    # bounds the gap to the optimum (complementary slackness)
    net = value - prices[:, None, :]
    slack = net.amax(dim=2) - net.gather(2, assign[:, :, None])[:, :, 0]
    return assign, slack.clamp_min(0.0).sum(dim=1)


def _certify_f64(cost_np: np.ndarray, assign_np: np.ndarray,
                 u_np: np.ndarray) -> np.ndarray:
    """The enforced optimality-gap certificate, f64 on the host: the row
    duals projected to feasibility (v_j = min_i cost[i, j] − u_i), then
    ``objective − optimum ≤ obj − Σu − Σv`` by LP duality, each term
    summed in f64 so that rounding cannot under-report the gap. Inputs:
    cost [b, n, n], assign [b, n] (row → column), u [b, n]."""
    cost64 = np.asarray(cost_np, np.float64)
    u64 = np.asarray(u_np, np.float64)
    a = np.asarray(assign_np, np.int64)
    v_feas = (cost64 - u64[:, :, None]).min(axis=1)
    obj = np.take_along_axis(cost64, a[:, :, None], axis=2)[:, :, 0].sum(
        axis=1)
    return np.maximum(obj - (u64.sum(axis=1) + v_feas.sum(axis=1)), 0.0)


class LinearAssignmentProblem:
    """(ref: solver/linear_assignment.cuh:60)"""

    def __init__(self, res, size: int, batchsize: int = 1):
        self.res = res
        self.size = int(size)
        self.batchsize = int(batchsize)
        self._row_assignments = None
        self._obj = None
        self._gap_bound = None

    def solve(self, cost, tol: float = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Min-cost assignment of cost [n, n] or [batch, n, n] on its
        device (numpy: the handle's, else cuda). Returns (row assignments
        int32, objective). (ref: :125 ``solve``)

        ``tol`` is the accuracy contract, a proven absolute bound on
        ``objective − optimum``: None accepts the auction with its
        certificate; a number re-solves the instances whose certificate
        exceeds it with the exact Jonker–Volgenant tail (n ≤ 8192) and
        raises ValueError when the certified gap still exceeds it (n past
        the tail's envelope, or a tol below the f32 duals' resolution,
        ~n·max|cost|·2⁻²⁴). ``get_optimality_gap_bound()`` returns the
        last solve's certified bound."""
        cost, = as_tensors(self.res, cost)
        single = cost.ndim == 2
        if single:
            cost = cost[None]
        expects(cost.shape[1] == cost.shape[2] == self.size,
                "LAP: cost must be [batch, %d, %d]", self.size, self.size)
        cost_f = cost.to(torch.float32).contiguous()
        assign, gap = _auction_solve(cost_f)
        if tol is not None:
            need = (gap > tol).cpu().numpy()
            if need.any():
                if self.size > _EXACT_TAIL_MAX_N:
                    raise ValueError(
                        f"LAP: auction certificate {float(gap.max()):.3g} "
                        f"exceeds tol={tol:g} and n={self.size} is beyond "
                        f"the exact tail's envelope ({_EXACT_TAIL_MAX_N}); "
                        "loosen tol or reduce n")
                # re-solve only the instances that missed the contract
                idx = torch.as_tensor(np.flatnonzero(need),
                                      device=cost.device)
                assign_x, u_x = lap_jv_solve(cost_f[idx])
                assign[idx] = assign_x.long()
                gap_x = _certify_f64(cost_f[idx].cpu().numpy(),
                                     assign_x.cpu().numpy(),
                                     u_x.cpu().numpy())
                gap[idx] = torch.as_tensor(gap_x, dtype=torch.float32,
                                           device=cost.device)
                worst = float(max(gap_x.max(initial=0.0), float(gap.max())))
                if worst > tol:
                    raise ValueError(
                        f"LAP: certified gap {worst:.3g} exceeds tol={tol:g}"
                        " even after the exact tail — the certificate is "
                        "bounded below by f32 dual resolution "
                        "(~n·max|cost|·2⁻²⁴ for float costs); loosen tol")
        obj = cost.gather(2, assign[:, :, None])[:, :, 0].sum(dim=1)
        assign = assign.to(torch.int32)
        self._row_assignments = assign[0] if single else assign
        self._obj = obj[0] if single else obj
        self._gap_bound = gap[0] if single else gap
        return self._row_assignments, self._obj

    def get_assignments(self):
        return self._row_assignments

    def get_objective(self):
        return self._obj

    def get_optimality_gap_bound(self):
        """Proven upper bound on ``objective − optimum`` of the last solve
        (0.0: provably optimal). See :meth:`solve`."""
        return self._gap_bound


@instrument("solver.solve_lap")
def solve_lap(res, cost, tol: float = None):
    """Functional wrapper; see :meth:`LinearAssignmentProblem.solve`."""
    fault_point("solve_lap")
    cost, = as_tensors(res, cost)
    return LinearAssignmentProblem(res, cost.shape[-1]).solve(cost, tol=tol)
