"""Symmetric eigendecomposition of the port (counterpart of
``raft_tpu/linalg/eig.py``; ref: cpp/include/raft/linalg/eig.cuh:121,152,
190 ``eig_dc``, ``eig_dc_selective``, ``eig_jacobi``).

``eig_dc`` is ``torch.linalg.eigh`` (cuSOLVER syevd on the card).
``eig_jacobi`` is the reference's parallel two-sided Jacobi: a round-robin
tournament covers every index pair once a sweep, and each round applies its
⌊n/2⌋ disjoint rotations at once as paired row-then-column updates, O(n²)
a round. Eigenvalues ascend, as cuSOLVER's do.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device


def _square(res, A, who: str):
    A, = float_operands(input_device(res, A), A)
    expects(A.ndim == 2 and A.shape[0] == A.shape[1],
            "%s: square input required", who)
    return A


def eig_dc(res, A) -> Tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending, eigenvectors as columns).
    (ref: eig.cuh:121 ``eig_dc``)"""
    return torch.linalg.eigh(_square(res, A, "eig_dc"))


def eig_dc_selective(res, A, n_eig_vals: int, which: str = "largest"):
    """The ``n_eig_vals`` largest (``which="largest"``) or smallest
    eigenpairs, ascending. (ref: eig.cuh:152 ``eig_dc_selective``)"""
    w, v = eig_dc(res, A)
    if which == "largest":
        return w[-n_eig_vals:], v[:, -n_eig_vals:]
    return w[:n_eig_vals], v[:, :n_eig_vals]


def _round_robin_schedule(n: int) -> List[List[Tuple[int, int]]]:
    """Tournament pairings: n − 1 rounds (n even; n rounds with a bye slot
    when odd) of disjoint (p < q) pairs covering every pair once."""
    m = n + (n % 2)
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        pairs = [(players[i], players[m - 1 - i]) for i in range(m // 2)]
        rounds.append([(min(p, q), max(p, q)) for p, q in pairs
                       if max(p, q) < n])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return rounds


def _rotate(M, p, q, c, s, dim: int):
    """M's rows (``dim`` 0) or columns (1) p and q rotated in place:
    (c·M_p − s·M_q, s·M_p + c·M_q)."""
    Mp, Mq = M.index_select(dim, p), M.index_select(dim, q)
    M.index_copy_(dim, p, c * Mp - s * Mq)
    M.index_copy_(dim, q, s * Mp + c * Mq)


def _jacobi(A, n_sweeps: int, schedule):
    n = A.shape[0]
    A = A.clone()
    V = torch.eye(n, dtype=A.dtype, device=A.device)
    rounds = [torch.tensor(r, dtype=torch.int64, device=A.device)
              for r in schedule]
    for _ in range(n_sweeps):
        for pairs in rounds:
            p, q = pairs[:, 0], pairs[:, 1]
            app, aqq, apq = A[p, p], A[q, q], A[p, q]
            # the angle that zeroes A[p, q]
            theta = 0.5 * torch.atan2(2.0 * apq, aqq - app)
            c, s = torch.cos(theta), torch.sin(theta)
            _rotate(A, p, q, c[:, None], s[:, None], 0)
            _rotate(A, p, q, c[None, :], s[None, :], 1)
            _rotate(V, p, q, c[None, :], s[None, :], 1)
    return A, V


def eig_jacobi(res, A, tol: float = 1e-7, sweeps: int = 15):
    """Parallel two-sided Jacobi over a fixed ``sweeps`` count (``tol`` is
    accepted and unused, as in the reference). Returns (eigenvalues
    ascending, eigenvectors as columns). (ref: eig.cuh:190
    ``eig_jacobi``)"""
    A = _square(res, A, "eig_jacobi")
    n = A.shape[0]
    if n == 1:
        return A[0], torch.ones((1, 1), dtype=A.dtype, device=A.device)
    D, V = _jacobi(A, sweeps, _round_robin_schedule(n))
    w = torch.diagonal(D)
    order = torch.argsort(w, stable=True)
    return w[order], V[:, order]
