"""Randomized SVD of the port (counterpart of ``raft_tpu/linalg/rsvd.py``;
ref: cpp/include/raft/linalg/rsvd.cuh:158 ``rsvd_fixed_rank`` /
``rsvd_fixed_rank_symmetric`` / ``rsvd_perc`` and detail/rsvd.cuh:33
``randomized_svd``): a Gaussian sketch, QR, power iterations each
re-orthonormalized by QR, one small SVD of the ℓ × n core, projected back.

The sketch is drawn from a ``torch.Generator`` (default the handle's)
where the reference takes a JAX key; :func:`_rsvd_from_sketch` is the rest,
given the sketch.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import (ensure_resources,
                                           float_operands, input_device)


def _rsvd_from_sketch(A, omega, k: int, n_iters: int, gen_U: bool = True,
                      gen_V: bool = True):
    """Everything after the sketch ``omega`` [n, ℓ]: (U [m, k], S [k],
    V [n, k]), a factor not asked for None."""
    Q, _ = torch.linalg.qr(A @ omega)              # m × ℓ
    for _ in range(n_iters):                       # subspace iterations
        Z, _ = torch.linalg.qr(A.T @ Q)
        Q, _ = torch.linalg.qr(A @ Z)
    Ub, S, Vt = torch.linalg.svd(Q.T @ A, full_matrices=False)
    U = (Q @ Ub)[:, :k] if gen_U else None
    V = Vt.T[:, :k] if gen_V else None
    return U, S[:k], V


def randomized_svd(res, A, k: int, p: int = 10, n_iters: int = 2,
                   generator: Optional[torch.Generator] = None,
                   gen_U: bool = True, gen_V: bool = True):
    """Rank-``k`` truncated SVD of A [m, n] with ``p`` oversamples:
    (U [m, k], S [k] descending, V [n, k]). (ref: detail/rsvd.cuh:33
    ``randomized_svd``)"""
    A, = float_operands(input_device(res, A), A)
    m, n = A.shape
    expects(0 < k <= min(m, n), "randomized_svd: bad rank k=%d", k)
    ell = min(k + p, n)
    if generator is None:
        generator = ensure_resources(res).generator
    omega = torch.randn((n, ell), generator=generator, dtype=A.dtype,
                        device=generator.device).to(A.device)
    return _rsvd_from_sketch(A, omega, k, n_iters, gen_U, gen_V)


def rsvd_fixed_rank(res, A, k: int, p: int = 10, n_iters: int = 2,
                    use_bbt: Optional[bool] = None,
                    generator: Optional[torch.Generator] = None):
    """Fixed rank plus oversampling (``use_bbt`` is accepted and unused,
    as in the reference). (ref: rsvd.cuh ``rsvd_fixed_rank``)"""
    return randomized_svd(res, A, k, p, n_iters, generator)


def rsvd_fixed_rank_symmetric(res, A, k: int, p: int = 10, n_iters: int = 2,
                              generator: Optional[torch.Generator] = None):
    """For a symmetric A, in the SVD convention (U ≈ ±V). (ref: rsvd.cuh
    ``rsvd_fixed_rank_symmetric``)"""
    return randomized_svd(res, A, k, p, n_iters, generator)


def rsvd_perc(res, A, sv_perc: float, p_perc: float = 0.05,
              n_iters: int = 2, generator: Optional[torch.Generator] = None):
    """Rank and oversamples as fractions of min(m, n). (ref: rsvd.cuh
    ``rsvd_perc``)"""
    mn = min(A.shape)
    k = max(1, int(round(sv_perc * mn)))
    p = max(1, int(round(p_perc * mn)))
    return randomized_svd(res, A, k, p, n_iters, generator)
