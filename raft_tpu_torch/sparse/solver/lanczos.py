"""Thick-restart Lanczos eigensolver of the port.

(Counterpart of ``raft_tpu/sparse/solver/lanczos.py``; ref: cpp/include/
raft/sparse/solver/lanczos.cuh:35,60,87 and sparse/solver/detail/
lanczos.cuh: ``lanczos_smallest:402`` thick-restart loop, ``lanczos_aux:
248`` Krylov tridiagonalization, ``lanczos_solve_ritz:129``.)

The reference's algorithm, step for step: the (ncv+1)×n basis stays on the
device, every step orthogonalizes fully against the basis so far in two
Gram–Schmidt passes (two dense matrix-vector products each), the projected
ncv×ncv matrix is filled as a full Rayleigh–Ritz matrix and solved with
``torch.linalg.eigh``; a thick restart keeps the wanted Ritz vectors (for
SM also an extremal deflation buffer, ``_restart_select``) and the residual
direction. The matvec is ``sparse.linalg.spmv`` (K6a on a ``TiledELL``,
K6b on a ``TiledPairsSpmv``) or ``A @ x`` for a dense operand (BASELINE
config 3).

One control flow for both of the reference's. Each restart cycle is
followed by one host read of the Ritz residuals; the solve stops when every
wanted residual is within the tolerance or ``max_iterations`` Krylov steps
were taken. ``jit_loop`` keeps the reference's meaning as far as torch can
(it has no compiled loop): off, the loop also stops early when the residual
stagnates for 50 cycles (the reference's host loop, ``lanczos.py:244-291``);
on, it does not (its compiled loop, ``:145-178``).
"""

from __future__ import annotations

import logging
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import resolve_device
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix, to_device
from raft_tpu_torch.sparse.solver.lanczos_types import (LANCZOS_WHICH,
                                                        LanczosSolverConfig)
from raft_tpu_torch.sparse.tiled import TiledELL, TiledPairsSpmv

_log = logging.getLogger(__name__)


def _matvec(A, x):
    from raft_tpu_torch.sparse.sharded import ShardedTiledELL

    if isinstance(A, (COOMatrix, CSRMatrix, TiledELL, TiledPairsSpmv,
                      ShardedTiledELL)):
        from raft_tpu_torch.sparse.linalg import spmv

        return spmv(None, A, x)
    if isinstance(A, torch.Tensor):
        return A @ x
    return A.mv(x)


def _restart_cycle(A, V, T0, j0: int, ncv: int):
    """Build Krylov columns j0..ncv-1 with two-pass full
    reorthogonalization, then Rayleigh–Ritz. Returns (theta, S, V,
    beta_last); V[ncv] is the normalized residual vector. Updates V in
    place."""
    T = T0.clone()
    beta = torch.zeros((), dtype=V.dtype, device=V.device)
    for j in range(j0, ncv):
        Vm = V[:j + 1]
        w = _matvec(A, V[j])
        h = Vm @ w
        w = w - Vm.T @ h
        h2 = Vm @ w                  # second Gram–Schmidt pass (stability)
        w = w - Vm.T @ h2
        h = h + h2
        beta = torch.linalg.vector_norm(w)
        safe = torch.where(beta > 0, beta, torch.ones_like(beta))
        T[:j + 1, j] = h
        T[j, :j + 1] = h
        V[j + 1] = w / safe
        if j + 1 < ncv:
            T[j + 1, j] = beta
            T[j, j + 1] = beta
    theta, S = torch.linalg.eigh((T + T.T) / 2)
    return theta, S, V, beta


def _select(theta, which: LANCZOS_WHICH, k: int):
    """Positions (ascending) of the k wanted Ritz values."""
    dev = theta.device
    if which == LANCZOS_WHICH.SA:
        return torch.arange(k, device=dev)
    if which == LANCZOS_WHICH.LA:
        return torch.arange(theta.shape[0] - k, theta.shape[0], device=dev)
    key = -theta.abs() if which == LANCZOS_WHICH.LM else theta.abs()
    return torch.sort(torch.argsort(key, stable=True)[:k]).values


def _restart_select(theta, which: LANCZOS_WHICH, k: int, ncv: int):
    """(positions to keep across a thick restart, their count). SM also
    keeps an extremal deflation buffer of the nb largest-|θ| Ritz vectors
    (the reference's ``_restart_select``, ``lanczos.py:100-118``: without
    it the interior restart stalls on its tier-1 fixture)."""
    if which != LANCZOS_WHICH.SM:
        return _select(theta, which, k), k
    nb = max(0, min(2 * k + 4, ncv - k - 2))
    sm = torch.argsort(theta.abs(), stable=True)[:k]
    lm = torch.argsort(-theta.abs(), stable=True)[:nb]
    return torch.sort(torch.cat([sm, lm])).values, k + nb


def _residual_estimate(theta, S, beta_last, idx, ncv: int):
    """Ritz residual bound |β·S[ncv−1, i]| and the spectrum's scale."""
    resid = (beta_last * S[ncv - 1, idx]).abs()
    scale = torch.clamp_min(theta.abs().max(), 1e-30)
    return resid, scale


def _restart_state(theta, S, V, idx, k: int, ncv: int):
    """Thick restart: wanted Ritz vectors + residual direction, and the
    projected T."""
    V2 = torch.zeros_like(V)
    V2[:k] = S[:, idx].T @ V[:ncv]
    V2[k] = V[ncv]
    T0 = torch.zeros((ncv, ncv), dtype=V.dtype, device=V.device)
    ar = torch.arange(k, device=V.device)
    T0[ar, ar] = theta[idx]
    return V2, T0


def _extract_eigvecs(S, V, idx, ncv: int):
    eigvecs = (S[:, idx].T @ V[:ncv]).T
    return eigvecs / torch.linalg.vector_norm(eigvecs, dim=0, keepdim=True)


def _operand(res, A):
    """(A on its device, n, dtype, device). The device is the handle's
    when one is given, else the operand's, else cuda."""
    from raft_tpu_torch.sparse.sharded import ShardedTiledELL

    hint = res.device if res is not None else None
    if isinstance(A, (COOMatrix, CSRMatrix)):
        A = to_device(A, hint)
        return A, A.shape[0], A.values.dtype, A.values.device
    if isinstance(A, (TiledELL, TiledPairsSpmv, ShardedTiledELL)):
        return A, A.shape[0], A.vals.dtype, A.device
    if not isinstance(A, torch.Tensor) and callable(getattr(A, "mv", None)):
        return A, A.shape[0], A.dtype, A.device       # an operator wrapper
    dev = resolve_device(hint, A)
    if isinstance(A, torch.Tensor):
        A = A.to(dev)
    else:
        A = torch.from_numpy(np.ascontiguousarray(np.asarray(A))).to(dev)
    if A.dtype not in (torch.float32, torch.float64):
        A = A.to(torch.float32)
    return A, A.shape[0], A.dtype, dev


def lanczos_compute_eigenpairs(res, A, config: LanczosSolverConfig,
                               v0=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``config.n_components`` eigenpairs of symmetric A: (eigenvalues [k]
    ascending, eigenvectors [n, k]). (ref: sparse/solver/lanczos.cuh:35.)

    ``A``: COO/CSR, a prepared ``TiledELL`` / ``TiledPairsSpmv``, a dense
    matrix, or an operator with ``shape``, ``dtype``, ``device`` and
    ``mv(x)`` (the ``spectral`` matrix wrappers, as the reference's C++
    solver takes them). It runs on the handle's device when ``res`` is given,
    else on the operand's, else on cuda. ``v0`` defaults to a normal draw
    from a ``torch.Generator`` seeded with ``config.seed`` (not the
    reference's threefry numbers: parity tests pass ``v0``)."""
    A, n, dtype, dev = _operand(res, A)
    k = config.n_components
    expects(0 < k < n, "lanczos: need 0 < n_components < n")
    ncv = config.ncv if config.ncv is not None else min(n, max(2 * k + 1,
                                                               20))
    ncv = min(max(ncv, k + 2), n)
    if v0 is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(config.seed)
        v0 = torch.randn(n, generator=gen, device=dev, dtype=dtype)
    if not isinstance(v0, torch.Tensor):
        v0 = torch.from_numpy(np.array(v0))
    v0 = v0.to(device=dev, dtype=dtype)
    V = torch.zeros((ncv + 1, n), dtype=dtype, device=dev)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    T0 = torch.zeros((ncv, ncv), dtype=dtype, device=dev)

    jit_loop = config.jit_loop
    if jit_loop is None:
        jit_loop = dev.type == "cuda"

    j0 = 0
    n_steps = 0
    best_resid = None
    stagnant = 0
    while True:
        theta, S, V, beta_last = _restart_cycle(A, V, T0, j0, ncv)
        n_steps += ncv - j0
        idx = _select(theta, config.which, k)
        resid, scale = _residual_estimate(theta, S, beta_last, idx, ncv)
        max_resid = float(resid.max())
        if bool((resid <= config.tolerance * scale).all()):
            break
        if n_steps >= config.max_iterations:
            _log.warning("lanczos: max_iterations=%d reached with relative "
                         "residual %.3e > tolerance %.3e",
                         config.max_iterations, max_resid / float(scale),
                         config.tolerance)
            break
        # the host loop stops on a true flatline only: 50 cycles without
        # 0.1% improvement
        if best_resid is None or max_resid < 0.999 * best_resid:
            best_resid = max_resid if best_resid is None else min(
                best_resid, max_resid)
            stagnant = 0
        else:
            stagnant += 1
            if stagnant >= 50 and not jit_loop:
                _log.warning(
                    "lanczos: residual stagnated at %.3e (relative %.3e > "
                    "tolerance %.3e) — fp32 floor reached, returning best "
                    "available eigenpairs", max_resid,
                    max_resid / float(scale), config.tolerance)
                break
        ridx, k_r = _restart_select(theta, config.which, k, ncv)
        V, T0 = _restart_state(theta, S, V, ridx, k_r, ncv)
        j0 = k_r
    return theta[idx], _extract_eigvecs(S, V, idx, ncv)
