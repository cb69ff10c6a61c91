"""Randomized SVD of a sparse matrix, in the port (counterpart of
``raft_tpu/sparse/solver/randomized_svds.py``; ref: cpp/include/raft/
sparse/solver/randomized_svds.cuh, config svds_config.hpp, impl
detail/randomized_svds.cuh: Gaussian sketch, cholesky_qr2, power
iterations, one small SVD, sign correction from
detail/svds_sign_correction.cuh).

The products go through :func:`raft_tpu_torch.sparse.linalg.spmm` (the
segment-sum product over COO/CSR, as the reference's). The sketch is drawn
from a ``torch.Generator`` seeded with ``config.seed``;
:func:`_svds_from_sketch` is the rest, given the sketch. A row-sharded
operand (``sparse.sharded.ShardedTiledELL``) runs every product as K6c
on its row blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import input_device
from raft_tpu_torch.core.sparse_types import (COOMatrix, CSRMatrix,
                                              sparse_arrays, to_device)
from raft_tpu_torch.sparse.linalg import spmm, transpose as sp_transpose
from raft_tpu_torch.sparse.solver.cholesky_qr import cholesky_qr2

Sparse = Union[COOMatrix, CSRMatrix]


@dataclasses.dataclass
class SvdsConfig:
    """(ref: sparse/solver/svds_config.hpp)"""

    n_components: int
    n_oversamples: int = 10
    n_power_iters: int = 2
    seed: int = 42


def sign_correction(U, V):
    """Each left singular vector's largest-magnitude entry (the first of
    equal ones) made positive, V's column flipped along; a zero pivot
    keeps its sign. (ref: detail/svds_sign_correction.cuh)"""
    pivot = torch.gather(U, 0, torch.argmax(U.abs(), dim=0)[None, :])
    signs = torch.sign(torch.where(pivot == 0, torch.ones_like(pivot),
                                   pivot))
    return U * signs, V * signs


def _svds_from_sketch(res, A: CSRMatrix, At: CSRMatrix, omega, k: int,
                      n_power_iters: int):
    """Everything after the sketch ``omega`` [n, ℓ]: (U [m, k], S [k],
    V [n, k]), sign-corrected."""
    Q, _ = cholesky_qr2(spmm(res, A, omega))           # m × ℓ
    for _ in range(n_power_iters):                     # subspace iteration
        Z, _ = cholesky_qr2(spmm(res, At, Q))          # n × ℓ
        Q, _ = cholesky_qr2(spmm(res, A, Z))           # m × ℓ
    B = spmm(res, At, Q).T                             # ℓ × n (= Qᵀ A)
    Ub, S, Vt = torch.linalg.svd(B, full_matrices=False)
    U, V = sign_correction((Q @ Ub)[:, :k], Vt.T[:, :k])
    return U, S[:k], V


def randomized_svds(res, A: Sparse, config: SvdsConfig, At=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Truncated SVD of a sparse COO/CSR matrix: (U [m, k], S [k]
    descending, V [n, k]). ``At`` is A's [n, m] transpose, made with
    :func:`~raft_tpu_torch.sparse.linalg.transpose` when not given. Runs
    on A's device, or the handle's when A holds no tensor. (ref:
    sparse/solver/randomized_svds.cuh)

    ``A`` may be a ``ShardedTiledELL`` (reference ``:52``): ``At`` must
    then be the transposed matrix's sharded operand
    (``shard_spmv_operand(transpose(A), mesh)``; a sharded layout has no
    cheap transpose), and every product is K6c over the row blocks."""
    from raft_tpu_torch.sparse.sharded import ShardedTiledELL

    expects(isinstance(A, (COOMatrix, CSRMatrix, ShardedTiledELL)),
            "randomized_svds: A must be a COO, CSR or sharded tiled "
            "matrix")
    k = config.n_components
    m, n = A.shape
    expects(0 < k <= min(m, n), "randomized_svds: bad n_components")
    ell = min(k + config.n_oversamples, min(m, n))
    if isinstance(A, ShardedTiledELL):
        expects(isinstance(At, ShardedTiledELL)
                and tuple(At.shape) == (n, m),
                "randomized_svds: a sharded operand needs At, the [n, m] "
                "sharded transpose (shard_spmv_operand of the transposed "
                "matrix)")
        dtype, dev = A.vals.dtype, A.device
    else:
        A = to_device(A, input_device(res, *sparse_arrays(A)))
        if isinstance(A, COOMatrix):
            from raft_tpu_torch.sparse.convert import coo_to_csr

            A = coo_to_csr(A)
        if At is None:
            At = sp_transpose(res, A)
        else:
            # a wrong-shaped At would index out of range or answer garbage
            expects(tuple(At.shape) == (n, m),
                    "randomized_svds: At must be [n, m], got %r",
                    tuple(At.shape))
        dtype, dev = A.values.dtype, A.values.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)
    omega = torch.randn((n, ell), generator=gen, dtype=dtype, device=dev)
    return _svds_from_sketch(res, A, At, omega, k, config.n_power_iters)
