"""Multivariate Gaussian sampling of the port (counterpart of
``raft_tpu/random/multi_variable_gaussian.py``; ref: cpp/include/raft/
random/multi_variable_gaussian.cuh): x = mu + L·z with Σ = L·Lᵀ from a
Cholesky factorization, or from the port's Jacobi eigensolver
(``linalg.eig_jacobi``: Σ = V·diag(w)·Vᵀ, w clamped at 0) for a Σ that
is not positive definite."""

from __future__ import annotations

import enum

import torch

from raft_tpu_torch.core.resources import as_tensors
from raft_tpu_torch.random.rng_state import as_generator, target_device


class DecompositionMethod(enum.Enum):
    """(ref: multi_variable_gaussian.cuh
    ``multi_variable_gaussian_decomposition_method``)"""

    CHOLESKY = "cholesky"
    JACOBI = "eig"


def multi_variable_gaussian(res, state, n_samples: int, mu, cov,
                            method: DecompositionMethod =
                            DecompositionMethod.CHOLESKY,
                            dtype=torch.float32, device=None):
    """Samples [n_samples, dim] of N(mu, cov).
    (ref: multi_variable_gaussian.cuh)"""
    from raft_tpu_torch.linalg.eig import eig_jacobi

    dev = target_device(res, device, state)
    mu, cov = as_tensors(None, mu, cov, device=dev)
    mu, cov = mu.to(dtype), cov.to(dtype)
    z = torch.randn((int(n_samples), mu.shape[0]),
                    generator=as_generator(state, res, dev), device=dev,
                    dtype=dtype)
    if method == DecompositionMethod.CHOLESKY:
        factor = torch.linalg.cholesky(cov)
    else:
        w, v = eig_jacobi(res, cov)
        factor = v * torch.sqrt(w.clamp_min(0.0))[None, :]
    return mu[None, :] + z @ factor.T
