"""PCA of the port (counterpart of ``raft_tpu/linalg/pca.py``; ref:
cpp/include/raft/linalg/pca.cuh:41 ``pca_fit`` / ``pca_transform`` /
``pca_inverse_transform``, params linalg/pca_types.hpp:21-34; the
pipeline of linalg/detail/pca.cuh: center, covariance, eigDC or
eigJacobi, descending order, sign flip, variance bookkeeping).

The multi-device fit (``pca_fit_distributed``, ``pad_mask_shard``) waits
for ROADMAP item 7 and raises.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch

from raft_tpu_torch.core.error import expects, not_ported
from raft_tpu_torch.core.resources import float_operands, input_device
from raft_tpu_torch.linalg.eig import eig_dc, eig_jacobi
from raft_tpu_torch.matrix.math_ops import sign_flip


class Solver(enum.Enum):
    """(ref: pca_types.hpp ``solver``)"""

    COV_EIG_DC = "cov_eig_dc"
    COV_EIG_JACOBI = "cov_eig_jacobi"


@dataclasses.dataclass
class ParamsPCA:
    """(ref: pca_types.hpp:34 ``paramsPCA``)"""

    n_components: int
    whiten: bool = False
    algorithm: Solver = Solver.COV_EIG_DC
    tol: float = 1e-7          # Jacobi tolerance (unused, as in the reference)
    n_iterations: int = 15     # Jacobi sweeps


class PCAModel(NamedTuple):
    """What :func:`pca_fit` returns."""

    components: torch.Tensor           # [n_components, n_features]
    explained_var: torch.Tensor        # [n_components]
    explained_var_ratio: torch.Tensor
    singular_vals: torch.Tensor
    mu: torch.Tensor                   # [n_features]
    noise_vars: torch.Tensor           # scalar


def eig_descending(res, G, algorithm: Solver, tol: float, sweeps: int):
    """G's eigenpairs by ``algorithm``, descending, with the values clamped
    at 0 and the vectors sign-flipped as columns."""
    if algorithm == Solver.COV_EIG_JACOBI:
        w, v = eig_jacobi(res, G, tol=tol, sweeps=sweeps)
    else:
        w, v = eig_dc(res, G)
    return w.flip(0).clamp_min(0.0), sign_flip(res, v.flip(1))


def _model_from_cov(res, cov, mu, n: int, p: int,
                    prms: ParamsPCA) -> PCAModel:
    k = prms.n_components
    w, v = eig_descending(res, cov, prms.algorithm, prms.tol,
                          prms.n_iterations)
    components = v.T[:k]
    explained_var = w[:k]
    explained_var_ratio = explained_var / w.sum()
    singular_vals = torch.sqrt(explained_var * (n - 1))
    noise_vars = (w[k:].sum() / max(p - k, 1) if k < p
                  else w.new_zeros(()))
    return PCAModel(components, explained_var, explained_var_ratio,
                    singular_vals, mu, noise_vars)


def pca_fit(res, X, prms: ParamsPCA) -> PCAModel:
    """(ref: pca.cuh:41 ``pca_fit``)"""
    X, = float_operands(input_device(res, X), X)
    n, p = X.shape
    expects(0 < prms.n_components <= p, "pca_fit: bad n_components")
    mu = X.mean(0)
    Xc = X - mu[None, :]
    cov = (Xc.T @ Xc) / (n - 1)
    return _model_from_cov(res, cov, mu, n, p, prms)


def pad_mask_shard(X, mesh, axis: str = "x"):
    """The distributed fits' row sharding: not in the port yet."""
    not_ported("pad_mask_shard")


def pca_fit_distributed(res, X, prms: ParamsPCA, mesh,
                        axis: str = "x") -> PCAModel:
    """The rows-sharded fit: not in the port yet."""
    not_ported("pca_fit_distributed")


def _whiten_scale(model: PCAModel):
    return torch.sqrt(model.explained_var.clamp_min(1e-12))


def pca_transform(res, X, model: PCAModel, prms: ParamsPCA):
    """(ref: pca.cuh ``pca_transform``)"""
    X, = float_operands(model.mu.device, X)
    t = (X - model.mu[None, :]) @ model.components.T
    if prms.whiten:
        t = t / _whiten_scale(model)[None, :]
    return t


def pca_inverse_transform(res, T, model: PCAModel, prms: ParamsPCA):
    """(ref: pca.cuh ``pca_inverse_transform``)"""
    T, = float_operands(model.mu.device, T)
    if prms.whiten:
        T = T * _whiten_scale(model)[None, :]
    return T @ model.components + model.mu[None, :]
