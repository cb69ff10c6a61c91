"""PCA of the port (counterpart of ``raft_tpu/linalg/pca.py``; ref:
cpp/include/raft/linalg/pca.cuh:41 ``pca_fit`` / ``pca_transform`` /
``pca_inverse_transform``, params linalg/pca_types.hpp:21-34; the
pipeline of linalg/detail/pca.cuh: center, covariance, eigDC or
eigJacobi, descending order, sign flip, variance bookkeeping).

The multi-device fit (``pca_fit_distributed``, reference ``:107``) runs
one rank a row block of ``pad_mask_shard``'s split in turn
(:func:`raft_tpu_torch.parallel.for_each_rank`): the mean and covariance
partials are folded in rank order (the reference's two allreduces), the
eig tail runs once.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import NamedTuple

import torch

from raft_tpu_torch.core.error import expects
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
    """Zero-pad the rows to a multiple of ``mesh[axis]`` and place the
    array and its validity mask (1 on real rows, 0 on pads) row-sharded
    over the mesh (reference ``:88``): the preamble of the distributed
    fits, whose statistics mask the pads out. Returns two
    :class:`~raft_tpu_torch.parallel.ShardedArray`."""
    from raft_tpu_torch.parallel.mesh import shard_array

    X, = float_operands(input_device(None, X, device=mesh.device_list()[0]),
                        X)
    n = X.shape[0]
    npad = (-n) % int(mesh.shape[axis])
    valid = torch.cat([torch.ones(n, dtype=X.dtype, device=X.device),
                       torch.zeros(npad, dtype=X.dtype, device=X.device)])
    if npad:
        X = torch.cat([X, X.new_zeros((npad,) + tuple(X.shape[1:]))])
    return shard_array(X, mesh, axis), shard_array(valid, mesh, axis)


def row_blocks(X, mesh, axis: str = "x"):
    """The 1-d mesh of ``mesh[axis]`` and each of its ranks' (row block,
    mask) of :func:`pad_mask_shard`'s split, for
    :func:`raft_tpu_torch.parallel.for_each_rank`."""
    from raft_tpu_torch.parallel.mesh import line_mesh

    line = line_mesh(mesh, axis)
    Xs, vs = pad_mask_shard(X, line, axis)
    return line, list(zip(Xs.shards, vs.shards))


def pca_fit_distributed(res, X, prms: ParamsPCA, mesh,
                        axis: str = "x") -> PCAModel:
    """The rows-sharded PCA fit (reference ``:107``): each rank sums its
    masked rows; the mean and then the covariance of the centered rows
    are folded in rank order (the reference's allreduces); the eig tail
    runs once on the result."""
    n, p = X.shape
    expects(0 < prms.n_components <= p,
            "pca_fit_distributed: bad n_components")

    from raft_tpu_torch.comms.comms import reduce_parts
    from raft_tpu_torch.parallel.mesh import for_each_rank

    line, blocks = row_blocks(X, mesh, axis)
    mu = reduce_parts(for_each_rank(
        line, lambda x, v: (x * v[:, None]).sum(0), blocks),
        axis_name=axis) / n

    def centred(x, v):
        xc = (x - mu.to(x.device)[None, :]) * v[:, None]
        return xc.T @ xc

    cov = reduce_parts(for_each_rank(line, centred, blocks),
                       axis_name=axis) / (n - 1)
    return _model_from_cov(res, cov, mu, n, p, prms)


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
