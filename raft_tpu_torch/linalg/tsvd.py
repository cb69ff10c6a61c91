"""Truncated SVD of the port (counterpart of ``raft_tpu/linalg/tsvd.py``;
ref: cpp/include/raft/linalg/tsvd.cuh ``tsvd_fit`` / ``tsvd_transform`` /
``tsvd_inverse_transform``, params pca_types.hpp ``paramsTSVD``; PCA's
pipeline without centering: the eigenpairs of XᵀX).

The multi-device fit (``tsvd_fit_distributed``, reference ``:70``): the
Gram matrix and column sums meet in allreduces over the row blocks, then a
centred variance pass.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device
from raft_tpu_torch.linalg.pca import Solver, eig_descending, row_blocks


@dataclasses.dataclass
class ParamsTSVD:
    """(ref: pca_types.hpp ``paramsTSVD``)"""

    n_components: int
    algorithm: Solver = Solver.COV_EIG_DC
    tol: float = 1e-7
    n_iterations: int = 15


class TSVDModel(NamedTuple):
    components: torch.Tensor           # [n_components, n_features]
    explained_var: torch.Tensor
    explained_var_ratio: torch.Tensor
    singular_vals: torch.Tensor


def tsvd_fit(res, X, prms: ParamsTSVD) -> TSVDModel:
    """(ref: tsvd.cuh ``tsvd_fit``)"""
    X, = float_operands(input_device(res, X), X)
    n, p = X.shape
    k = prms.n_components
    expects(0 < k <= p, "tsvd_fit: bad n_components")
    w, v = eig_descending(res, X.T @ X, prms.algorithm, prms.tol,
                          prms.n_iterations)
    components = v.T[:k]
    singular_vals = torch.sqrt(w[:k])
    # the projected coordinates' population variance, as the reference
    # computes it from the transform
    explained_var = torch.var(X @ components.T, dim=0, correction=0)
    total_var = torch.var(X, dim=0, correction=0).sum()
    return TSVDModel(components, explained_var, explained_var / total_var,
                     singular_vals)


def tsvd_fit_distributed(res, X, prms: ParamsTSVD, mesh,
                         axis: str = "x") -> TSVDModel:
    """The rows-sharded TSVD fit (reference ``:70``): the Gram matrix and
    column sums of the masked row blocks meet in allreduces, the eig tail
    runs once, and a second pass sums the centred squares of the
    projection and of the rows (the one-pass E[x²] − E[x]² form cancels
    in f32 on data with large means; the single-device fit's ``var`` is
    two-pass too). Population variances, as the single-device fit's."""
    from raft_tpu_torch.comms.comms import reduce_parts
    from raft_tpu_torch.parallel.mesh import for_each_rank

    n, p = X.shape
    k = prms.n_components
    expects(0 < k <= p, "tsvd_fit_distributed: bad n_components")
    line, blocks = row_blocks(X, mesh, axis)
    parts = for_each_rank(line, lambda x, v: (
        (x * v[:, None]).T @ (x * v[:, None]), (x * v[:, None]).sum(0)),
        blocks)
    G = reduce_parts([q[0] for q in parts], axis_name=axis)
    colsum = reduce_parts([q[1] for q in parts], axis_name=axis)
    w, vecs = eig_descending(res, G, prms.algorithm, prms.tol,
                             prms.n_iterations)
    components = vecs.T[:k]
    mu_x = colsum / n
    mu_t = components @ mu_x                  # the mean of X @ compᵀ

    def centred(x, v):
        t = x @ components.to(x.device).T
        return ((((t - mu_t.to(x.device)[None, :]) ** 2)
                 * v[:, None]).sum(0),
                (((x - mu_x.to(x.device)[None, :]) ** 2)
                 * v[:, None]).sum(0))

    parts = for_each_rank(line, centred, blocks)
    s2c = reduce_parts([q[0] for q in parts], axis_name=axis)
    x2c = reduce_parts([q[1] for q in parts], axis_name=axis)
    explained_var = s2c / n
    return TSVDModel(components, explained_var,
                     explained_var / (x2c.sum() / n), torch.sqrt(w[:k]))


def tsvd_transform(res, X, model: TSVDModel):
    """(ref: tsvd.cuh ``tsvd_transform``)"""
    X, = float_operands(model.components.device, X)
    return X @ model.components.T


def tsvd_inverse_transform(res, T, model: TSVDModel):
    """(ref: tsvd.cuh ``tsvd_inverse_transform``)"""
    T, = float_operands(model.components.device, T)
    return T @ model.components
