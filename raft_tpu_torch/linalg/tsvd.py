"""Truncated SVD of the port (counterpart of ``raft_tpu/linalg/tsvd.py``;
ref: cpp/include/raft/linalg/tsvd.cuh ``tsvd_fit`` / ``tsvd_transform`` /
``tsvd_inverse_transform``, params pca_types.hpp ``paramsTSVD``; PCA's
pipeline without centering: the eigenpairs of XᵀX).

The multi-device fit (``tsvd_fit_distributed``) waits for ROADMAP item 7
and raises.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device
from raft_tpu_torch.linalg.pca import Solver, eig_descending, not_ported


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
    """The rows-sharded fit: not in the port yet."""
    not_ported("tsvd_fit_distributed")


def tsvd_transform(res, X, model: TSVDModel):
    """(ref: tsvd.cuh ``tsvd_transform``)"""
    X, = float_operands(model.components.device, X)
    return X @ model.components.T


def tsvd_inverse_transform(res, T, model: TSVDModel):
    """(ref: tsvd.cuh ``tsvd_inverse_transform``)"""
    T, = float_operands(model.components.device, T)
    return T @ model.components
