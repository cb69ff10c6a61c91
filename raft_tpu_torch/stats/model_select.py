"""Dispersion and information criteria of the port.

Counterpart of ``raft_tpu/stats/model_select.py`` (ref: cpp/include/raft/
stats/dispersion.cuh, information_criterion.cuh).
"""

from __future__ import annotations

import enum
import math
from typing import Optional

from raft_tpu_torch.core.resources import float_operands, input_device


def dispersion(res, centroids, cluster_sizes, global_centroid=None,
               n_points: Optional[int] = None) -> float:
    """sqrt(Σ_k n_k·‖μ_k − μ‖²), the between-group dispersion (e.g. of
    the gap statistic). (ref: stats/dispersion.cuh ``dispersion``)"""
    c, sizes, g = float_operands(input_device(res, centroids), centroids,
                                 cluster_sizes, global_centroid)
    sizes = sizes.to(c.dtype)
    if n_points is None:
        n_points = float(sizes.sum())
    if g is None:
        g = (sizes[:, None] * c).sum(0) / n_points
    dev = c - g[None, :]
    return float((sizes * (dev * dev).sum(1)).sum().sqrt())


class IC_Type(enum.Enum):
    """(ref: stats/information_criterion.cuh ``IC_Type``)"""

    AIC = "aic"
    AICc = "aicc"
    BIC = "bic"


def information_criterion_batched(res, loglikelihood, ic_type: IC_Type,
                                  n_params: int, batch_size: int,
                                  n_samples: int):
    """Batched AIC / AICc / BIC of log-likelihoods [batch_size].
    (ref: stats/information_criterion.cuh
    ``information_criterion_batched``)"""
    (ll,) = float_operands(input_device(res, loglikelihood), loglikelihood)
    p, n = float(n_params), float(n_samples)
    base = -2.0 * ll
    if ic_type == IC_Type.AIC:
        return base + 2.0 * p
    if ic_type == IC_Type.AICc:
        return base + 2.0 * p + 2.0 * p * (p + 1.0) / max(n - p - 1.0,
                                                          1e-30)
    return base + p * math.log(n)
