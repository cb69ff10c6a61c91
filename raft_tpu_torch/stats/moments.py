"""Statistical moments of the port.

Counterpart of ``raft_tpu/stats/moments.py`` (ref: cpp/include/raft/
stats/ — mean, mean_center, stddev, vars, meanvar, sum, weighted_mean,
cov, minmax). Reductions run over rows by default (one statistic per
column), on the data's device (or the handle's), in f32, or f64 for f64
data; ``sample`` selects the n − 1 normalizer.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import float_operands, input_device


def _data(res, data, *more):
    """``data`` (and ``more``, None passing through) on the call's device
    as float tensors."""
    return float_operands(input_device(res, data), data, *more)


def sum_stat(res, data, along_rows: bool = True):
    """(ref: stats/sum.cuh ``sum``)"""
    (data,) = _data(res, data)
    return data.sum(0 if along_rows else 1)


def mean(res, data, sample: bool = False):
    """Column means. (ref: stats/mean.cuh; ``sample`` divides by n − 1)"""
    (data,) = _data(res, data)
    n = data.shape[0]
    return data.sum(0) / ((n - 1) if sample else n)


def mean_center(res, data, mu=None):
    """(ref: stats/mean_center.cuh ``meanCenter``)"""
    data, mu = _data(res, data, mu)
    return data - (data.mean(0) if mu is None else mu)[None, :]


def mean_add(res, data, mu):
    """(ref: stats/mean_center.cuh ``meanAdd``)"""
    data, mu = _data(res, data, mu)
    return data + mu[None, :]


def vars_(res, data, mu=None, sample: bool = False):
    """Column variances. (ref: stats/vars.cuh ``vars``)"""
    data, mu = _data(res, data, mu)
    if mu is None:
        mu = data.mean(0)
    n = data.shape[0]
    return ((data - mu[None, :]) ** 2).sum(0) / ((n - 1) if sample else n)


def stddev(res, data, mu=None, sample: bool = False):
    """(ref: stats/stddev.cuh)"""
    return vars_(res, data, mu, sample).sqrt()


def meanvar(res, data, sample: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance. (ref: stats/meanvar.cuh)"""
    (data,) = _data(res, data)
    mu = data.mean(0)
    return mu, vars_(res, data, mu, sample)


def weighted_mean(res, data, weights, along_rows: bool = True):
    """Weighted mean: over rows (one value per column, weights sized
    n_rows) or over columns. (ref: stats/weighted_mean.cuh
    ``rowWeightedMean``/``colWeightedMean``)"""
    data, w = _data(res, data, weights)
    if along_rows:
        expects(w.shape[0] == data.shape[0], "weighted_mean: weight length")
        return (w[:, None] * data).sum(0) / w.sum()
    expects(w.shape[0] == data.shape[1], "weighted_mean: weight length")
    return (data * w[None, :]).sum(1) / w.sum()


def cov(res, data, mu=None, sample: bool = True, stable: bool = False):
    """Covariance of rows as observations, by a product (ref:
    stats/cov.cuh); ``stable`` centers the data before the product."""
    data, mu = _data(res, data, mu)
    n = data.shape[0]
    if mu is None:
        mu = data.mean(0)
    denom = (n - 1) if sample else n
    if stable:
        c = data - mu[None, :]
        return (c.T @ c) / denom
    return (data.T @ data - n * torch.outer(mu, mu)) / denom


def minmax(res, data) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column (min, max). (ref: stats/minmax.cuh)"""
    (data,) = _data(res, data)
    return data.amin(0), data.amax(0)
