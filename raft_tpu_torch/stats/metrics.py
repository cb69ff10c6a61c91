"""Classification and regression metrics of the port.

Counterpart of ``raft_tpu/stats/metrics.py`` (ref: cpp/include/raft/
stats/ — accuracy.cuh, r2_score.cuh, regression_metrics.cuh,
mean_squared_error.cuh). Sums run on the inputs' device in f32 (f64 for
f64 inputs); the scalars come back as Python floats.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from raft_tpu_torch.core.resources import float_operands, input_device
# one definition, the reference's re-export (raft_tpu/stats/metrics.py:13)
from raft_tpu_torch.linalg.reduce import mean_squared_error  # noqa: F401


def _pair(res, a, b):
    return float_operands(input_device(res, a, b), a, b)


def accuracy(res, predictions, ref_predictions) -> float:
    """Fraction of exact matches. (ref: stats/accuracy.cuh
    ``accuracy_score``)"""
    p, r = _pair(res, predictions, ref_predictions)
    return float((p == r).to(p.dtype).mean())


def r2_score(res, y, y_hat) -> float:
    """(ref: stats/r2_score.cuh)"""
    y, y_hat = _pair(res, y, y_hat)
    ss_res = ((y - y_hat) ** 2).sum()
    ss_tot = ((y - y.mean()) ** 2).sum()
    return float(1.0 - ss_res / ss_tot)


class RegressionMetrics(NamedTuple):
    """(ref: stats/regression_metrics.cuh out params)"""

    mean_abs_error: float
    mean_squared_error: float
    median_abs_error: float


def _median(v: torch.Tensor):
    """The median of a 1-D tensor, averaging the middle pair of an even
    count (``jnp.median``'s convention; ``torch.median`` takes the lower
    one)."""
    s = v.sort().values
    h = s.numel() // 2
    return s[h] if s.numel() % 2 else 0.5 * (s[h - 1] + s[h])


def regression_metrics(res, predictions, ref_predictions
                       ) -> RegressionMetrics:
    """(ref: stats/regression_metrics.cuh ``regression_metrics``)"""
    p, r = _pair(res, predictions, ref_predictions)
    err = (p - r).reshape(-1)
    return RegressionMetrics(float(err.abs().mean()),
                             float((err * err).mean()),
                             float(_median(err.abs())))
