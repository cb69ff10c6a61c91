"""Pairwise distances of the port, all 19 metrics.

Counterpart of ``raft_tpu/distance/pairwise.py`` (ref: the pre-cuVS
``raft::distance::pairwise_distance``). The expanded metrics (L2 and
squared L2, inner product, cosine, correlation, Hellinger, Russell–Rao,
Jaccard, Dice) are a product ``x·yᵀ`` plus per-row corrections: a plain
large product, which goes to ``torch.matmul`` as the reference leaves it
to XLA, in true f32 (TF32 is off for the whole port, ``core.resources``),
or f64 for f64 inputs. The ten unexpanded metrics have no product form
and run through K8 (``ops.unexpanded``): on the card every call launches
the kernel, whatever its size (the reference's size rule priced a TPU
dispatch), and on the CPU its twin.

Dtypes: f64 when an input is f64, f32 for every other input type. The
reference takes its expanded products in f32 even for f64 inputs (and
returns f32 for inner product, Hellinger, Russell–Rao, Jaccard and Dice);
the port keeps f64 throughout.
"""

from __future__ import annotations

from typing import Union

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import (DeviceResources, float_operands,
                                           input_device)
from raft_tpu_torch.distance.types import METRIC_NAMES, DistanceType
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point


def _as_type(metric: Union[str, DistanceType]) -> DistanceType:
    if isinstance(metric, DistanceType):
        return metric
    expects(metric in METRIC_NAMES, "unknown metric %r", metric)
    return METRIC_NAMES[metric]


def _cosine(x, y):
    xn = (x * x).sum(1).sqrt()[:, None]
    yn = (y * y).sum(1).sqrt()[None, :]
    return 1.0 - (x @ y.T) / (xn * yn).clamp_min(1e-30)


def _expanded(x, y, t: DistanceType):
    if t in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        xx = (x * x).sum(1)[:, None]
        yy = (y * y).sum(1)[None, :]
        d2 = (xx + yy - 2.0 * (x @ y.T)).clamp_min(0.0)
        return d2.sqrt() if t == DistanceType.L2SqrtExpanded else d2
    if t == DistanceType.InnerProduct:
        return x @ y.T
    if t == DistanceType.CosineExpanded:
        return _cosine(x, y)
    if t == DistanceType.CorrelationExpanded:
        return _cosine(x - x.mean(1, keepdim=True),
                       y - y.mean(1, keepdim=True))
    if t == DistanceType.HellingerExpanded:
        ip = x.abs().sqrt() @ y.abs().sqrt().T
        return (1.0 - ip.clamp_max(1.0)).clamp_min(0.0).sqrt()
    xb, yb = (x != 0).to(x.dtype), (y != 0).to(y.dtype)
    inter = xb @ yb.T
    if t == DistanceType.RussellRaoExpanded:
        d = x.shape[1]
        return (d - inter) / d
    nx, ny = xb.sum(1)[:, None], yb.sum(1)[None, :]
    if t == DistanceType.JaccardExpanded:
        return 1.0 - inter / (nx + ny - inter).clamp_min(1e-30)
    return 1.0 - 2.0 * inter / (nx + ny).clamp_min(1e-30)       # Dice


@instrument("distance.pairwise_distance")
def pairwise_distance(res, x, y=None,
                      metric: Union[str, DistanceType] = "euclidean",
                      p: float = 2.0, precision=None,
                      assume_finite: bool = False, batched: bool = None,
                      device=None) -> torch.Tensor:
    """Full [n, m] distance matrix between the rows of x [n, d] and y
    [m, d] (y defaults to x); ``metric`` is a :class:`DistanceType` or a
    name of :data:`METRIC_NAMES`, ``p`` the Minkowski exponent.

    Device: ``device`` when given, else the tensors', else ``res``'s (the
    default handle's, on cuda, when ``res`` is None). ``res`` also sets
    the workspace of the unexpanded metrics' CPU twin.

    ``precision``, ``assume_finite`` and ``batched`` are accepted for the
    reference's signature and change nothing here: products run in full
    f32 (the reference's ``HIGHEST``) or f64, and K8 reads x and y
    directly, so non-finite inputs follow IEEE in the kernel as in the
    twin without the reference's finiteness guard.
    """
    fault_point("pairwise_distance")
    dev = input_device(res, x, y, device=device)
    x, y = float_operands(dev, x, y)
    y = x if y is None else y
    expects(x.ndim == 2 and y.ndim == 2 and x.shape[1] == y.shape[1],
            "pairwise_distance: inputs must be [n,d],[m,d]")
    # ops imports the distance package, so K8 is looked up here
    from raft_tpu_torch.ops import unexpanded as k8

    t = _as_type(metric)
    if t not in k8.SUPPORTED:
        return _expanded(x, y, t)
    workspace = res.allocation_limit if isinstance(res, DeviceResources) \
        else 1 << 30
    return k8.unexpanded_pairwise_tiled(x, y, t, float(p), workspace)
