"""Clustering comparison metrics of the port.

Counterpart of ``raft_tpu/stats/cluster.py`` (ref: cpp/include/raft/
stats/ — contingency_matrix.cuh, rand_index.cuh, adjusted_rand_index.cuh,
entropy.cuh, mutual_info_score.cuh, homogeneity_score.cuh,
completeness_score.cuh, v_measure.cuh, kl_divergence.cuh). Everything is
built from one contingency matrix (``torch.bincount`` of ``a·n_b + b``)
on the labels' device, as the reference builds it; values follow
sklearn's definitions.

Precision: the scalar reductions run in f64. The reference runs them in
f32 (without x64), so it agrees to f32 rounding of sums over n labels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import float_operands, input_device


def _labels(res, *arrays):
    dev = input_device(res, *arrays)
    return tuple(
        (a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.array(a))).to(device=dev, dtype=torch.int64).reshape(-1)
        for a in arrays)


def get_contingency_matrix_shape(res, a, b) -> Tuple[int, int]:
    """(ref: contingency_matrix.cuh companion: the classes are 0..max)"""
    a, b = _labels(res, a, b)
    return int(a.max()) + 1, int(b.max()) + 1


def contingency_matrix(res, a, b, n_classes_a: Optional[int] = None,
                       n_classes_b: Optional[int] = None):
    """counts[i, j] = |{k : a[k] = i ∧ b[k] = j}|, int64.
    (ref: stats/contingency_matrix.cuh ``contingency_matrix``)"""
    a, b = _labels(res, a, b)
    if n_classes_a is None or n_classes_b is None:
        ca, cb = int(a.max()) + 1, int(b.max()) + 1
        n_classes_a = n_classes_a or ca
        n_classes_b = n_classes_b or cb
    counts = torch.bincount(a * n_classes_b + b,
                            minlength=n_classes_a * n_classes_b)
    return counts.reshape(n_classes_a, n_classes_b)


def _comb2(x):
    return x * (x - 1) / 2.0


def _cm(res, a, b):
    return contingency_matrix(res, a, b).to(torch.float64)


def rand_index(res, a, b) -> float:
    """(ref: stats/rand_index.cuh ``rand_index``)"""
    cm = _cm(res, a, b)
    n = cm.sum()
    agree = _comb2(n) + (cm * cm).sum() - 0.5 * (
        (cm.sum(1) ** 2).sum() + (cm.sum(0) ** 2).sum())
    return float(agree / _comb2(n))


def adjusted_rand_index(res, a, b) -> float:
    """(ref: stats/adjusted_rand_index.cuh)"""
    cm = _cm(res, a, b)
    n = cm.sum()
    sum_comb = _comb2(cm).sum()
    comb_a = _comb2(cm.sum(1)).sum()
    comb_b = _comb2(cm.sum(0)).sum()
    expected = comb_a * comb_b / _comb2(n)
    denom = 0.5 * (comb_a + comb_b) - expected
    if float(denom) == 0.0:
        return 1.0
    return float((sum_comb - expected) / denom)


def entropy(res, labels, n_classes: Optional[int] = None) -> float:
    """Shannon entropy of a labeling, in nats. (ref: stats/entropy.cuh)"""
    (labels,) = _labels(res, labels)
    if n_classes is None:
        n_classes = int(labels.max()) + 1
    counts = torch.bincount(labels, minlength=n_classes).to(torch.float64)
    p = counts / counts.sum()
    return float(-torch.where(p > 0, p * p.log(), 0.0).sum())


def mutual_info_score(res, a, b) -> float:
    """(ref: stats/mutual_info_score.cuh)"""
    cm = _cm(res, a, b)
    pij = cm / cm.sum()
    outer = pij.sum(1, keepdim=True) * pij.sum(0, keepdim=True)
    ratio = torch.where(pij > 0, pij / outer, 1.0)
    return float(torch.where(pij > 0, pij * ratio.log(), 0.0).sum())


def homogeneity_score(res, truth, pred) -> float:
    """(ref: stats/homogeneity_score.cuh) MI / H(C) = 1 − H(C|K)/H(C)."""
    h_c = entropy(res, truth)
    if h_c == 0.0:
        return 1.0
    return mutual_info_score(res, truth, pred) / h_c


def completeness_score(res, truth, pred) -> float:
    """(ref: stats/completeness_score.cuh) MI / H(K)."""
    h_k = entropy(res, pred)
    if h_k == 0.0:
        return 1.0
    return mutual_info_score(res, truth, pred) / h_k


def v_measure(res, truth, pred, beta: float = 1.0) -> float:
    """(ref: stats/v_measure.cuh)"""
    h = homogeneity_score(res, truth, pred)
    c = completeness_score(res, truth, pred)
    if h + c == 0.0:
        return 0.0
    return (1 + beta) * h * c / (beta * h + c)


def kl_divergence(res, p, q) -> float:
    """Σ p·log(p/q) over two distributions. (ref: stats/kl_divergence.cuh)"""
    p, q = float_operands(input_device(res, p, q), p, q)
    p, q = p.to(torch.float64), q.to(torch.float64)
    ratio = torch.where((p > 0) & (q > 0), p / torch.where(q > 0, q, 1.0),
                        1.0)
    return float(torch.where(p > 0, p * ratio.log(), 0.0).sum())
