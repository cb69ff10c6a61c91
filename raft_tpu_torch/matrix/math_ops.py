"""Elementwise matrix math of the port (counterpart of
``raft_tpu/matrix/math_ops.py``; ref: cpp/include/raft/matrix/power.cuh,
sqrt.cuh, ratio.cuh, reciprocal.cuh, threshold.cuh, argmax.cuh,
argmin.cuh, sign_flip.cuh, sample_rows.cuh, col_wise_sort.cuh).

Each function takes numpy or a tensor and runs on the tensor's device, or
on the handle's (``cuda`` by default) for numpy input.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import (ensure_resources,
                                           float_operands, input_device)


def _operand(res, matrix):
    return float_operands(input_device(res, matrix), matrix)[0]


def weighted_power(res, matrix, weight=1.0):
    """out = weight · matrix². (ref: matrix/power.cuh ``weighted_power``)"""
    m = _operand(res, matrix)
    return weight * m * m


power = weighted_power  # (ref: power.cuh ``power``, scale 1)


def sqrt(res, matrix, weight=1.0):
    """(ref: matrix/sqrt.cuh ``weighted_sqrt``)"""
    return weight * torch.sqrt(_operand(res, matrix))


def ratio(res, matrix):
    """Divide by the sum of all elements. (ref: matrix/ratio.cuh)"""
    m = _operand(res, matrix)
    return m / m.sum()


def reciprocal(res, matrix, scalar=1.0, set_zero: bool = True, thres=1e-15):
    """out = scalar / matrix, with the entries below ``thres`` in
    magnitude zeroed (or left as scalar / 1 when not ``set_zero``).
    (ref: matrix/reciprocal.cuh)"""
    m = _operand(res, matrix)
    small = m.abs() < thres
    out = scalar / torch.where(small, torch.ones_like(m), m)
    return torch.where(small, torch.zeros_like(out), out) if set_zero else out


def zero_small_values(res, matrix, thres=1e-15):
    """(ref: matrix/threshold.cuh ``zero_small_values``)"""
    m = _operand(res, matrix)
    return torch.where(m.abs() < thres, torch.zeros_like(m), m)


def argmax(res, matrix):
    """Per-row argmax, int32 (the first of equal maxima).
    (ref: matrix/argmax.cuh)"""
    return torch.argmax(_operand(res, matrix), dim=1).to(torch.int32)


def argmin(res, matrix):
    """(ref: matrix/argmin.cuh)"""
    return torch.argmin(_operand(res, matrix), dim=1).to(torch.int32)


def sign_flip(res, matrix):
    """Flip each column's sign so its largest-magnitude entry (the first
    of equal ones) is positive; a column whose pivot is 0 becomes 0, as
    the reference's ``sign(0)`` makes it. (ref: matrix/sign_flip.cuh)"""
    m = _operand(res, matrix)
    pivot = torch.gather(m, 0, torch.argmax(m.abs(), dim=0)[None, :])
    return m * torch.sign(pivot)


def sample_rows(res, matrix, n_samples: int,
                generator: Optional[torch.Generator] = None):
    """A random subset of ``n_samples`` rows, without replacement, drawn
    from ``generator`` (default the handle's). (ref: matrix/
    sample_rows.cuh)"""
    m = _operand(res, matrix)
    if generator is None:
        generator = ensure_resources(res).generator
    idx = torch.randperm(m.shape[0], generator=generator,
                         device=generator.device)[:n_samples]
    return m[idx.to(m.device)]


def sort_cols_per_row(res, keys, values=None, ascending: bool = True):
    """Sort each row's columns by key, stably both ways (descending sorts
    the negated keys, so equal keys keep their order); ``values`` is
    permuted along. Returns the sorted keys, or (keys, values).
    (ref: matrix/col_wise_sort.cuh ``sort_cols_per_row``)"""
    dev = input_device(res, keys)
    keys = torch.as_tensor(keys).to(dev)
    order = torch.argsort(keys if ascending else -keys, dim=1, stable=True)
    sorted_keys = torch.gather(keys, 1, order)
    if values is None:
        return sorted_keys
    vals = torch.as_tensor(values).to(dev)
    return sorted_keys, torch.gather(vals, 1, order)
