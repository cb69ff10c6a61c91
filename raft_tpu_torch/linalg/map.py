"""Elementwise map of the port (counterpart of ``raft_tpu/linalg/map.py``;
ref: cpp/include/raft/linalg/map.cuh ``map``/``map_offset``, unary_op.cuh,
binary_op.cuh, ternary_op.cuh).

Thin functional wrappers that keep the reference's vocabulary: ``f`` is
any callable on tensors, applied eagerly by PyTorch on the operands'
device (the first tensor's, else the handle's, else cuda).
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from raft_tpu_torch.core.resources import as_tensors, input_device


def map(res, f: Callable, *arrays):  # noqa: A001
    """out[i] = f(a0[i], a1[i], ...). (ref: map.cuh:95)"""
    return f(*as_tensors(res, *arrays))


def _offsets(shape, device) -> torch.Tensor:
    """The row-major linear index of every element of ``shape``."""
    return torch.arange(math.prod(shape), device=device).reshape(
        tuple(shape))


def map_offset(res, shape, f: Callable, *arrays, device=None):
    """out[i] = f(i, a0[i], ...), ``i`` the row-major linear index.
    (ref: map.cuh ``map_offset``)"""
    args = as_tensors(res, *arrays, device=device)
    dev = args[0].device if args else input_device(res, device=device)
    target = tuple(shape) if shape is not None else args[0].shape
    return f(_offsets(target, dev), *args)


def unary_op(res, x, f: Callable):
    """(ref: linalg/unary_op.cuh ``unaryOp``)"""
    return f(*as_tensors(res, x))


def write_only_unary_op(res, shape, dtype, f: Callable, device=None):
    """An array generated from its indices alone.
    (ref: unary_op.cuh ``writeOnlyUnaryOp``)"""
    return f(_offsets(shape, input_device(res, device=device))).to(dtype)


def binary_op(res, a, b, f: Callable):
    """(ref: linalg/binary_op.cuh)"""
    return f(*as_tensors(res, a, b))


def ternary_op(res, a, b, c, f: Callable):
    """(ref: linalg/ternary_op.cuh)"""
    return f(*as_tensors(res, a, b, c))
