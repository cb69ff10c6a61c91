"""Reductions of the port: reduce / coalesced / strided / map-reduce / MSE
(counterpart of ``raft_tpu/linalg/reduce.py``; ref: cpp/include/raft/
linalg/reduce.cuh, coalesced_reduction.cuh, strided_reduction.cuh,
map_then_reduce.cuh, mean_squared_error.cuh).

The reference's semantics: ``main_op(value, index)`` per element, the
index taken along the reduction axis (the column index for ALONG_ROWS,
the row index for ALONG_COLUMNS); ``reduce_op`` folds from ``init``;
``inplace_target`` is folded in before ``final_op``. bf16 and f16 values
accumulate in f32 unless ``accumulate_dtype`` says otherwise.

The four monoids of ``core.operators`` (add, min, max, mul) take torch's
reductions. Any other ``reduce_op`` folds as a pairwise tree of
``reduce_op`` calls (the reference's ``jax.lax.reduce`` has no torch
counterpart): the same result for an associative op, rounded in another
order.
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core import operators as ops
from raft_tpu_torch.core.resources import as_tensors, float_operands, \
    input_device
from raft_tpu_torch.linalg.types import Apply

_REDUCERS = {
    ops.add_op: lambda x, dim: x.sum(dim),
    ops.min_op: lambda x, dim: x.amin(dim),
    ops.max_op: lambda x, dim: x.amax(dim),
    ops.mul_op: lambda x, dim: x.prod(dim),
}


def _tree_fold(x, init, reduce_op: Callable):
    """reduce_op over ``x``'s first axis as a pairwise tree, ``init``
    padding an odd level and folded in once at the root."""
    init = torch.as_tensor(init, dtype=x.dtype, device=x.device)
    if x.shape[0] == 0:
        return init.expand(x.shape[1:]).clone()
    while x.shape[0] > 1:
        if x.shape[0] % 2:
            x = torch.cat([x, init.expand(1, *x.shape[1:])])
        x = reduce_op(x[0::2], x[1::2])
    return reduce_op(x[0], init)


def reduce(res, data, apply: Apply = Apply.ALONG_ROWS, init=0,
           main_op: Callable = ops.identity_op,
           reduce_op: Callable = ops.add_op,
           final_op: Callable = ops.identity_op, inplace_target=None,
           accumulate_dtype=None):
    """General matrix reduction. (ref: linalg/reduce.cuh ``reduce``;
    see the module docstring)"""
    data, inplace_target = as_tensors(res, data, inplace_target)
    # ALONG_ROWS: one value per row (reduce across columns); a 1-D input
    # reduces its only axis
    dim = 0 if data.ndim == 1 or apply == Apply.ALONG_COLUMNS else 1
    red_idx = torch.arange(data.shape[dim], device=data.device)
    if data.ndim == 2:
        red_idx = red_idx[None, :] if dim == 1 else red_idx[:, None]
    mapped = main_op(data, red_idx.expand(data.shape))
    if accumulate_dtype is None and mapped.dtype in (torch.bfloat16,
                                                     torch.float16):
        accumulate_dtype = torch.float32
    if accumulate_dtype is not None:
        mapped = mapped.to(accumulate_dtype)
    reducer = _REDUCERS.get(reduce_op)
    if reducer is not None:
        folded = reduce_op(reducer(mapped, dim), torch.as_tensor(
            init, dtype=mapped.dtype, device=mapped.device))
    else:
        folded = _tree_fold(mapped.movedim(dim, 0), init, reduce_op)
    if inplace_target is not None:
        folded = reduce_op(folded, inplace_target)
    return final_op(folded)


def coalesced_reduction(res, data, init=0, main_op=ops.identity_op,
                        reduce_op=ops.add_op, final_op=ops.identity_op,
                        inplace_target=None):
    """One output per row. (ref: linalg/coalesced_reduction.cuh)"""
    return reduce(res, data, Apply.ALONG_ROWS, init, main_op, reduce_op,
                  final_op, inplace_target)


def strided_reduction(res, data, init=0, main_op=ops.identity_op,
                      reduce_op=ops.add_op, final_op=ops.identity_op,
                      inplace_target=None):
    """One output per column. (ref: linalg/strided_reduction.cuh)"""
    return reduce(res, data, Apply.ALONG_COLUMNS, init, main_op, reduce_op,
                  final_op, inplace_target)


def map_then_reduce(res, *arrays, map_op: Callable = ops.identity_op,
                    reduce_op: Callable = ops.add_op, init=0,
                    final_op: Callable = ops.identity_op):
    """Map, then reduce everything to a scalar. (ref: linalg/
    map_then_reduce.cuh, map_reduce.cuh)"""
    mapped = map_op(*as_tensors(res, *arrays)).reshape(-1)
    reducer = _REDUCERS.get(reduce_op)
    if reducer is not None:
        folded = reduce_op(reducer(mapped, 0), torch.as_tensor(
            init, dtype=mapped.dtype, device=mapped.device))
    else:
        folded = _tree_fold(mapped, init, reduce_op)
    return final_op(folded)


map_reduce = map_then_reduce


def mean_squared_error(res, a, b, weight: float = 1.0):
    """weight · mean((a − b)²), a 0-d tensor, in f32 (f64 for f64
    inputs). (ref: linalg/mean_squared_error.cuh)"""
    a, b = float_operands(input_device(res, a, b), a, b)
    return ((a - b) ** 2).mean() * weight
