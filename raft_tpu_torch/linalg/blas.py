"""BLAS-level ops of the port: gemm / gemv / axpy / dot (counterpart of
``raft_tpu/linalg/blas.py``; ref: cpp/include/raft/linalg/gemm.cuh:51,
gemv.cuh, axpy.cuh, dot.cuh).

Products run in f32 with TF32 off (``core.resources``). bf16 and f16
operands are widened to f32 first, so their products are exact and
accumulate in f32 (the reference's ``preferred_element_type``); the result
returns in the operand's dtype unless ``preferred_element_type`` is given.
"""

from __future__ import annotations


import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_tensors


def _preferred(dtype):
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _matmul(a, b, out_dtype):
    return torch.matmul(a.to(out_dtype), b.to(out_dtype))


def gemm(res, A, B, C=None, alpha=1.0, beta=0.0, trans_a: bool = False,
         trans_b: bool = False, preferred_element_type=None):
    """C = alpha · op(A) @ op(B) + beta · C. (ref: gemm.cuh:51)"""
    A, B, C = as_tensors(res, A, B, C)
    if trans_a:
        A = A.T
    if trans_b:
        B = B.T
    pet = preferred_element_type or _preferred(A.dtype)
    out = alpha * _matmul(A, B, pet)
    if C is not None and beta != 0.0:
        out = out + beta * C
    return out.to(A.dtype) if preferred_element_type is None else out


def gemv(res, A, x, y=None, alpha=1.0, beta=0.0, trans_a: bool = False):
    """y = alpha · op(A) @ x + beta · y. (ref: linalg/gemv.cuh)"""
    A, x, y = as_tensors(res, A, x, y)
    if trans_a:
        A = A.T
    expects(A.shape[1] == x.shape[0], "gemv: inner dim mismatch %d vs %d",
            A.shape[1], x.shape[0])
    out = alpha * _matmul(A, x, _preferred(A.dtype))
    if y is not None and beta != 0.0:
        out = out + beta * y
    return out.to(A.dtype)


def axpy(res, alpha, x, y):
    """y = alpha · x + y. (ref: linalg/axpy.cuh)"""
    x, y = as_tensors(res, x, y)
    return alpha * x + y


def dot(res, x, y):
    """(ref: linalg/dot.cuh)"""
    x, y = as_tensors(res, x, y)
    return _matmul(x, y, _preferred(x.dtype)).to(x.dtype)
