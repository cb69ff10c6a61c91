"""Elementwise arithmetic of the port with the reference's names
(counterpart of ``raft_tpu/linalg/eltwise.py``; ref: cpp/include/raft/
linalg/add.cuh, subtract.cuh, multiply.cuh, divide.cuh, power.cuh,
sqrt.cuh, eltwise.cuh)."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.resources import as_tensors


# vector ⊕ vector
def add(res, a, b):
    a, b = as_tensors(res, a, b)
    return a + b


def subtract(res, a, b):
    a, b = as_tensors(res, a, b)
    return a - b


def multiply(res, a, b):
    a, b = as_tensors(res, a, b)
    return a * b


def divide(res, a, b):
    a, b = as_tensors(res, a, b)
    return a / b


def power(res, a, b):
    a, b = as_tensors(res, a, b)
    return a ** b


def sqrt(res, a):
    return torch.sqrt(*as_tensors(res, a))


# vector ⊕ scalar (ref: *_scalar variants)
def add_scalar(res, a, scalar):
    return as_tensors(res, a)[0] + scalar


def subtract_scalar(res, a, scalar):
    return as_tensors(res, a)[0] - scalar


def multiply_scalar(res, a, scalar):
    return as_tensors(res, a)[0] * scalar


def divide_scalar(res, a, scalar):
    return as_tensors(res, a)[0] / scalar


def power_scalar(res, a, scalar):
    return as_tensors(res, a)[0] ** scalar


# eltwise aliases (ref: eltwise.cuh scalarAdd/scalarMultiply/eltwiseAdd/...)
scalar_add = add_scalar
scalar_multiply = multiply_scalar
eltwise_add = add
eltwise_sub = subtract
eltwise_multiply = multiply
eltwise_divide = divide


def eltwise_divide_check_zero(res, a, b):
    """a / b, 0 where b is 0. (ref: eltwise.cuh ``eltwiseDivideCheckZero``)"""
    a, b = as_tensors(res, a, b)
    zero = b == 0
    q = a / torch.where(zero, torch.ones_like(b), b)
    return torch.where(zero, torch.zeros_like(q), q)
