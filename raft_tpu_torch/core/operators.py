"""Elementwise operator functors of the port (counterpart of
``raft_tpu/core/operators.py``; ref: cpp/include/raft/core/operators.hpp).

Only the ops that the port's ``linalg`` reductions and norms name: the
reductions recognise these objects (``linalg.reduce._REDUCERS``) and take
the matching torch reduction; any other callable folds generically. The
rest of the reference's vocabulary waits for ROADMAP item 16.
"""

from __future__ import annotations

import torch


def identity_op(x, *_):
    return x


def add_op(a, b):
    return a + b


def mul_op(a, b):
    return a * b


def min_op(a, b):
    return torch.minimum(a, b)


def max_op(a, b):
    return torch.maximum(a, b)


def sqdiff_op(a, b):
    d = a - b
    return d * d
