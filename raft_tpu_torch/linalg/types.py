"""Linalg shared types of the port (counterpart of
``raft_tpu/linalg/types.py``; ref: cpp/include/raft/linalg/
linalg_types.hpp). Only what the ported modules use so far."""

from __future__ import annotations

import enum


class NormType(enum.Enum):
    """(ref: linalg/norm_types.hpp L1Norm/L2Norm/LinfNorm)"""

    L1 = 1
    L2 = 2
    LINF = 3
