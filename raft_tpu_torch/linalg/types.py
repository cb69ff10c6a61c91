"""Linalg shared types of the port (counterpart of
``raft_tpu/linalg/types.py``; ref: cpp/include/raft/linalg/
linalg_types.hpp)."""

from __future__ import annotations

import enum


class Apply(enum.Enum):
    """Which direction a rowwise/colwise op applies.
    (ref: linalg_types.hpp ``Apply::ALONG_ROWS / ALONG_COLUMNS``)

    The reference's convention: for reductions, ALONG_ROWS outputs one
    value per ROW (each row reduced across its columns) and ALONG_COLUMNS
    one value per COLUMN. For broadcasts (matrix_vector_op, linewise_op),
    ALONG_ROWS means the vector spans a row (length == n_cols)."""

    ALONG_ROWS = 0
    ALONG_COLUMNS = 1


class NormType(enum.Enum):
    """(ref: linalg/norm_types.hpp L1Norm/L2Norm/LinfNorm)"""

    L1 = 1
    L2 = 2
    LINF = 3
