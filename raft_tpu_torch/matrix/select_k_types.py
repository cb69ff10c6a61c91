"""select_k algorithm names (counterpart of
``raft_tpu/matrix/select_k_types.py``; ref:
cpp/include/raft/matrix/select_k_types.hpp:28-70). The values match the
reference package's so a name means the same in both."""

from __future__ import annotations

import enum


class SelectAlgo(enum.Enum):
    AUTO = "auto"
    XLA_TOPK = "xla_topk"
    SLOTTED = "slotted"
    CHUNKED = "chunked"
    BITONIC = "bitonic"
    RADIX = "radix"
    APPROX = "approx"
