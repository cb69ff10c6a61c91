"""Key-value pair for argmin-style reductions (counterpart of
``raft_tpu/core/kvp.py``; ref: cpp/include/raft/core/kvp.hpp)."""

from __future__ import annotations

from typing import Any, NamedTuple


class KeyValuePair(NamedTuple):
    key: Any
    value: Any
