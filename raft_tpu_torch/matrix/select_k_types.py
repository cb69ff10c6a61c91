"""select_k algorithm names (counterpart of
``raft_tpu/matrix/select_k_types.py``; ref:
cpp/include/raft/matrix/select_k_types.hpp:28-70). The values match the
reference package's so a name means the same in both: ``RADIX`` is an
alias of ``CHUNKED`` and ``BITONIC`` of ``SLOTTED``, the algorithms that
serve their roles."""

from __future__ import annotations

import enum

import numpy as np
import torch


class SelectAlgo(enum.Enum):
    AUTO = "auto"
    XLA_TOPK = "xla_topk"
    SLOTTED = "slotted"
    CHUNKED = "chunked"
    BITONIC = "bitonic"
    RADIX = "radix"
    APPROX = "approx"

    # reference-name aliases → nearest variant
    @classmethod
    def from_reference_name(cls, name: str) -> "SelectAlgo":
        name = (name.lower().replace("k", "", 1) if name.startswith("k")
                else name.lower())
        mapping = {
            "auto": cls.AUTO,
            "radix8bits": cls.RADIX,
            "radix11bits": cls.RADIX,
            "radix11bitsextrapass": cls.RADIX,
            "warpauto": cls.BITONIC,
            "warpimmediate": cls.BITONIC,
            "warpfiltered": cls.BITONIC,
            "warpdistributed": cls.BITONIC,
            "warpdistributedshm": cls.BITONIC,
        }
        return mapping[name]


def f32_comparable_keys(dtype) -> bool:
    """Whether selection keys of ``dtype`` (torch or numpy) compare
    exactly after an f32 cast — the shared dtype envelope of SLOTTED and
    CHUNKED (f64 and integer keys could collide distinct values)."""
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.empty(0, dtype=dtype)).dtype
    return dtype.is_floating_point and torch.finfo(dtype).bits <= 32
