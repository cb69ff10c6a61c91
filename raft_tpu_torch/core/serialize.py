"""Framed array bytes: the payload format of the WAL and the checkpoints.

Counterpart of the framed-bytes half of ``raft_tpu/core/serialize.py``
(``mdspan_to_bytes`` ``:78``, ``read_framed`` ``:88``,
``mdspan_from_bytes`` ``:104``). A frame is the magic ``RTNP``, a u16
format version and a u64 payload length (little-endian), then a standard
``.npy`` payload; frames concatenate and a truncated one is detected here
with an honest message. The reader also takes bare ``.npy`` bytes (the
format before framing). The bytes are the reference's for the same
array, so a file written by either package reads in the other.

Arrays are plain numpy here: the reference's mdspan layer (``MdSpan``,
``as_numpy``) and its stream API are not ported.
"""

from __future__ import annotations

import io
import struct
from typing import Any, Tuple

import numpy as np

#: the frame header: magic, format version, payload length. The magic
#: cannot collide with .npy (which starts ``\x93NUMPY``).
FRAME_MAGIC = b"RTNP"
FRAME_VERSION = 1
_FRAME_HEADER = struct.Struct("<4sHQ")


def _npy(data: bytes) -> np.ndarray:
    return np.load(io.BytesIO(data), allow_pickle=False)


def mdspan_to_bytes(obj: Any) -> bytes:
    """One framed array: the header, then ``np.save``'s .npy payload."""
    buf = io.BytesIO()
    np.save(buf, np.asarray(obj), allow_pickle=False)
    payload = buf.getvalue()
    return _FRAME_HEADER.pack(FRAME_MAGIC, FRAME_VERSION,
                              len(payload)) + payload


def read_framed(data: bytes, offset: int = 0) -> Tuple[np.ndarray, int]:
    """Decode one framed array at ``offset``; returns (array, the offset
    past the frame). Raises ``ValueError`` on a bad magic, a newer version
    or a truncated frame."""
    data = bytes(data)
    end_h = offset + _FRAME_HEADER.size
    if len(data) < end_h:
        raise ValueError(
            f"truncated framed mdspan stream: {len(data) - offset} byte(s) "
            f"at offset {offset}, header needs {_FRAME_HEADER.size}")
    magic, version, plen = _FRAME_HEADER.unpack_from(data, offset)
    if magic != FRAME_MAGIC:
        raise ValueError(f"framed mdspan stream: bad magic {magic!r} at "
                         f"offset {offset}")
    if version > FRAME_VERSION:
        raise ValueError(f"framed mdspan stream: version {version} is "
                         f"newer than this reader ({FRAME_VERSION})")
    if len(data) < end_h + plen:
        raise ValueError(
            f"truncated framed mdspan stream: header promises {plen} "
            f"payload byte(s), only {len(data) - end_h} present")
    return _npy(data[end_h:end_h + plen]), end_h + plen


def mdspan_from_bytes(data: bytes) -> np.ndarray:
    """One array from ``data``: framed, or bare .npy (the format before
    framing, read as a fallback)."""
    data = bytes(data)
    if data[:len(FRAME_MAGIC)] == FRAME_MAGIC:
        return read_framed(data)[0]
    return _npy(data)
