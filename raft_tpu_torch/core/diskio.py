"""Durable file I/O: the port's one spelling of "atomic write".

Counterpart of ``raft_tpu/core/diskio.py``. A persistent file (a WAL
manifest, a checkpoint slab) survives a crash at any instruction boundary
only through four steps:

1. write the payload to a temp file in the destination directory (same
   filesystem, so ``os.replace`` cannot fall back to a copy);
2. ``fsync`` the temp file, so the data is on disk before the name;
3. ``os.replace`` it onto the final name (atomic on POSIX);
4. ``fsync`` the parent directory, so the rename itself is durable.

Failures are raised honestly and no temp file is left behind; callers that
must not raise keep their own ``try`` around these helpers.
"""

from __future__ import annotations

import os
import tempfile
from typing import Callable, Optional


def fsync_dir(path: str) -> bool:
    """Flush a directory's metadata (new or renamed entries) to disk.
    Returns False where directories cannot be fsynced (best effort: the
    data file's fsync already happened)."""
    try:
        fd = os.open(path, os.O_RDONLY | getattr(os, "O_DIRECTORY", 0))
    except OSError:
        return False
    try:
        os.fsync(fd)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable, mode: str = "wb") -> str:
    """Write ``path`` atomically and durably: ``writer(f)`` fills a temp
    file in the destination directory, which is fsynced, renamed over
    ``path`` and made durable by a parent-directory fsync. Returns
    ``path``; raises on failure, and the temp file never survives."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".atomic-", suffix=".tmp")
    try:
        with os.fdopen(fd, mode) as f:
            writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    fsync_dir(d)
    return path


def atomic_write_bytes(path: str, data: bytes) -> str:
    """:func:`atomic_write` of one bytes payload."""
    return atomic_write(path, lambda f: f.write(data))


def atomic_write_text(path: str, text: str, encoding: str = "utf-8") -> str:
    """:func:`atomic_write` of one text payload."""
    return atomic_write_bytes(path, text.encode(encoding))


def read_bytes(path: str) -> Optional[bytes]:
    """The file's bytes, or None when it is missing or unreadable: a
    corrupt store degrades, never raises; callers validate the content."""
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None
