"""Logging of the port: the one call the mutation and durability planes
make (``log_warn``, and ``log_error`` for a malformed fault spec), on
Python :mod:`logging`.

Counterpart of ``raft_tpu/core/logger.py:86``. The reference's handler
set-up (``RAFT_DEBUG_LOG_FILE``, ``RAFT_TPU_LOG_LEVEL``) and its other
levels are not ported; records go to the ``raft_tpu_torch`` logger and
its handlers, as the rest of the port's modules log.
"""

from __future__ import annotations

import logging

_LOGGER_NAME = "raft_tpu_torch"


def default_logger() -> logging.Logger:
    """The package's logger (configured by the application, if at all)."""
    return logging.getLogger(_LOGGER_NAME)


def log_warn(fmt: str, *args) -> None:
    default_logger().warning(fmt, *args)


def log_error(fmt: str, *args) -> None:
    default_logger().error(fmt, *args)
