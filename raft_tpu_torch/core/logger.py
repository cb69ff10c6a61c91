"""Logging of the port, on Python :mod:`logging`.

Counterpart of ``raft_tpu/core/logger.py`` (ref:
cpp/include/raft/core/logger.hpp:25-67: rapids_logger, default sink
stderr or a file named by ``RAFT_DEBUG_LOG_FILE``, ``RAFT_LOG_*`` macros
gated by ``RAFT_LOG_ACTIVE_LEVEL``), with the same env-var contract. The
records go to the ``raft_tpu_torch`` logger, the parent of the loggers
the port's modules take by ``logging.getLogger(__name__)``:

- ``RAFT_DEBUG_LOG_FILE`` — if set, log to that file instead of stderr.
- ``RAFT_TPU_LOG_LEVEL``  — initial level name (default ``INFO``).
- ``RAFT_LOG_ACTIVE_LEVEL`` — reference-spelled alias for the level
  (honored when ``RAFT_TPU_LOG_LEVEL`` is unset; accepts both plain
  names and the reference's ``RAFT_LEVEL_*`` macro spellings).
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "raft_tpu_torch"

# The reference's finest level (RAFT_LEVEL_TRACE); register the name so
# log_trace output renders as "[TRACE]" rather than "[Level 5]".
TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def _level_from_name(name: str, default: int = logging.INFO) -> int:
    """Level name → int, knowing TRACE and the reference's
    ``RAFT_LEVEL_<NAME>`` spellings; unknown names fall back to
    ``default``."""
    name = name.strip().upper()
    if name.startswith("RAFT_LEVEL_"):
        name = name[len("RAFT_LEVEL_"):]
    name = {"WARN": "WARNING", "ERR": "ERROR", "OFF": "CRITICAL"}.get(
        name, name)
    level = logging.getLevelName(name)
    return level if isinstance(level, int) else default


def _env_level(default: int = logging.INFO) -> int:
    """Initial level from env: ``RAFT_TPU_LOG_LEVEL`` wins, then the
    reference-compatible ``RAFT_LOG_ACTIVE_LEVEL`` alias."""
    raw = (os.environ.get("RAFT_TPU_LOG_LEVEL")
           or os.environ.get("RAFT_LOG_ACTIVE_LEVEL"))
    return _level_from_name(raw, default) if raw else default


def default_logger() -> logging.Logger:
    """The package's logger, given its handler on first use (ref:
    core/logger.hpp ``default_logger()``)."""
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        log_file = os.environ.get("RAFT_DEBUG_LOG_FILE")
        handler: logging.Handler
        if log_file:
            handler = logging.FileHandler(log_file)
        else:
            handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("[%(levelname)s] [%(asctime)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(_env_level())
    return logger


def set_level(level: int | str) -> None:
    if isinstance(level, str):
        level = _level_from_name(level)
    default_logger().setLevel(level)


# RAFT_LOG_* macro equivalents (ref: core/logger.hpp:58+).
def log_trace(fmt: str, *args) -> None:
    default_logger().log(TRACE, fmt, *args)


def log_debug(fmt: str, *args) -> None:
    default_logger().debug(fmt, *args)


def log_info(fmt: str, *args) -> None:
    default_logger().info(fmt, *args)


def log_warn(fmt: str, *args) -> None:
    default_logger().warning(fmt, *args)


def log_error(fmt: str, *args) -> None:
    default_logger().error(fmt, *args)


def log_critical(fmt: str, *args) -> None:
    default_logger().critical(fmt, *args)
