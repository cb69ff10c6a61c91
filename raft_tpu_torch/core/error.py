"""Error system of the PyTorch port.

(Counterpart of ``raft_tpu/core/error.py``; ref: cpp/include/raft/core/
error.hpp — ``raft::exception``, ``RAFT_EXPECTS`` / ``RAFT_FAIL``.) The port
keeps the logic/device pair that its entry points raise; a failed CUDA
launch or a missing card is a :class:`DeviceError`; a deadline scope that
expired is a :class:`DeadlineExceededError`.
"""

from __future__ import annotations

from typing import Optional


class RaftException(Exception):
    """Base exception. (ref: core/error.hpp ``raft::exception``)"""


class LogicError(RaftException):
    """Invalid API usage / failed precondition.
    (ref: core/error.hpp ``raft::logic_error``)"""


class DeviceError(RaftException):
    """Accelerator-side failure: no CUDA device where one was asked for,
    a kernel that did not build, or a launch that CUDA refused.
    (ref: core/error.hpp ``raft::cuda_error``)"""


class DeadlineExceededError(RaftException):
    """A :func:`raft_tpu_torch.resilience.deadline` scope expired before
    the guarded work completed (reference ``raft_tpu/core/error.py:55``;
    the flight-recorder tail it carries there is telemetry, not ported).
    ``seconds`` is the scope's budget."""

    def __init__(self, message: str, seconds: Optional[float] = None):
        super().__init__(message)
        self.seconds = seconds


def expects(condition: bool, fmt: str, *args) -> None:
    """Check a precondition; raise :class:`LogicError` on failure.
    (ref: core/error.hpp ``RAFT_EXPECTS``)"""
    if not condition:
        raise LogicError(fmt % args if args else fmt)


def not_ported(what: str):
    """Raise for an option that needs the multi-device mesh."""
    raise NotImplementedError(
        f"{what} needs the multi-device mesh, which is not ported to the GPU "
        f"yet (ROADMAP queue 1, item 7)")
