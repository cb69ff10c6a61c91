"""Error system of the PyTorch port.

(Counterpart of ``raft_tpu/core/error.py``; ref: cpp/include/raft/core/
error.hpp — ``raft::exception``, ``RAFT_EXPECTS`` / ``RAFT_FAIL``.) The port
keeps the logic/device pair that its entry points raise; a failed CUDA
launch or a missing card is a :class:`DeviceError`; a deadline scope that
expired is a :class:`DeadlineExceededError`.
"""

from __future__ import annotations

from typing import List, Optional


def _flight_tail() -> List[dict]:
    """The newest flight-recorder events at error-construction time ([]
    when the recorder is off; never raises)."""
    try:
        from raft_tpu_torch.observability.flight import error_tail

        return error_tail()
    except Exception:
        return []


class RaftException(Exception):
    """Base exception. (ref: core/error.hpp ``raft::exception``)"""


class LogicError(RaftException):
    """Invalid API usage / failed precondition.
    (ref: core/error.hpp ``raft::logic_error``)"""


class DeviceError(RaftException):
    """Accelerator-side failure: no CUDA device where one was asked for,
    a kernel that did not build, or a launch that CUDA refused. Carries
    ``flight_tail``, the newest timeline events when it was made.
    (ref: core/error.hpp ``raft::cuda_error``)"""

    def __init__(self, *args):
        super().__init__(*args)
        self.flight_tail = _flight_tail()


class OutOfMemoryError(DeviceError):
    """Device memory exhausted."""


class DeadlineExceededError(RaftException):
    """A :func:`raft_tpu_torch.resilience.deadline` scope expired before
    the guarded work completed (reference ``raft_tpu/core/error.py:55``).
    ``seconds`` is the scope's budget, ``span_stack`` the cancelled
    thread's active ranges and ``flight_tail`` the newest timeline
    events when it was raised."""

    def __init__(self, message: str, seconds: Optional[float] = None,
                 span_stack: Optional[List[str]] = None):
        super().__init__(message)
        self.seconds = seconds
        self.span_stack = list(span_stack or [])
        self.flight_tail = _flight_tail()


def expects(condition: bool, fmt: str, *args) -> None:
    """Check a precondition; raise :class:`LogicError` on failure.
    (ref: core/error.hpp ``RAFT_EXPECTS``)"""
    if not condition:
        raise LogicError(fmt % args if args else fmt)
