"""Cooperative cancellation of the port's host waits.

Counterpart of ``raft_tpu/core/interruptible.py`` (the reference's
``raft::interruptible``: a per-thread token, cancellation points that
raise once it is flipped, and a polling wait). A
:func:`~raft_tpu_torch.resilience.deadline` scope flips the calling
thread's token from a timer thread; every cancellation point inside the
scope then raises:

- :func:`yield_` raises :class:`~raft_tpu_torch.core.error.
  DeadlineExceededError` for the earliest expired scope of this thread
  (with the thread's active range stack, :mod:`raft_tpu_torch.core.
  nvtx`), or :class:`InterruptedException` after :func:`cancel`;
- :func:`wait_event` waits for a CUDA event by polling it and the token,
  so a hung dispatch becomes a typed error instead of a blocked thread;
  an injected ``hang`` fault polls :func:`yield_` the same way.

A thread's own token lives in ``threading.local`` storage; the
ident-keyed registry only lets :func:`cancel` reach another live thread.
Every token mutation holds the token's lock, so a timer firing on its
own thread cannot race the owner's check-and-clear.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from raft_tpu_torch.core.error import DeadlineExceededError, RaftException

#: seconds between two polls of a cancellable wait
POLL_S = 1e-4


class InterruptedException(RaftException):
    """Raised at a cancellation point after :func:`cancel`."""


class _Token:
    __slots__ = ("lock", "cancelled", "fired")

    def __init__(self):
        self.lock = threading.Lock()
        self.cancelled = False
        # expiry records of fired deadline scopes, in firing order
        self.fired = []


_registry: Dict[int, _Token] = {}
_registry_lock = threading.Lock()
_tls = threading.local()


def get_token(thread_id: Optional[int] = None) -> _Token:
    """The token of ``thread_id`` (default: the calling thread's, kept in
    thread-local storage), created on first use."""
    if thread_id is None:
        tok = getattr(_tls, "token", None)
        if tok is None:
            tok = _tls.token = _Token()
            with _registry_lock:
                _registry[threading.get_ident()] = tok
        return tok
    with _registry_lock:
        tok = _registry.get(thread_id)
        if tok is None:
            tok = _registry[thread_id] = _Token()
        return tok


def cancel(thread_id: Optional[int] = None) -> None:
    """Request cancellation of a thread's next cancellation point."""
    tok = get_token(thread_id)
    with tok.lock:
        tok.cancelled = True


def yield_() -> None:
    """Cancellation point (see the module docstring). A fired deadline
    is also counted (``raft_tpu_deadline_exceeded_total{scope}``) and
    emitted as a ``deadline`` timeline event before it raises."""
    tok = get_token()
    with tok.lock:
        if not tok.cancelled:
            return
        fired = tok.fired.pop(0) if tok.fired else None
        tok.cancelled = bool(tok.fired)
    if fired is None:
        raise InterruptedException("interruptible: cancelled")
    from raft_tpu_torch.core import nvtx

    spans = nvtx.range_stack()
    label = fired.get("label") or "deadline"
    seconds = fired.get("seconds")
    try:
        from raft_tpu_torch.observability.metrics import get_registry
        from raft_tpu_torch.observability.timeline import emit_deadline

        get_registry().counter(
            "raft_tpu_deadline_exceeded_total", {"scope": label},
            help="Deadline scopes that expired and cancelled their "
                 "thread").inc()
        emit_deadline(label, seconds, fired=True, stack=spans)
    except Exception:
        pass
    raise DeadlineExceededError(
        f"deadline {label!r} of {seconds}s exceeded"
        + (f" (active spans: {' > '.join(spans)})" if spans else ""),
        seconds=seconds, span_stack=spans)


def wait_event(event) -> None:
    """Block until ``event`` (a ``torch.cuda.Event``, or anything with a
    ``query()``) has completed, polling this thread's token."""
    while not event.query():
        yield_()
        time.sleep(POLL_S)
    yield_()
