"""Deadline scopes: a hang becomes a typed, per-thread error.

Counterpart of ``raft_tpu/resilience/deadline.py:57`` and of the
cancellation token it arms (``raft_tpu/core/interruptible.py``).
:func:`deadline` arms the calling thread's token from a timer thread, so
every cancellation point inside the scope — :func:`yield_`, or
:func:`wait_event`, which polls a CUDA event — raises
:class:`~raft_tpu_torch.core.error.DeadlineExceededError` within one poll
interval of expiry::

    with deadline(0.05, label="serving_flush"):
        vals, ids = plane(snapshot, x)
        wait_event(done)              # polling wait — cancellable

Scope semantics (the reference's):

- The deadline binds to the calling thread's token; other threads are not
  covered.
- Only cancellation points convert. When the body completes after the
  deadline fired, the scope raises at exit (the budget was exceeded); a
  scope that exits in time disarms its timer.
- Scopes nest on one thread and are thread-safe: each scope removes only
  its own expiry record, and every arm, fire and consume holds the
  token's lock. Tokens are thread-local.

Fault injection (``fault_point``) is telemetry of the reference and is not
ported.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator, Optional

from raft_tpu_torch.core.error import DeadlineExceededError, expects

# seconds between two polls of a cancellable wait
POLL_S = 1e-4


class _Token:
    __slots__ = ("lock", "cancelled", "fired")

    def __init__(self):
        self.lock = threading.Lock()
        self.cancelled = False
        # expiry records of fired scopes, in firing order
        self.fired = []


_tls = threading.local()


def get_token() -> _Token:
    """The calling thread's cancellation token (created on first use)."""
    tok = getattr(_tls, "token", None)
    if tok is None:
        tok = _tls.token = _Token()
    return tok


def yield_() -> None:
    """Cancellation point: raises :class:`DeadlineExceededError` for the
    earliest expired scope of this thread, if any."""
    tok = get_token()
    with tok.lock:
        if not tok.cancelled:
            return
        fired = tok.fired.pop(0) if tok.fired else None
        tok.cancelled = bool(tok.fired)
    if fired is not None:
        raise DeadlineExceededError(
            f"deadline {fired['label']!r} of {fired['seconds']}s exceeded",
            seconds=fired["seconds"])


def wait_event(event) -> None:
    """Block until ``event`` (a ``torch.cuda.Event``, or anything with a
    ``query()``) has completed, polling this thread's token: inside a
    :func:`deadline` scope a hung dispatch becomes a
    :class:`DeadlineExceededError` instead of a blocked thread."""
    while not event.query():
        yield_()
        time.sleep(POLL_S)
    yield_()


@contextlib.contextmanager
def deadline(seconds: float, label: Optional[str] = None) -> Iterator[None]:
    """Arm a watchdog that cancels this thread ``seconds`` from now (see
    the module docstring for the scope's semantics)."""
    expects(seconds > 0, "deadline: seconds must be > 0 (got %s)", seconds)
    tok = get_token()
    info = {"seconds": float(seconds), "label": label or "deadline"}
    fired = threading.Event()

    def _fire():
        with tok.lock:
            tok.fired.append(info)
            fired.set()
            tok.cancelled = True

    timer = threading.Timer(float(seconds), _fire)
    timer.daemon = True
    timer.start()
    try:
        yield
        # a deadline that fired after the last cancellation point: the
        # budget was exceeded all the same
        yield_()
    finally:
        timer.cancel()
        if fired.is_set():
            # un-poison the token if OUR expiry was not consumed (another
            # exception is propagating); other scopes' records stay
            with tok.lock:
                try:
                    tok.fired.remove(info)
                except ValueError:
                    pass
                else:
                    if not tok.fired:
                        tok.cancelled = False
