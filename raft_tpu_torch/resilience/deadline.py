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

The token and the cancellation points live in
:mod:`raft_tpu_torch.core.interruptible`; an injected ``hang`` fault
(:mod:`raft_tpu_torch.resilience.faults`) polls them too, so a scope
converts it like a real stuck wait. An armed scope and a fired one are
``deadline`` timeline events.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.interruptible import (get_token, wait_event,  # noqa: F401
                                               yield_)


@contextlib.contextmanager
def deadline(seconds: float, label: Optional[str] = None) -> Iterator[None]:
    """Arm a watchdog that cancels this thread ``seconds`` from now (see
    the module docstring for the scope's semantics)."""
    expects(seconds > 0, "deadline: seconds must be > 0 (got %s)", seconds)
    tok = get_token()
    info = {"seconds": float(seconds), "label": label or "deadline"}
    fired = threading.Event()
    try:
        from raft_tpu_torch.observability.timeline import emit_deadline

        emit_deadline(info["label"], info["seconds"], fired=False)
    except Exception:
        pass

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
