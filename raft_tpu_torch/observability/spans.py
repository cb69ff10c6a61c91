"""Span tracing layered on the :mod:`raft_tpu_torch.core.nvtx` range stack.

Counterpart of ``raft_tpu/observability/spans.py``. A *span* is a range
that also reports into the metrics registry: call count, wall time and
tensor bytes in / out, attributed to the innermost enclosing range at
entry. The span itself is pushed as a range (an NVTX range on the card),
so nested instrumented calls attribute to their caller's span.

Timing semantics, dispatch vs execute: PyTorch launches CUDA work
asynchronously, so a host timer around a call brackets its launches and
any host reads inside it, not the device's execution. Span timings are
exported as ``raft_tpu_span_seconds`` in that sense, and no span ever
synchronizes the card to make them otherwise: a served batch's own copy
of its results to the host is its completion.

Disabled contract (``RAFT_TPU_DISABLE_TRACING``): ``instrument`` applied
in a disabled process returns the function unchanged — no wrapper frame.
A runtime :func:`raft_tpu_torch.observability.disable` leaves the
wrapper in place but short-circuits after one boolean attribute check.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Iterator, Optional

import numpy as np

from raft_tpu_torch.core import nvtx
from raft_tpu_torch.observability.metrics import ENV_DISABLED, get_registry
from raft_tpu_torch.observability.timeline import emit_span

SPAN_CALLS = "raft_tpu_span_calls_total"
SPAN_ERRORS = "raft_tpu_span_errors_total"
SPAN_SECONDS = "raft_tpu_span_seconds"
SPAN_BYTES_IN = "raft_tpu_span_bytes_in_total"
SPAN_BYTES_OUT = "raft_tpu_span_bytes_out_total"


def tree_nbytes(tree) -> int:
    """Total payload bytes of the tensors and arrays in ``tree`` (nested
    tuples, lists and dicts are walked; other leaves count 0)."""
    if isinstance(tree, (tuple, list)):
        return sum(tree_nbytes(t) for t in tree)
    if isinstance(tree, dict):
        return sum(tree_nbytes(t) for t in tree.values())
    nelement = getattr(tree, "nelement", None)
    if callable(nelement):                      # torch.Tensor
        return int(nelement()) * int(tree.element_size())
    n = getattr(tree, "nbytes", None)                 # numpy
    return int(n) if isinstance(n, (int, np.integer)) else 0


def _record(name: str, parent: str, seconds: float, bytes_in: int,
            bytes_out: int, error: bool) -> None:
    emit_span(name, parent, seconds, bytes_in, bytes_out, error,
              stack=nvtx.range_stack())
    reg = get_registry()
    labels = {"span": name, "range": parent}
    reg.counter(SPAN_CALLS, labels,
                help="Instrumented-span invocations").inc()
    if error:
        reg.counter(SPAN_ERRORS, labels,
                    help="Spans that exited with an exception").inc()
    reg.histogram(SPAN_SECONDS, labels,
                  help="Span dispatch wall time (seconds; trace-time "
                       "under jit)").observe(seconds)
    if bytes_in:
        reg.counter(SPAN_BYTES_IN, labels,
                    help="Array bytes entering the span").inc(bytes_in)
    if bytes_out:
        reg.counter(SPAN_BYTES_OUT, labels,
                    help="Array bytes produced by the span").inc(bytes_out)
    reg.emit({"type": "span", "span": name, "range": parent,
              "seconds": seconds, "bytes_in": bytes_in,
              "bytes_out": bytes_out, "error": error})


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """Scoped span: an ``nvtx.annotate`` range that also records call
    count and wall time, attributed to the enclosing range."""
    if not get_registry().enabled:
        yield
        return
    parent = nvtx.current_range() or ""
    t0 = time.perf_counter()
    error = False
    try:
        with nvtx.annotate(name):
            yield
    except BaseException:
        error = True
        raise
    finally:
        _record(name, parent, time.perf_counter() - t0, 0, 0, error)


def instrument(name: Optional[str] = None) -> Callable:
    """Decorator marking a hot-path call for observation.

    Records per call: ``raft_tpu_span_calls_total``, wall time into
    ``raft_tpu_span_seconds``, tensor bytes in / out, plus a span event —
    all labeled ``{span=<name>, range=<enclosing range>}``.
    """

    def decorate(fn: Callable) -> Callable:
        span_name = name or f"{fn.__module__}.{fn.__qualname__}"
        if ENV_DISABLED:
            fn.__instrumented__ = span_name
            return fn

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not get_registry().enabled:
                return fn(*args, **kwargs)
            parent = nvtx.current_range() or ""
            bytes_in = tree_nbytes((args, kwargs))
            t0 = time.perf_counter()
            try:
                with nvtx.annotate(span_name):
                    out = fn(*args, **kwargs)
            except BaseException:
                _record(span_name, parent, time.perf_counter() - t0,
                        bytes_in, 0, True)
                raise
            _record(span_name, parent, time.perf_counter() - t0,
                    bytes_in, tree_nbytes(out), False)
            return out

        wrapper.__instrumented__ = span_name
        return wrapper

    return decorate
