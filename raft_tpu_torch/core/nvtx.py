"""Tracing ranges: the thread-local range stack that spans attribute to.

Counterpart of ``raft_tpu/core/nvtx.py`` (ref: cpp/include/raft/core/
nvtx.hpp:88-121 — ``push_range`` / ``pop_range`` and the RAII ``range``,
with the thread-local stack of core/detail/nvtx_range_stack.hpp). Each
range is pushed onto this thread's stack, so
:func:`~raft_tpu_torch.observability.span` can attribute a span to the
innermost enclosing range, and on a CUDA build it is also an NVTX range
(``torch.cuda.nvtx.range_push`` / ``range_pop``) that a profiler's
timeline shows. Where CUDA is absent the NVTX half is a no-op.

Disabled globally when ``RAFT_TPU_DISABLE_TRACING`` is set (the
reference's ``--no-nvtx`` build).
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Callable, Dict, Iterator, List, Optional

_ENABLED = not os.environ.get("RAFT_TPU_DISABLE_TRACING")

_tls = threading.local()
# each thread's stack by thread id, so a sampler on another thread can
# attribute to it (core.memory.ResourceMonitor)
_stacks: Dict[int, List[str]] = {}

# open profiler windows (profiling()); ranges are record_functions in one
_profiling = 0

# callables told of every push and pop, on the pushing thread, with the
# range entered or about to be left (core.memory.ResourceMonitor)
_range_hooks: List[Callable[[str], None]] = []

# None: not probed yet; then True when torch has a CUDA build with NVTX
_nvtx_ok: Optional[bool] = None


def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
        _stacks[threading.get_ident()] = st
    return st


def _cuda_nvtx():
    """``torch.cuda.nvtx`` when this build can emit NVTX ranges, else
    None (probed once)."""
    global _nvtx_ok
    if _nvtx_ok is None:
        try:
            import torch

            _nvtx_ok = bool(torch.cuda.is_available())
        except Exception:
            _nvtx_ok = False
    if not _nvtx_ok:
        return None
    import torch

    return torch.cuda.nvtx


def current_range(thread_id: Optional[int] = None) -> Optional[str]:
    """Innermost active range on this thread (or on the thread of
    ``thread_id``), or None."""
    st = _stack() if thread_id is None else _stacks.get(thread_id)
    try:
        return st[-1] if st else None
    except IndexError:          # popped by its thread since the test
        return None


def range_stack() -> List[str]:
    """This thread's active ranges, outermost first."""
    return list(_stack())


def push_range(fmt: str, *args) -> None:
    """(ref: core/nvtx.hpp:88 ``push_range``)"""
    if not _ENABLED:
        return
    name = fmt % args if args else fmt
    _stack().append(name)
    for hook in _range_hooks:
        hook(name)
    nv = _cuda_nvtx()
    if nv is not None:
        nv.range_push(name)


def pop_range() -> None:
    """(ref: core/nvtx.hpp:104 ``pop_range``). Pops defensively: an
    empty stack logs the imbalance instead of raising."""
    if not _ENABLED:
        return
    st = _stack()
    if not st:
        from raft_tpu_torch.core.logger import log_warn

        log_warn("nvtx: range stack imbalance — pop on an empty stack")
        return
    for hook in _range_hooks:
        hook(st[-1])
    st.pop()
    nv = _cuda_nvtx()
    if nv is not None:
        nv.range_pop()


@contextlib.contextmanager
def annotate(fmt: str, *args) -> Iterator[None]:
    """Scoped range. (ref: core/nvtx.hpp:121 ``range``) Inside a
    profiler window (:func:`profiling`) it is also a
    ``torch.profiler.record_function``, so the trace nests the range's
    work under its name."""
    push_range(fmt, *args)
    try:
        if _profiling and _ENABLED:
            from torch.profiler import record_function

            with record_function(current_range() or ""):
                yield
        else:
            yield
    finally:
        pop_range()


@contextlib.contextmanager
def profiling() -> Iterator[None]:
    """A profiler window: ranges opened inside it are also
    ``record_function`` ranges
    (``observability.profiler.Profiler.trace``)."""
    global _profiling
    _profiling += 1
    try:
        yield
    finally:
        _profiling -= 1


# alias matching the reference class name
range = annotate  # noqa: A001
