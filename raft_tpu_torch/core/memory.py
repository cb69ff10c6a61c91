"""Memory observability: tracking, statistics and notifying adaptors.

Counterpart of ``raft_tpu/core/memory.py`` (ref:
cpp/include/raft/core/memory_stats_resources.hpp,
core/memory_tracking_resources.hpp, mr/statistics_adaptor.hpp:25,66,
mr/notifying_adaptor.hpp:25,77, mr/resource_monitor.hpp:42).

PyTorch's caching allocator owns device memory, so the adaptors account
logical allocations made through them and surface live and peak figures:
:class:`MemoryTracker` is the accounting core (bridged to the metrics
registry by ``observability.hooks.record_alloc`` / ``record_free``),
:class:`StatisticsAdaptor` / :class:`NotifyingAdaptor` the adaptor
vocabulary. :class:`ResourceMonitor` samples the allocator's
``torch.cuda.memory_stats()`` (``allocated_bytes.all.current``) on a
thread, attributing each sample to the innermost active range
(:mod:`raft_tpu_torch.core.nvtx`): the range-attributed memory timeline.
Off a CUDA device the samples read 0 and :func:`device_memory_stats`
returns ``{}``, as the reference does off a TPU; nothing here raises.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, TextIO

import torch

from raft_tpu_torch.core import nvtx


class MemoryTracker:
    """Live/peak/total byte and allocation counters.
    (ref: mr/statistics_adaptor.hpp counters)"""

    def __init__(self):
        self._lock = threading.Lock()
        self.current_bytes = 0
        self.peak_bytes = 0
        self.total_bytes = 0
        self.current_count = 0
        self.peak_count = 0
        self.total_count = 0

    def allocate(self, nbytes: int) -> None:
        with self._lock:
            self.current_bytes += nbytes
            self.total_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.current_bytes)
            self.current_count += 1
            self.total_count += 1
            self.peak_count = max(self.peak_count, self.current_count)
            current, peak = self.current_bytes, self.peak_bytes
        # bridge to the unified metrics registry (outside our lock; the
        # hook is a no-op when tracing is disabled)
        from raft_tpu_torch.observability.hooks import record_alloc

        record_alloc(nbytes, current, peak)

    def deallocate(self, nbytes: int) -> None:
        with self._lock:
            self.current_bytes -= nbytes
            self.current_count -= 1
            current = self.current_bytes
        from raft_tpu_torch.observability.hooks import record_free

        record_free(nbytes, current)


class StatisticsAdaptor:
    """Wraps an upstream 'allocate' callable with statistics accounting.
    (ref: mr/statistics_adaptor.hpp:66)"""

    def __init__(self, upstream: Optional[Callable[[int], object]] = None):
        self.upstream = upstream
        self.stats = MemoryTracker()

    def allocate(self, nbytes: int):
        self.stats.allocate(nbytes)
        return self.upstream(nbytes) if self.upstream else None

    def deallocate(self, obj, nbytes: int) -> None:
        self.stats.deallocate(nbytes)


class NotifyingAdaptor:
    """Invokes callbacks on every allocate/deallocate.
    (ref: mr/notifying_adaptor.hpp:77)"""

    def __init__(
        self,
        upstream: Optional[Callable[[int], object]] = None,
        on_allocate: Optional[Callable[[int], None]] = None,
        on_deallocate: Optional[Callable[[int], None]] = None,
    ):
        self.upstream = upstream
        self.on_allocate = on_allocate
        self.on_deallocate = on_deallocate

    def allocate(self, nbytes: int):
        if self.on_allocate:
            self.on_allocate(nbytes)
        return self.upstream(nbytes) if self.upstream else None

    def deallocate(self, obj, nbytes: int) -> None:
        if self.on_deallocate:
            self.on_deallocate(nbytes)


def _cuda_device(device) -> Optional[torch.device]:
    """``device`` as a CUDA device, or None off a card."""
    try:
        if device is None:
            if not torch.cuda.is_available():
                return None
            return torch.device("cuda", torch.cuda.current_device())
        dev = torch.device(device)
        return dev if dev.type == "cuda" else None
    except Exception:
        return None


def _allocated(dev: Optional[torch.device]) -> int:
    """The allocator's live bytes on ``dev`` (0 off a card)."""
    if dev is None:
        return 0
    try:
        return int(torch.cuda.memory_stats(dev).get(
            "allocated_bytes.all.current", 0))
    except Exception:
        return 0


class ResourceMonitor:
    """Samples a device's allocated bytes on a background thread,
    attributing each sample to the innermost active range of the thread
    that entered the monitor, and writes a timeline (ref:
    mr/resource_monitor.hpp:42). That thread also takes a sample as it
    enters and as it leaves each range, so a range shorter than the
    period (the host side of a call is often a few milliseconds) still
    has its samples. ``samples`` holds (seconds since start, bytes,
    range); :meth:`peak_by_range` is the largest sample of each range.
    ``out`` may be None."""

    def __init__(self, out: Optional[TextIO] = None, period_s: float = 0.01,
                 device=None):
        self._out = out
        self._period = period_s
        self._device = device
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples: List[tuple] = []

    def _sample(self, tag: str) -> None:
        rec = (time.monotonic() - self._t0, _allocated(self._dev), tag)
        with self._lock:
            self.samples.append(rec)
            if self._out is not None:
                self._out.write(f"{rec[0]:.6f}\t{rec[1]}\t{rec[2]}\n")

    def _on_range(self, name: str) -> None:
        if threading.get_ident() == self._owner:
            self._sample(name)

    def _sample_loop(self):
        while True:
            # the range stack is thread-local: read the sampled thread's
            self._sample(nvtx.current_range(self._owner) or "")
            if self._stop.wait(self._period):
                break

    def peak_by_range(self) -> Dict[str, int]:
        """{range: the largest sampled bytes while it was innermost}."""
        out: Dict[str, int] = {}
        for _, nbytes, tag in list(self.samples):
            out[tag] = max(out.get(tag, 0), nbytes)
        return out

    def __enter__(self):
        self._owner = threading.get_ident()
        self._dev = _cuda_device(self._device)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        nvtx._range_hooks.append(self._on_range)
        self._thread = threading.Thread(target=self._sample_loop,
                                        daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        try:
            nvtx._range_hooks.remove(self._on_range)
        except ValueError:
            pass
        return False


def device_memory_stats(device=None) -> dict:
    """The caching allocator's statistics for a CUDA device
    (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``,
    ``.peak`` …); ``{}`` off a card."""
    dev = _cuda_device(device)
    if dev is None:
        return {}
    try:
        return dict(torch.cuda.memory_stats(dev))
    except Exception:
        return {}
