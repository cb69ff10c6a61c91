"""Blocked histogram (K9): wrapper, plain twin and launch count.

Counterpart of ``raft_tpu/ops/histogram_pallas.py``. The TPU kernel
``histogram_blocked`` (``:47``, ``pallas_call`` at ``:61``) becomes the
hand-written Hopper kernel in ``csrc/histogram.cu`` in two forms, chosen
by :func:`k9_form`; see that file for the design.

The contract (the reference's): counts [n_bins, batch] int32 from bins
[n, batch] int32, entries outside ``[0, n_bins)`` ignored (the reference
pads its row blocks with −1). Counts are integers, so the kernel, the
twin and any other way of counting agree to the bit.

The wrapper dispatches on the tensors' device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build

#: the most bins the kernel counts: one column of counters must fit in a
#: block's 48 KB of shared memory
MAX_BINS = 12288
#: the most counters (n_bins × batch) for which every lane of a block
#: keeps its own (the small-counter form: 8 warps × 32 lanes × 64 × 4 B =
#: 64 KB of shared memory a block)
LANE_COUNTERS = 64
#: one-hot elements one step of the twin may hold
_TWIN_ELEMS = 1 << 24

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0

_FN = None
# the SM count of each device, read once
_SMS = {}


def k9_form(batch: int, n_bins: int) -> str:
    """The form K9 takes for ``n_bins`` bins of ``batch`` columns (the
    rule ``histogram_form`` in ``csrc/histogram.cu`` applies): ``"lanes"``
    where the block's n_bins·batch counters are few enough for every lane
    to keep its own (no atomic a count), else ``"blocked"`` (shared
    atomics on column slabs, a copy a warp where they fit)."""
    return "lanes" if n_bins * batch <= LANE_COUNTERS else "blocked"


def _operands(bins, n_bins: int):
    bins = torch.as_tensor(bins)
    if bins.ndim != 2 or bins.dtype.is_floating_point or n_bins < 1:
        raise ValueError(f"histogram_blocked: need integer bins [n, batch] "
                         f"and n_bins ≥ 1, got {tuple(bins.shape)} "
                         f"{bins.dtype}, n_bins={n_bins}")
    return bins.to(torch.int32).contiguous()


def histogram_blocked(bins, n_bins: int) -> torch.Tensor:
    """counts [n_bins, batch] int32 of bins [n, batch] (entries outside
    ``[0, n_bins)`` ignored). On CUDA tensors K9 runs; on CPU tensors the
    twin."""
    global LAUNCHES
    bins = _operands(bins, n_bins)
    if bins.device.type == "cpu":
        return histogram_blocked_ref(bins, n_bins)
    if bins.device.type != "cuda":
        raise DeviceError(f"histogram_blocked: no kernel for device "
                          f"{bins.device}")
    if n_bins > MAX_BINS:
        raise NotImplementedError(f"histogram_blocked counts at most "
                                  f"{MAX_BINS} bins; got {n_bins}")
    n, batch = bins.shape
    if n == 0 or batch == 0:
        return torch.zeros((n_bins, batch), dtype=torch.int32,
                           device=bins.device)
    # the launch zeroes the output on the stream before the kernel
    out = torch.empty((n_bins, batch), dtype=torch.int32, device=bins.device)
    dev = bins.device.index
    n_sm = _SMS.get(dev)
    if n_sm is None:
        n_sm = _SMS[dev] = torch.cuda.get_device_properties(
            bins.device).multi_processor_count
    with torch.cuda.device(bins.device):
        rc = _launcher()(bins.data_ptr(), out.data_ptr(), n, batch, n_bins,
                         n_sm, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"histogram_blocked: launch failed with CUDA "
                          f"error {rc}")
    LAUNCHES += 1
    return out


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("histogram").histogram_launch
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, vp]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def histogram_blocked_ref(bins, n_bins: int) -> torch.Tensor:
    """Plain PyTorch twin of :func:`histogram_blocked`, the reference
    kernel's arithmetic: row blocks folded as one-hot compares against the
    bin ids into an int32 [n_bins, batch] accumulator, ≤ 2²⁴ one-hot
    elements a step. The CPU path and the kernel's on-card oracle."""
    bins = _operands(bins, n_bins)
    n, batch = bins.shape
    counts = torch.zeros((n_bins, batch), dtype=torch.int32,
                         device=bins.device)
    ids = torch.arange(n_bins, dtype=torch.int32,
                       device=bins.device)[:, None, None]
    step = max(1, _TWIN_ELEMS // max(1, n_bins * batch))
    for r0 in range(0, n, step):
        counts += (bins[None, r0:r0 + step] == ids).sum(1, dtype=torch.int32)
    return counts
