"""Per-device handle of the PyTorch port.

(Counterpart of ``raft_tpu/core/resources.py:346`` ``DeviceResources`` and
``device_resources()`` at ``:413``; ref: core/device_resources.hpp.) PyTorch
owns allocation, so the handle holds only what the algorithms read: the
device, a seeded ``torch.Generator`` on it, the workspace budget that sizes
the streamed KNN tile, and (on a card) a CUDA stream of its own, the one a
serving engine's batcher dispatches on.

Device rule for every entry point of the port: ``device=None`` means the
device of the tensors passed in, or ``cuda`` when none is a tensor. Without
a CUDA device that raises :class:`DeviceError` — nothing runs quietly on the
CPU unless the caller passed ``device="cpu"`` or CPU tensors.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.error import DeviceError

# The certified KNN's f32 rescore and its certificate bound assume
# full-f32 products (knn_fused._err_bound_coeff*): TF32 keeps ~10 mantissa
# bits and would void both, so the port turns it off for matmuls and cuDNN
# alike the moment it is imported.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None, *tensors) -> torch.device:
    """The device an entry point runs on (see the module docstring)."""
    if device is None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                return t.device
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "no CUDA device is available; pass device='cpu' (or CPU "
            "tensors) to run the plain PyTorch path")
    return dev


def as_f32(a, device: torch.device) -> torch.Tensor:
    """``a`` (numpy, list or tensor) as a contiguous f32 tensor on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    a = np.asarray(a, dtype=np.float32)
    if not a.flags.writeable:      # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _is_f64(a) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == torch.float64
    return np.asarray(a).dtype == np.float64


def float_operands(device: torch.device, *arrays):
    """``arrays`` (numpy, lists or tensors; None passes through) as
    contiguous tensors on ``device``: all f64 when one of them is f64,
    else all f32 (the reference's accumulator rule with x64 on)."""
    dt = torch.float64 if any(_is_f64(a) for a in arrays
                              if a is not None) else torch.float32
    out = []
    for a in arrays:
        if a is not None and not isinstance(a, torch.Tensor):
            a = np.array(a, dtype=np.float64 if dt == torch.float64
                         else np.float32)
            a = torch.from_numpy(a)
        out.append(None if a is None
                   else a.to(device=device, dtype=dt).contiguous())
    return tuple(out)


class DeviceResources:
    """The concrete per-device handle.

    ``workspace_limit`` (bytes) bounds the [queries, tile] f32 scratch of
    the streamed sweeps; the default is a quarter of the card's memory, or
    1 GiB on the CPU (the reference's fallback)."""

    def __init__(self, device=None, seed: int = 0,
                 workspace_limit: Optional[int] = None):
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        if workspace_limit is None:
            workspace_limit = 1 << 30
            if self.device.type == "cuda":
                props = torch.cuda.get_device_properties(self.device)
                workspace_limit = props.total_memory // 4
        self.allocation_limit = int(workspace_limit)
        # the handle's stream (None on the CPU); entry points run on the
        # caller's current stream, a server enters this one to dispatch
        self.stream = (torch.cuda.Stream(device=self.device)
                       if self.device.type == "cuda" else None)

    def sync(self, value=None):
        """Wait for the device's queued work; returns ``value``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return value


_default_resources: Optional[DeviceResources] = None
_default_lock = threading.Lock()


def device_resources() -> DeviceResources:
    """Process-default handle on the CUDA device, created on first use
    (raises where there is none)."""
    global _default_resources
    with _default_lock:
        if _default_resources is None:
            _default_resources = DeviceResources()
        return _default_resources


def ensure_resources(res: Optional[DeviceResources]) -> DeviceResources:
    """``None`` means the process-default handle."""
    return res if res is not None else device_resources()


def input_device(res, *arrays, device=None) -> torch.device:
    """The device of an entry point that takes a handle: ``device`` when
    given, else the first tensor's among ``arrays``, else the handle's
    (the process-default handle's, on cuda, when ``res`` is None)."""
    if device is not None:
        return resolve_device(device)
    for a in arrays:
        if isinstance(a, torch.Tensor):
            return a.device
    return ensure_resources(res).device
