"""SDDMM (K7): wrapper, plain twin and launch count.

Counterpart of ``raft_tpu/ops/sddmm_pallas.py``. The TPU kernel
``sddmm_tiled`` (``:108``, ``pallas_call`` at ``:94``) becomes the
hand-written Hopper kernel in ``csrc/sddmm.cu``; see that file for the
design.

The contract (the reference's): the values of ``A @ B`` (A [m, d],
B [d, n], f32) at a :class:`raft_tpu_torch.sparse.tiled.TiledPairs`
structure's nonzeros, in the structure's original entry order. The TPU
needed the (row tile × column tile) buckets to form dense blocks on the
MXU; the kernel here computes one dot per entry, so it reads only the
structure's ``rows`` and ``cols`` and runs in entry order
(:func:`sddmm_entries`, which ``sparse.linalg.sddmm`` also calls on an
f32 COO/CSR structure on the card: no layout is needed). The kernel and
the twin sum each d-long dot in different orders: they agree to
``(d + 2)·2⁻²⁴·Σ_k |a_k·b_k|`` per entry.

The wrapper dispatches on the tensors' device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build

#: contraction depth envelope, the reference's (``sddmm_pallas.py:35``)
MAX_D = 512
#: gathered f32 elements one step of the twin may hold
_TWIN_ELEMS = 1 << 26

# kernel launches since import (or since a caller reset them)
LAUNCHES = 0

_FN = None


def _operands(tiled, A, B):
    dev = tiled.device
    A = torch.as_tensor(A).to(device=dev, dtype=torch.float32)
    B = torch.as_tensor(B).to(device=dev, dtype=torch.float32)
    m, n = tiled.shape
    if A.ndim != 2 or B.ndim != 2 or A.shape[0] != m or B.shape[1] != n \
            or A.shape[1] != B.shape[0]:
        raise ValueError(
            f"sddmm_tiled: need A [{m}, d] @ B [d, {n}], got "
            f"{tuple(A.shape)} @ {tuple(B.shape)}")
    d = A.shape[1]
    if d > MAX_D:
        raise NotImplementedError(
            f"sddmm_tiled targets d <= {MAX_D}; got {d}")
    return A, B


def sddmm_tiled(tiled, A, B) -> torch.Tensor:
    """Values of (A @ B) at ``tiled``'s nonzeros, in the structure's
    original entry order ([nnz] f32 on the layout's device)."""
    A, B = _operands(tiled, A, B)
    if A.device.type == "cpu":
        return sddmm_tiled_ref(tiled, A, B)
    return sddmm_entries(A, B, tiled.rows, tiled.cols)


def sddmm_entries(A, B, rows, cols, dst=None) -> torch.Tensor:
    """Launch K7 over the entries (rows[i], cols[i]) of CUDA f32 operands
    A [m, d] and B [d, n]: out[dst[i]] (out[i] without ``dst``) = A[rows[i]]
    · B[:, cols[i]]. The index arrays are int32 on A's device."""
    global LAUNCHES
    if A.device.type != "cuda":
        raise DeviceError(f"sddmm_tiled: no kernel for device {A.device}")
    if A.ndim != 2 or B.ndim != 2 or A.shape[1] != B.shape[0] \
            or A.dtype != torch.float32 or B.dtype != torch.float32:
        raise ValueError(f"sddmm_tiled: need f32 A [m, d] @ B [d, n], got "
                         f"{tuple(A.shape)} @ {tuple(B.shape)}")
    d = A.shape[1]
    dpad = -d % 4                         # float4 rows
    Bt = B.T
    if dpad:
        A = torch.nn.functional.pad(A, (0, dpad))
        Bt = torch.nn.functional.pad(Bt, (0, dpad))
    A, Bt = A.contiguous(), Bt.contiguous()
    nnz = rows.shape[0]
    out = torch.empty(nnz, dtype=torch.float32, device=A.device)
    if nnz == 0:
        return out
    for t in (rows, cols) + (() if dst is None else (dst,)):
        if t.device != A.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError("sddmm_tiled: index arrays must be contiguous "
                             f"int32 on {A.device}")
    with torch.cuda.device(A.device):
        rc = _launcher()(
            A.data_ptr(), Bt.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            None if dst is None else dst.data_ptr(), out.data_ptr(), nnz,
            (d + dpad) // 4, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"sddmm_tiled: launch failed with CUDA error {rc}")
    LAUNCHES += 1
    return out


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("sddmm").sddmm_launch
        p = ctypes.c_void_p
        fn.argtypes = [p] * 6 + [ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def sddmm_tiled_ref(tiled, A, B) -> torch.Tensor:
    """Plain PyTorch twin of :func:`sddmm_tiled`; see
    :func:`sddmm_entries_ref`."""
    A, B = _operands(tiled, A, B)
    return sddmm_entries_ref(A, B, tiled.rows, tiled.cols)


def sddmm_entries_ref(A, B, rows, cols) -> torch.Tensor:
    """Plain PyTorch twin of :func:`sddmm_entries` (without ``dst``): each
    entry's row of A and column of B gathered, their f32 dot, in entry
    order and in steps of ≤ 2²⁶ gathered elements. The CPU path and the
    kernel's on-card oracle."""
    Bt = B.T
    rows, cols = rows.long(), cols.long()
    nnz = rows.shape[0]
    out = torch.empty(nnz, dtype=torch.float32, device=A.device)
    step = max(1, _TWIN_ELEMS // max(A.shape[1], 1))
    for s0 in range(0, nnz, step):
        s = slice(s0, min(s0 + step, nnz))
        out[s] = (A[rows[s]] * Bt[cols[s]]).sum(1)
    return out
