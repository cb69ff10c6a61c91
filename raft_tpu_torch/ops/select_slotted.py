"""Packed slotted select (K3): wrapper, plain twin and launch count.

Counterpart of ``raft_tpu/ops/select_slotted_pallas.py``. The TPU kernel
``select_slot_topk_packed`` (``:67``, ``pallas_call`` at ``:88``) becomes
the hand-written Hopper kernel in ``csrc/select_slotted.cu``; see that
file for the design. It is K1's packed group fold without the
contraction: one streaming pass over the rows of v [B, L] f32 keeps, per
(row, lane class, group of ``tpg`` tiles of T columns), the two smallest
and the third smallest packed values. The certified selection built on it
is ``matrix.select_k_slotted``.

The contract is the reference's, except that L need not be a whole number
of tiles: columns past L are the reference's ``_PACK_PAD`` padding, which
the kernel skips and the twin pads (the outputs agree bit for bit), and
there is no row block (the reference's Bb is a TPU tile).

The wrapper dispatches on the tensor's device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.fused_l2_topk import (
    _LANES, _PACK_BITS, _PACK_PAD, _packed_fold)

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

_FN = None


def _check(v, T: int, tpg: int):
    if v.ndim != 2 or v.dtype != torch.float32:
        raise ValueError(f"select_slot_topk_packed: v must be [B, L] f32, "
                         f"got {tuple(v.shape)} {v.dtype}")
    if T <= 0 or T % _LANES or tpg < 1:
        raise ValueError(f"select_slot_topk_packed: T={T} must be a "
                         f"positive multiple of {_LANES} and tpg={tpg} ≥ 1")
    if tpg * (T // _LANES) > (1 << _PACK_BITS):
        raise ValueError("select_slot_topk_packed: packing envelope "
                         f"tpg·T/128 = {tpg * T // _LANES} > "
                         f"{1 << _PACK_BITS}")


def select_slot_topk_packed(v, T: int = 1024, tpg: int = 32
                            ) -> Tuple[torch.Tensor, ...]:
    """Per-(lane, tile-group) packed top-2 + 3rd-min of ``v`` [B, L] f32.

    Returns ``(a1p, a2p, a3p)``, each [B, G·128] f32 with G =
    ceil(ceil(L/T)/tpg), whose low 8 mantissa bits hold the in-group code
    (tile % tpg)·(T/128) + chunk; positions decode with
    ``distance.knn_fused.decode_packed_pool`` (a3p's code means
    nothing). |values| ≥ _PACK_PAD/4 (±inf, NaN) make NaN or sentinel
    slots, which fail the downstream certificate."""
    global LAUNCHES
    _check(v, T, tpg)
    if v.device.type == "cpu":
        return select_slot_topk_packed_ref(v, T=T, tpg=tpg)
    if v.device.type != "cuda":
        raise DeviceError(f"select_slot_topk_packed: no kernel for device "
                          f"{v.device}")
    if not v.is_contiguous():
        raise ValueError("select_slot_topk_packed: v must be contiguous")
    B, L = v.shape
    G = -(-(-(-L // T)) // tpg)
    if G > 65535:
        raise ValueError(f"select_slot_topk_packed: {G} groups exceed a "
                         f"grid's 65,535 (raise tpg or T)")
    outs = [torch.empty((B, G * _LANES), dtype=torch.float32,
                        device=v.device) for _ in range(3)]
    if B == 0 or L == 0:
        return tuple(outs)
    with torch.cuda.device(v.device):
        rc = _launcher()(v.data_ptr(), outs[0].data_ptr(),
                         outs[1].data_ptr(), outs[2].data_ptr(), B, L, T,
                         tpg, _PACK_BITS,
                         torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"select_slot_topk_packed: launch failed with "
                          f"CUDA error {rc}")
    LAUNCHES += 1
    return tuple(outs)


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("select_slotted").select_slot_topk_packed_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i, ctypes.c_longlong, i, i, i, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def select_slot_topk_packed_ref(v, T: int = 1024, tpg: int = 32):
    """Plain PyTorch twin of :func:`select_slot_topk_packed`: v padded with
    ``_PACK_PAD`` to whole tiles, then K1's packed fold in chunk order
    (the reference's merge network, NaN-propagating). The kernel's test
    oracle and the CPU path."""
    _check(v, T, tpg)
    B, L = v.shape
    pad = (-L) % T
    if pad:
        v = torch.cat([v, v.new_full((B, pad), _PACK_PAD)], dim=1)
    return _packed_fold(v, T, tpg, False, _PACK_BITS)
