"""Fused L2 distance + packed group top-2 fold (K1, and K2 over an int8
database) — the port's hot step.

Counterpart of ``raft_tpu/ops/fused_l2_topk_pallas.py``. The TPU kernel
``fused_l2_group_topk_packed`` (``:1269``; its database-major forms
``_packed_db``/``_packed_dbuf`` compute the same outputs) becomes the
hand-written Hopper kernel in ``csrc/fused_l2_topk.cu``, and its int8
twins ``fused_l2_group_topk_packed_db_q8`` / ``_dbuf_q8`` (``:1465``,
``:1491``) become the same kernel templated on the streamed slice's type;
see that file for the design. This module holds both wrappers, their
plain PyTorch twins and the packing constants the certified KNN decodes
with.

The wrapper dispatches on the device of the tensors it is given: CPU
tensors take the twin, CUDA tensors launch the kernel (or raise). There is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build

_LANES = 128
_PACK_BITS = 8                   # default code width (see the reference)
_PBITS_MAX = 13                  # widest codes: value error 2^(13-23)
_PACK_PAD = float(2.0 ** 125)    # finite "never wins" sentinel

# kernel launches since import (or since a caller reset it): a run that
# reads it before and after shows the path went through the kernel
LAUNCHES = 0
# K2's launches, counted the same way
LAUNCHES_Q8 = 0

_FN = None
_FN_Q8 = None


def _check(x, y_hi, y_lo, yy_half, T: int, g: int, passes: int,
           pair: bool, pbits: int):
    Q, d = x.shape
    M = y_hi.shape[0]
    if T % _LANES:
        raise ValueError(f"T={T} must be a multiple of {_LANES}")
    if M % T or M == 0:
        raise ValueError(f"index rows M={M} must be a whole number of "
                         f"T={T} tiles")
    if y_hi.shape[1] != d or yy_half.shape != (M,):
        raise ValueError("fused_l2_group_topk_packed: operand shapes "
                         f"x {tuple(x.shape)}, y_hi {tuple(y_hi.shape)}, "
                         f"yy_half {tuple(yy_half.shape)} do not agree")
    if passes not in (1, 3):
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    if passes == 3 and (y_lo is None or y_lo.shape != y_hi.shape):
        raise ValueError("passes=3 needs y_lo shaped like y_hi")
    if not 0 < pbits <= _PBITS_MAX:
        raise ValueError(f"pbits={pbits} outside (0, {_PBITS_MAX}]")
    if g * (T // _LANES) > (1 << pbits):
        raise ValueError(
            f"packed group kernel: g*T/128 = {g * T // _LANES} exceeds "
            f"the {1 << pbits}-code packing envelope")
    if pair and (T // _LANES) % 2:
        raise ValueError(f"pair=True requires an even chunk count, got "
                         f"T/128 = {T // _LANES}")


def fused_l2_group_topk_packed(x, y_hi, y_lo, yy_half, *, T: int, g: int,
                               passes: int, pair: bool = False,
                               pbits: int = _PACK_BITS, xxh=None
                               ) -> Tuple[torch.Tensor, ...]:
    """Per (query, bucket) the two smallest and the third smallest packed
    half-scores ``(yy/2 − x·y) + xx/2``.

    x [Q, d] f32; y_hi (and y_lo at passes=3) [M, d] bf16 (the
    :func:`split_hi_lo` of the index); yy_half [M] f32 holding ‖y‖²/2, and
    ``_PACK_PAD`` on padded rows; xxh [Q] f32 query half-norms (None: 0).
    M is a whole number of T-row tiles; a bucket is (lane class, group of
    ``g`` tiles). Returns ``(a1p, a2p, a3p)``, each [Q, ceil(M/T/g)·128]
    f32, whose low ``pbits`` mantissa bits hold the within-group code
    ``tile_offset·(T/128) + chunk`` (a3p's code means nothing). ``pair``
    min-combines chunk pairs before the fold (reference ``:697``)."""
    global LAUNCHES
    _check(x, y_hi, y_lo, yy_half, T, g, passes, pair, pbits)
    if x.device.type == "cpu":
        return fused_l2_group_topk_packed_ref(
            x, y_hi, y_lo, yy_half, T=T, g=g, passes=passes, pair=pair,
            pbits=pbits, xxh=xxh)
    if x.device.type != "cuda":
        raise DeviceError(f"fused_l2_group_topk_packed: no kernel for "
                          f"device {x.device}")
    Q, d = x.shape
    M = y_hi.shape[0]
    if d % _LANES:
        raise ValueError(f"the Hopper kernel needs d % {_LANES} == 0 "
                         f"(knn_fused pads features), got d={d}")
    if xxh is None:
        xxh = torch.zeros((Q,), dtype=torch.float32, device=x.device)
    xxh = xxh.reshape(Q)
    if y_lo is None:
        y_lo = y_hi                  # never read at passes=1
    for name, t, dt in (("x", x, torch.float32),
                        ("y_hi", y_hi, torch.bfloat16),
                        ("y_lo", y_lo, torch.bfloat16),
                        ("yy_half", yy_half, torch.float32),
                        ("xxh", xxh, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_l2_group_topk_packed: {name} must be "
                             f"a contiguous {dt} tensor on {x.device}")
    S = -(-(M // T) // g) * _LANES
    outs = [torch.empty((Q, S), dtype=torch.float32, device=x.device)
            for _ in range(3)]
    if Q == 0:
        return tuple(outs)
    with torch.cuda.device(x.device):
        rc = _launcher()(
            x.data_ptr(), y_hi.data_ptr(), y_lo.data_ptr(),
            yy_half.data_ptr(), xxh.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), Q, M, d, T, g, passes,
            int(pair), pbits, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"fused_l2_group_topk_packed: launch failed "
                          f"with CUDA error {rc}")
    LAUNCHES += 1
    return tuple(outs)


def _launcher():
    global _FN
    if _FN is None:
        fn = _build.load("fused_l2_topk").fused_l2_group_topk_packed_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _pack(c: torch.Tensor, code, pbits: int) -> torch.Tensor:
    """Replace the low ``pbits`` mantissa bits of ``c`` by ``code``."""
    bits = c.view(torch.int32) & ~((1 << pbits) - 1)
    return (bits | code).view(torch.float32)


def _merge(cp, a1, a2, a3):
    """The reference's 5-op packed merge (``_merge_chunk_top2_packed``)."""
    b1 = torch.maximum(a1, cp)
    a1 = torch.minimum(a1, cp)
    b2 = torch.maximum(a2, b1)
    a2 = torch.minimum(a2, b1)
    a3 = torch.minimum(a3, b2)
    return a1, a2, a3


def fused_l2_group_topk_packed_ref(x, y_hi, y_lo, yy_half, *, T: int,
                                   g: int, passes: int, pair: bool = False,
                                   pbits: int = _PACK_BITS, xxh=None):
    """Plain PyTorch twin of :func:`fused_l2_group_topk_packed`: the
    same bf16-factor products summed in f32 by ``torch.matmul``, then the
    chunked, packed fold in the reference's order. The kernel's test
    oracle and the CPU path."""
    _check(x, y_hi, y_lo, yy_half, T, g, passes, pair, pbits)
    Q = x.shape[0]
    xhi = x.to(torch.bfloat16)
    s = xhi.float() @ y_hi.float().T
    if passes == 3:
        xlo = (x - xhi.float()).to(torch.bfloat16)
        s = s + xhi.float() @ y_lo.float().T
        s = s + xlo.float() @ y_hi.float().T
    c = yy_half[None, :] - s
    del s
    if xxh is not None:
        c = c + xxh.reshape(Q, 1)
    return _packed_fold(c, T, g, pair, pbits)


def _packed_fold(c, T: int, g: int, pair: bool, pbits: int):
    """The chunked, packed fold of the [Q, M] half-scores ``c`` in the
    reference's order (shared by both twins)."""
    Q, M = c.shape
    n_ch = T // _LANES
    n_groups = -(-(M // T) // g)
    pad = n_groups * g * T - M
    if pad:
        # a partial last group: sentinel chunks lose every comparison
        # against the _PACK_PAD initial state, as skipped chunks would
        c = torch.cat([c, c.new_full((Q, pad), _PACK_PAD)], dim=1)
    c = c.reshape(Q, n_groups, g * n_ch, _LANES)
    a1 = c.new_full((Q, n_groups, _LANES), _PACK_PAD)
    a2, a3 = a1.clone(), a1.clone()
    if pair:
        for r in range(0, g * n_ch, 2):
            c0, c1 = c[:, :, r], c[:, :, r + 1]
            mn = torch.minimum(c0, c1)
            a3 = torch.minimum(a3, torch.maximum(c0, c1))
            code = torch.where(mn == c1, r + 1, r).to(torch.int32)
            a1, a2, a3 = _merge(_pack(mn, code, pbits), a1, a2, a3)
    else:
        for r in range(g * n_ch):
            a1, a2, a3 = _merge(_pack(c[:, :, r].contiguous(), r, pbits),
                                a1, a2, a3)
    S = n_groups * _LANES
    return a1.reshape(Q, S), a2.reshape(Q, S), a3.reshape(Q, S)


# ---------------------------------------------------------------- K2 (int8)
def _check_q8(x, y_q, yy_half, scale, T: int, g: int, passes: int,
              pair: bool, pbits: int):
    Q, d = x.shape
    M = y_q.shape[0]
    if T % _LANES:
        raise ValueError(f"T={T} must be a multiple of {_LANES}")
    if M % (g * T) or M == 0:
        raise ValueError(f"int8 index rows M={M} must be a whole number "
                         f"of g·T = {g * T}-row groups")
    if y_q.dtype != torch.int8:
        raise ValueError(f"y_q must be int8, got {y_q.dtype}")
    if (y_q.shape[1] != d or yy_half.shape != (M,)
            or scale.shape != (M // (g * T),)):
        raise ValueError("fused_l2_group_topk_packed_q8: operand shapes "
                         f"x {tuple(x.shape)}, y_q {tuple(y_q.shape)}, "
                         f"yy_half {tuple(yy_half.shape)}, scale "
                         f"{tuple(scale.shape)} do not agree")
    # y_lo does not exist here: the passes / pair / envelope checks are K1's
    _check(x, y_q, y_q, yy_half, T, g, passes, pair, pbits)


def fused_l2_group_topk_packed_q8(x, y_q, yy_half, scale, *, T: int,
                                  g: int, passes: int, pair: bool = False,
                                  pbits: int = _PACK_BITS, xxh=None
                                  ) -> Tuple[torch.Tensor, ...]:
    """K2: :func:`fused_l2_group_topk_packed` over an int8 database.

    y_q [M, d] int8 is the per-group symmetric quantization of the
    streamed rows (M a whole number of g·T-row groups); scale [M/(g·T)]
    f32 holds one scale per group; yy_half [M] the dequantized rows'
    half-norms (``_PACK_PAD`` on pads). The contraction is bf16(x)·q (plus
    bf16(x − bf16(x))·q at passes=3) in f32, times the group's scale once
    the d-sum is done. Outputs, codes and ``pair`` are K1's."""
    global LAUNCHES_Q8
    _check_q8(x, y_q, yy_half, scale, T, g, passes, pair, pbits)
    if x.device.type == "cpu":
        return fused_l2_group_topk_packed_q8_ref(
            x, y_q, yy_half, scale, T=T, g=g, passes=passes, pair=pair,
            pbits=pbits, xxh=xxh)
    if x.device.type != "cuda":
        raise DeviceError(f"fused_l2_group_topk_packed_q8: no kernel for "
                          f"device {x.device}")
    Q, d = x.shape
    M = y_q.shape[0]
    if d % _LANES:
        raise ValueError(f"the Hopper kernel needs d % {_LANES} == 0 "
                         f"(knn_fused pads features), got d={d}")
    if xxh is None:
        xxh = torch.zeros((Q,), dtype=torch.float32, device=x.device)
    xxh = xxh.reshape(Q)
    for name, t, dt in (("x", x, torch.float32),
                        ("y_q", y_q, torch.int8),
                        ("yy_half", yy_half, torch.float32),
                        ("scale", scale, torch.float32),
                        ("xxh", xxh, torch.float32)):
        if t.dtype != dt or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"fused_l2_group_topk_packed_q8: {name} must "
                             f"be a contiguous {dt} tensor on {x.device}")
    S = M // (g * T) * _LANES
    outs = [torch.empty((Q, S), dtype=torch.float32, device=x.device)
            for _ in range(3)]
    if Q == 0:
        return tuple(outs)
    with torch.cuda.device(x.device):
        rc = _launcher_q8()(
            x.data_ptr(), y_q.data_ptr(), scale.data_ptr(),
            yy_half.data_ptr(), xxh.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(), Q, M, d, T, g, passes,
            int(pair), pbits, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"fused_l2_group_topk_packed_q8: launch failed "
                          f"with CUDA error {rc}")
    LAUNCHES_Q8 += 1
    return tuple(outs)


def _launcher_q8():
    global _FN_Q8
    if _FN_Q8 is None:
        fn = _build.load("fused_l2_topk").fused_l2_group_topk_packed_q8_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 8 + [i] * 8 + [p]
        fn.restype = ctypes.c_int
        _FN_Q8 = fn
    return _FN_Q8


def fused_l2_group_topk_packed_q8_ref(x, y_q, yy_half, scale, *, T: int,
                                      g: int, passes: int,
                                      pair: bool = False,
                                      pbits: int = _PACK_BITS, xxh=None):
    """Plain PyTorch twin of :func:`fused_l2_group_topk_packed_q8`:
    ``bf16(x)·q`` (+ the x-lo product at passes=3) by ``torch.matmul`` in
    f32, times the group's scale, then K1's packed fold. The kernel's test
    oracle and the CPU path."""
    _check_q8(x, y_q, yy_half, scale, T, g, passes, pair, pbits)
    Q = x.shape[0]
    xhi = x.to(torch.bfloat16)
    qf = y_q.float().T
    s = xhi.float() @ qf
    if passes == 3:
        xlo = (x - xhi.float()).to(torch.bfloat16)
        s += xlo.float() @ qf
    del qf
    s *= scale.repeat_interleave(g * T)[None, :]
    c = s.neg_().add_(yy_half[None, :])           # yy/2 − scale·(x·q)
    if xxh is not None:
        c += xxh.reshape(Q, 1)
    return _packed_fold(c, T, g, pair, pbits)


def split_hi_lo(y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 → bf16 hi + bf16 lo with y ≈ hi + lo, both rounded to nearest
    (the bf16x3 operand prep; the dropped lo·lo term is O(2⁻¹⁸·‖x‖‖y‖)).
    PyTorch runs the conversions as written, so the reference's
    optimization barrier has no counterpart here."""
    y = y.float()
    hi = y.to(torch.bfloat16)
    lo = (y - hi.float()).to(torch.bfloat16)
    return hi, lo
