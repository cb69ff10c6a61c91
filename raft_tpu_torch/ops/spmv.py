"""Tiled SpMV / SpMM (K6): wrappers, plain twins and launch counts.

Counterpart of ``raft_tpu/ops/spmv_pallas.py``. The TPU kernels
``spmv_tiled`` (``:160``, two ``pallas_call``s and an XLA row gather),
``spmv_pair_tiled`` (``:226``) and ``spmm_tiled`` (``:393``) become the
hand-written Hopper kernels in ``csrc/spmv.cu``; see that file for the
design.

The contract (the reference's): ``y = A @ x`` (``Y = A @ B`` for a dense
``B [n_cols, V]``) over the layouts of ``sparse/tiled.py``, in f32; rows
in row tiles that hold no chunk read 0. The kernels and the twins sum in
different orders (the kernels with atomics, in an order that changes from
run to run), so a row agrees to ``(nnz_i + 2)·2⁻²⁴·Σ_j |a_ij·x_j|``.

The wrappers dispatch on the tensors' device: CPU tensors take the twin,
CUDA tensors launch the kernel or raise. There is no fallback. What the
kernels read beside the reference's arrays is built once with the layout
(``sparse/tiled.py``): the work items K6a and K6c share
(``TiledELL.item_chunk0``, ``item_split``, ``zero_tiles``) and K6b's
packed slot stream (``TiledPairsSpmv.rowcol``).
"""

from __future__ import annotations

import ctypes

import torch

from raft_tpu_torch.core.error import DeviceError
from raft_tpu_torch.ops import _build

#: widest dense operand ``spmm_tiled`` takes, the reference's envelope
#: (``spmv_pallas.py:402``)
MAX_V = 512
#: shared memory of one SpMM block's [R, W·QP] tile: three blocks of 8
#: warps an SM at R = 256 and 64 columns
SPMM_SMEM = 64 * 1024
#: shared memory a block may use on the card (the pair kernel's x and y
#: tiles, (C + R)·4 bytes)
BLOCK_SMEM = 232448
#: gathered f32 elements one step of a twin may hold (bounds the twins'
#: scratch at the scale-22 graph's 10⁸ slots)
_TWIN_ELEMS = 1 << 26

# kernel launches since import (or since a caller reset them), one per
# wrapper call that launched its kernel
LAUNCHES_SPMV = 0
LAUNCHES_PAIR = 0
LAUNCHES_SPMM = 0

_FNS = {}


def _f32_on(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device,
                                 dtype=torch.float32).contiguous()


def _check_x(n_cols: int, x: torch.Tensor, name: str):
    if x.ndim != 1 or x.shape[0] != n_cols:
        raise ValueError(f"{name}: x must be [{n_cols}], got "
                         f"{tuple(x.shape)}")


def spmv_tiled(tiled, x) -> torch.Tensor:
    """y = A @ x for a :class:`raft_tpu_torch.sparse.tiled.TiledELL`
    (K6a). Returns [n_rows] f32 on the layout's device."""
    global LAUNCHES_SPMV
    x = _f32_on(x, tiled.device)
    _check_x(tiled.shape[1], x, "spmv_tiled")
    if x.device.type == "cpu":
        return spmv_tiled_ref(tiled, x)
    for a in (tiled.vals, tiled.col_local, tiled.row_local):
        if a.data_ptr() % 16:
            raise ValueError("spmv_tiled: vals, col_local and row_local "
                             "must be 16-byte aligned (the kernel's vector "
                             "loads)")
    # whole row tiles are stored by their one item, as in spmm_tiled
    y = torch.empty(tiled.n_row_tiles * tiled.R, dtype=torch.float32,
                    device=x.device)
    if tiled.zero_tiles.numel():
        y.view(tiled.n_row_tiles, tiled.R).index_fill_(0, tiled.zero_tiles,
                                                       0.0)
    _launch("spmv_tiled_launch", [
        tiled.vals, tiled.col_local, tiled.chunk_col_tile, tiled.perm_rows,
        tiled.row_local, tiled.chunk_row_tile, tiled.item_chunk0,
        tiled.item_split, x, y],
        [tiled.n_items, tiled.E, tiled.C, tiled.R,
         tiled.n_chunks * tiled.E // 8])
    LAUNCHES_SPMV += 1
    return y[:tiled.shape[0]]


def _check_pairs(t):
    """The pair kernel's envelope: 16-bit row and column locals
    (``t.rowcol``) and the x and y tiles in one block's shared memory. The
    CPU twin has no such limit."""
    p = t.pairs
    if t.rowcol is None:
        raise ValueError(
            f"spmv_pair_tiled: R={p.R}, C={p.C}: the kernel reads row_local "
            f"and col_local in 16 bits each (R <= 65535, C <= 65536)")
    if (p.R + p.C) * 4 > BLOCK_SMEM:
        raise ValueError(
            f"spmv_pair_tiled: R={p.R}, C={p.C}: the x and y tiles need "
            f"{(p.R + p.C) * 4} bytes of shared memory, more than a "
            f"block's {BLOCK_SMEM}")


def spmv_pair_tiled(t, x) -> torch.Tensor:
    """y = A @ x for a :class:`raft_tpu_torch.sparse.tiled.TiledPairsSpmv`
    (K6b): gather, multiply and scatter in one pass per chunk."""
    global LAUNCHES_PAIR
    p = t.pairs
    x = _f32_on(x, t.device)
    _check_x(p.shape[1], x, "spmv_pair_tiled")
    if x.device.type == "cpu":
        return spmv_pair_tiled_ref(t, x)
    _check_pairs(t)
    y = torch.zeros(p.shape[0], dtype=torch.float32, device=x.device)
    if p.m_chunks == 0:
        return y
    for a in (t.vals, t.rowcol):
        if a.data_ptr() % 16:
            raise ValueError("spmv_pair_tiled: vals and rowcol must be "
                             "16-byte aligned (the kernel's vector loads)")
    _launch("spmv_pair_tiled_launch", [
        t.vals, t.rowcol, p.chunk_row_tile, p.chunk_col_tile, x, y],
        [p.m_chunks, p.E, p.C, p.R, p.shape[0], p.shape[1]])
    LAUNCHES_PAIR += 1
    return y


def _check_B(tiled, B: torch.Tensor) -> int:
    n_cols = tiled.shape[1]
    if B.ndim != 2 or B.shape[0] != n_cols:
        raise ValueError(f"spmm_tiled: B must be [{n_cols}, V]")
    V = B.shape[1]
    if V > MAX_V:
        raise NotImplementedError(
            f"spmm_tiled targets V <= {MAX_V} dense columns; got {V} — "
            f"chunk B column-wise or use the COO/CSR path")
    return V


def spmm_geometry(R: int, V: int, vector: bool):
    """(VC, W, QP) of one SpMM block: VC columns of B, W = 4 (float4
    lanes) when ``vector`` and V % 4 == 0 else 1, QP lanes a slot (a power
    of two, W·QP ≥ VC); its [R, W·QP] f32 tile within :data:`SPMM_SMEM`."""
    W = 4 if vector and V % 4 == 0 else 1
    VC = max(1, min(V, 64 if W == 4 else 32))    # ≤ 16 or 32 lanes a slot
    QP = 1 << (-(-VC // W) - 1).bit_length()
    while R * W * QP * 4 > SPMM_SMEM and QP > 1:
        QP //= 2
        VC = min(VC, W * QP)
    if R * W * QP * 4 > SPMM_SMEM:
        raise ValueError(f"spmm_tiled: R={R} leaves no shared memory for "
                         f"the accumulator tile")
    return VC, W, QP


def spmm_tiled(tiled, B) -> torch.Tensor:
    """Y = A @ B for a TiledELL and dense B [n_cols, V ≤ 512] (K6c).
    Returns [n_rows, V] f32 on the layout's device."""
    global LAUNCHES_SPMM
    B = _f32_on(B, tiled.device)
    V = _check_B(tiled, B)
    if B.device.type == "cpu":
        return spmm_tiled_ref(tiled, B)
    n_rows, R = tiled.shape[0], tiled.R
    if V == 0:
        return torch.zeros((n_rows, 0), dtype=torch.float32,
                           device=B.device)
    # whole row tiles are stored by their one item: only the row tiles of
    # ``zero_tiles`` (split or unvisited) start from zeros
    Y = torch.empty((tiled.n_row_tiles * R, V), dtype=torch.float32,
                    device=B.device)
    if tiled.zero_tiles.numel():
        Y.view(tiled.n_row_tiles, R * V).index_fill_(0, tiled.zero_tiles,
                                                      0.0)
    VC, W, QP = spmm_geometry(R, V, B.data_ptr() % 16 == 0)
    _launch("spmm_tiled_launch", [
        tiled.vals, tiled.col_local, tiled.chunk_col_tile, tiled.perm_rows,
        tiled.row_local, tiled.chunk_row_tile, tiled.item_chunk0,
        tiled.item_split, B, Y],
        [tiled.n_items, tiled.E, tiled.C, R, V, VC, W, QP, Y.shape[0],
         tiled.n_chunks * tiled.E // 8])
    LAUNCHES_SPMM += 1
    return Y[:n_rows]


def _launch(name: str, tensors, ints):
    dev = tensors[-1].device
    if dev.type != "cuda":
        raise DeviceError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.dtype not in (
                torch.float32, torch.int32):
            raise ValueError(f"{name}: every operand must be a contiguous "
                             f"f32/int32 tensor on {dev}")
    with torch.cuda.device(dev):
        rc = _launcher(name, len(tensors), len(ints))(
            *(t.data_ptr() for t in tensors), *(int(i) for i in ints),
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise DeviceError(f"{name}: launch failed with CUDA error {rc}")


def _launcher(name: str, n_ptr: int, n_int: int):
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("spmv"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * n_ptr + [i] * n_int + [p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


# ------------------------------------------------------------ plain twins
def _ell_ref(t, B: torch.Tensor) -> torch.Tensor:
    """Y = A @ B over a TiledELL's arrays in scatter order: each slot's
    gather slot through ``perm_rows``, its value times B's row, added into
    its output row with ``index_add_`` (pads into a dropped row), in steps
    of ≤ 2²⁶ gathered elements."""
    dev = B.device
    V = B.shape[1]
    R, E = t.R, t.E
    dump = t.n_row_tiles * R
    Y = torch.zeros((dump + 1, V), dtype=torch.float32, device=dev)
    rl = t.row_local.reshape(-1)
    vals = t.vals.reshape(-1)
    cl = t.col_local.reshape(-1)
    zero_row = t.n_chunks * E // 8
    m_slots = rl.shape[0]
    step = max(E, _TWIN_ELEMS // max(V, 1) // E * E)
    for s0 in range(0, m_slots, step):
        s = torch.arange(s0, min(s0 + step, m_slots), device=dev)
        pr = t.perm_rows[s // 8].long()
        real = (pr < zero_row) & (rl[s] < R)
        g = torch.where(real, pr * 8 + s % 8, 0)
        col = t.chunk_col_tile[g // E].long() * t.C + cl[g]
        contrib = torch.where(real[:, None], vals[g][:, None] * B[col], 0.0)
        row = torch.where(real, t.chunk_row_tile[s // E].long() * R + rl[s],
                          dump)
        Y.index_add_(0, row, contrib)
    return Y[:t.shape[0]]


def spmv_tiled_ref(tiled, x) -> torch.Tensor:
    """Plain PyTorch twin of :func:`spmv_tiled`: the CPU path and the
    kernel's on-card oracle."""
    x = _f32_on(x, tiled.device)
    _check_x(tiled.shape[1], x, "spmv_tiled")
    return _ell_ref(tiled, x[:, None])[:, 0]


def spmm_tiled_ref(tiled, B) -> torch.Tensor:
    """Plain PyTorch twin of :func:`spmm_tiled` (f32 products and sums;
    the reference runs its one-hot selects at bf16×3, ≈ 2⁻¹⁶ relative)."""
    B = _f32_on(B, tiled.device)
    _check_B(tiled, B)
    return _ell_ref(tiled, B)


def spmv_pair_tiled_ref(t, x) -> torch.Tensor:
    """Plain PyTorch twin of :func:`spmv_pair_tiled`."""
    p = t.pairs
    x = _f32_on(x, t.device)
    _check_x(p.shape[1], x, "spmv_pair_tiled")
    dev = x.device
    dump = p.n_row_tiles * p.R
    y = torch.zeros(dump + 1, dtype=torch.float32, device=dev)
    rl = p.row_local.reshape(-1)
    cl = p.col_local.reshape(-1)
    vals = t.vals.reshape(-1)
    n = rl.shape[0]
    for s0 in range(0, n, _TWIN_ELEMS):
        s = torch.arange(s0, min(s0 + _TWIN_ELEMS, n), device=dev)
        c = s // p.E
        real = rl[s] < p.R
        col = torch.where(real, p.chunk_col_tile[c].long() * p.C + cl[s], 0)
        contrib = torch.where(real, vals[s] * x[col], 0.0)
        row = torch.where(real, p.chunk_row_tile[c].long() * p.R + rl[s],
                          dump)
        y.index_add_(0, row, contrib)
    return y[:p.shape[0]]
