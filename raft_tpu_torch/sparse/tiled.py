"""Tiled sparse layouts of the port: the operands of the SpMV/SpMM (K6)
and SDDMM (K7) kernels.

(Counterpart of ``raft_tpu/sparse/tiled.py``; ref: the cusparse SpMV/SpMM
surface cpp/include/raft/sparse/detail/cusparse_wrappers.h and the Lanczos
matvec dispatch sparse/solver/detail/lanczos.cuh:263-271.)

:class:`TiledELL` (built by :func:`tile_csr`): nonzeros grouped into
(column tile, row tile) buckets, each padded to a multiple of 8 slots.

- Gather stream, column-tile-major, each column tile's buckets padded
  together to a multiple of ``E``: ``vals`` and ``col_local`` (col % C)
  as ``[n_chunks, E]``, and ``chunk_col_tile [n_chunks]``. Pad slots hold
  value 0. Within a bucket the entries keep their input order.
- Scatter stream, row-tile-major (column-tile-minor), the same 8-slot
  rows, each row tile's buckets padded together to a multiple of ``E``:
  ``row_local [m_chunks, E]`` (row % R, pad = R) and ``chunk_row_tile``.
- ``perm_rows [m_chunks·E/8]``: for each 8-slot row of the scatter stream,
  the 8-slot row of the gather stream it holds; ``n_chunks·E/8`` (one past
  the gather stream) marks a pad row.
- ``visited_row_tiles [n_row_tiles]``: row tiles that hold a chunk.
- The SpMM kernel's (K6c) work items, built once with the layout by
  :func:`spmm_items` (the port's own; the reference has no such field):
  ``item_chunk0 [n_items + 1]``, each item a run of at most
  :data:`ITEM_CHUNKS` consecutive chunks of one row tile (a row tile with
  more chunks splits evenly); ``item_split [n_items]``, 1 where the
  item's row tile is split over several items; ``zero_tiles``, the row
  tiles that no item covers whole (the unvisited and the split ones).

:class:`TiledPairs` (built by :func:`tile_pairs`): a sparsity structure
bucketed by (row tile, column tile), each bucket padded to a multiple of
``E``, entries sorted by (row, col) inside it; ``pos [nnz]`` maps each
original entry to its slot. :class:`TiledPairsSpmv` adds the values in slot
order (:func:`tile_csr_pairs`) and, for the pair SpMV kernel (K6b), each
slot's ``row_local << 16 | col_local`` in one int32 (``rowcol``, built
once beside the reference's arrays, which K7's parity and ``pos`` keep
using). The SDDMM kernel computes one dot per entry and reads only the
structure's ``rows`` and ``cols`` (entry order); the buckets are the TPU
kernel's blocks, kept for parity and for K6b.

The layout pass is written once, in torch, and runs on the device that
holds the matrix: on the card the layout is built there (the reference's
``tile_csr_device``), and on the CPU it produces arrays bit-identical to
the reference's ``impl="numpy"`` pass. Unlike the reference's jitted pass,
it needs no static worst-case buffer sizes (``tiled.py:526-531``): the
true sizes are read once. The reference's legacy scalar-``perm`` C++ pass
(``impl="native"``) is not ported and raises; its persistent plan cache
(``raft_tpu/sparse/plan_cache.py``) is not ported either: every call lays
the matrix out anew.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import resolve_device
from raft_tpu_torch.core.sparse_types import COOMatrix, CSRMatrix, to_device
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point

_log = logging.getLogger(__name__)

#: most chunks one SpMM (K6c) work item takes: R-MAT's hub row tiles hold
#: hundreds of chunks and split over several blocks (8 and 32 ran within
#: 2% of 16 on the scale-22 graph, PERF.md §6)
ITEM_CHUNKS = 16


def _arr(obj, name: str, device, dtype) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(getattr(obj, name)))
    return torch.from_numpy(a.copy()).to(device=device, dtype=dtype)


@dataclasses.dataclass
class TiledELL:
    """Tiled-ELL layout of one sparse matrix (see the module doc)."""

    shape: Tuple[int, int]
    C: int                              # column tile width (x tile)
    R: int                              # row tile width (y tile)
    E: int                              # chunk length
    vals: torch.Tensor                  # [n_chunks, E] f32
    col_local: torch.Tensor             # [n_chunks, E] int32 in [0, C)
    chunk_col_tile: torch.Tensor        # [n_chunks] int32
    perm_rows: torch.Tensor             # [m_chunks·E/8] int32
    row_local: torch.Tensor             # [m_chunks, E] int32, pad = R
    chunk_row_tile: torch.Tensor        # [m_chunks] int32
    visited_row_tiles: torch.Tensor     # [n_row_tiles] bool
    n_col_tiles: int
    n_row_tiles: int
    # K6c's work items (see spmm_items), built from chunk_row_tile when
    # not given
    item_chunk0: Optional[torch.Tensor] = None   # [n_items + 1] int32
    item_split: Optional[torch.Tensor] = None    # [n_items] int32
    zero_tiles: Optional[torch.Tensor] = None    # [*] int64

    def __post_init__(self):
        if self.item_chunk0 is None:
            self.item_chunk0, self.item_split, self.zero_tiles = spmm_items(
                self.chunk_row_tile, self.n_row_tiles)

    @property
    def n_items(self) -> int:
        return self.item_split.shape[0]

    @property
    def n_chunks(self) -> int:
        return self.vals.shape[0]

    @property
    def m_chunks(self) -> int:
        return self.row_local.shape[0]

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @classmethod
    def from_numpy(cls, t, device=None) -> "TiledELL":
        """The carry-across: the reference's ``TiledELL`` (any object with
        its fields as arrays) as the port's layout on ``device``."""
        if getattr(t, "perm_rows", None) is None:
            raise NotImplementedError(
                "TiledELL.from_numpy: the legacy scalar-perm layout (the "
                "reference's impl='native') is not ported")
        dev = resolve_device(device)
        i32 = torch.int32
        return cls(
            shape=tuple(int(s) for s in t.shape), C=int(t.C), R=int(t.R),
            E=int(t.E), vals=_arr(t, "vals", dev, torch.float32),
            col_local=_arr(t, "col_local", dev, i32),
            chunk_col_tile=_arr(t, "chunk_col_tile", dev, i32),
            perm_rows=_arr(t, "perm_rows", dev, i32),
            row_local=_arr(t, "row_local", dev, i32),
            chunk_row_tile=_arr(t, "chunk_row_tile", dev, i32),
            visited_row_tiles=_arr(t, "visited_row_tiles", dev, torch.bool),
            n_col_tiles=int(t.n_col_tiles), n_row_tiles=int(t.n_row_tiles))


@dataclasses.dataclass
class TiledPairs:
    """(row tile × col tile)-bucketed layout of a sparsity structure, the
    operand of the SDDMM kernel (see the module doc)."""

    shape: Tuple[int, int]
    R: int
    C: int
    E: int
    row_local: torch.Tensor             # [m_chunks, E] int32, pad = R
    col_local: torch.Tensor             # [m_chunks, E] int32, pad = 0
    chunk_row_tile: torch.Tensor        # [m_chunks] int32
    chunk_col_tile: torch.Tensor        # [m_chunks] int32
    pos: torch.Tensor                   # [nnz] int32 into slot order
    rows: torch.Tensor                  # [nnz] int32 (original structure)
    cols: torch.Tensor                  # [nnz] int32
    n_row_tiles: int
    n_col_tiles: int

    @property
    def nnz(self) -> int:
        return self.rows.shape[0]

    @property
    def m_chunks(self) -> int:
        return self.row_local.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_local.device

    @classmethod
    def from_numpy(cls, t, device=None) -> "TiledPairs":
        """The carry-across of the reference's ``TiledPairs``."""
        dev = resolve_device(device)
        i32 = torch.int32
        return cls(
            shape=tuple(int(s) for s in t.shape), R=int(t.R), C=int(t.C),
            E=int(t.E), row_local=_arr(t, "row_local", dev, i32),
            col_local=_arr(t, "col_local", dev, i32),
            chunk_row_tile=_arr(t, "chunk_row_tile", dev, i32),
            chunk_col_tile=_arr(t, "chunk_col_tile", dev, i32),
            pos=_arr(t, "pos", dev, i32), rows=_arr(t, "rows", dev, i32),
            cols=_arr(t, "cols", dev, i32), n_row_tiles=int(t.n_row_tiles),
            n_col_tiles=int(t.n_col_tiles))


@dataclasses.dataclass
class TiledPairsSpmv:
    """Pair-tiled SpMV operand: a :class:`TiledPairs` layout, the matrix
    values in slot order ``vals [m_chunks, E]`` (pads 0; the reference
    keeps ``[m_chunks, 1, E]``) and the visited row tiles. Build with
    :func:`tile_csr_pairs`."""

    pairs: TiledPairs
    vals: torch.Tensor
    visited: torch.Tensor
    # [m_chunks, E] int32 row_local << 16 | col_local (see pack_rowcol),
    # built from ``pairs`` when not given; None where the locals do not
    # fit 16 bits
    rowcol: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.rowcol is None:
            self.rowcol = pack_rowcol(self.pairs)

    @property
    def shape(self):
        return self.pairs.shape

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @classmethod
    def from_numpy(cls, t, device=None) -> "TiledPairsSpmv":
        """The carry-across of the reference's ``TiledPairsSpmv``."""
        pairs = TiledPairs.from_numpy(t.pairs, device)
        dev = pairs.device
        return cls(pairs=pairs,
                   vals=_arr(t, "vals", dev, torch.float32).reshape(
                       pairs.m_chunks, pairs.E),
                   visited=_arr(t, "visited", dev, torch.bool))


def spmm_items(chunk_row_tile: torch.Tensor, n_row_tiles: int,
               cap: int = ITEM_CHUNKS):
    """The SpMM kernel's work items over a row-tile-major scatter stream
    (``chunk_row_tile`` nondecreasing): each visited row tile's chunks cut
    evenly into ⌈n / cap⌉ runs of consecutive chunks. Returns
    ``item_chunk0`` ([n_items + 1] int32, the first chunk of each item and
    ``m_chunks`` last), ``item_split`` ([n_items] int32, 1 where the row
    tile has several items) and ``zero_tiles`` (int64, the row tiles with
    no item that covers them whole, in order)."""
    dev = chunk_row_tile.device
    crt = chunk_row_tile.long()
    tiles, counts = torch.unique_consecutive(crt, return_counts=True)
    if tiles.shape[0] > 1 and not bool((tiles[1:] > tiles[:-1]).all()):
        raise ValueError("spmm_items: the scatter stream is not "
                         "row-tile-major (chunk_row_tile decreases)")
    n_it = (counts + cap - 1) // cap
    total = int(n_it.sum())
    tile_of = _ids(n_it, total)
    k = torch.arange(total, device=dev) - _excl(n_it)[tile_of]
    start = _excl(counts)[tile_of] + k * counts[tile_of] // n_it[tile_of]
    item_chunk0 = torch.cat([start, counts.sum().reshape(1)]).to(torch.int32)
    item_split = (n_it > 1)[tile_of].to(torch.int32)
    whole = torch.zeros(n_row_tiles, dtype=torch.bool, device=dev)
    whole[tiles[n_it == 1]] = True
    return item_chunk0, item_split, torch.nonzero(~whole).squeeze(1)


def pack_rowcol(p: TiledPairs) -> Optional[torch.Tensor]:
    """The pair SpMV kernel's slot stream: ``row_local << 16 | col_local``
    of every slot as one int32 (pads ``R << 16``), or None where R >
    65535 or C > 65536 (the locals do not fit 16 bits)."""
    if p.R > 0xFFFF or p.C > 0x10000:
        return None
    v = (p.row_local.long() << 16) | p.col_local.long()
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _checked_coo_parts(A, C: int, R: int, E: int, name: str, device):
    """Alignment check, (rows, cols, f32 values, shape) on the device, and
    the id-range check: the reference's validation, in its order and with
    its messages (``tiled.py:161``)."""
    if E % 512 or C % 128 or R % 8:
        raise ValueError(f"{name}: need E % 512 == 0, C % 128 == 0, "
                         f"R % 8 == 0 (kernel fold/tile alignment)")
    if not isinstance(A, (CSRMatrix, COOMatrix)):
        raise TypeError(f"{name}: expected sparse matrix, got {type(A)}")
    A = to_device(A, device)
    if isinstance(A, CSRMatrix):
        rows, cols = A.row_ids(), A.indices
    else:
        rows, cols = A.rows, A.cols
    shape = A.shape
    if rows.shape[0] and bool(
            (rows.min() < 0) | (cols.min() < 0) | (rows.max() >= shape[0])
            | (cols.max() >= shape[1])):
        raise ValueError(
            f"{name}: row/col ids out of range for shape {shape}")
    return rows.long(), cols.long(), A.values.to(torch.float32), shape


def _excl(a: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative sum (int64)."""
    out = torch.zeros_like(a)
    if a.shape[0] > 1:
        out[1:] = torch.cumsum(a[:-1], 0)
    return out


def _ids(counts: torch.Tensor, total: int) -> torch.Tensor:
    """Group id of each of ``total`` members, ``counts[g]`` per group."""
    return torch.repeat_interleave(
        torch.arange(counts.shape[0], device=counts.device), counts,
        output_size=total)


@instrument("sparse.tile_csr")
def tile_csr(A, C: int = 512, R: int = 256, E: int = 2048,
             impl: str = "auto", device=None) -> TiledELL:
    """Convert a CSR/COO matrix to the tiled-ELL layout, on the device
    that holds it (see the module doc). ``impl``: "auto", "device" and
    "numpy" all run the one torch pass; "native" (the reference's legacy
    scalar-perm C++ layout) is not ported."""
    fault_point("tile_csr")
    if impl not in ("auto", "device", "numpy", "native"):
        raise ValueError(f"tile_csr: impl must be 'auto', 'device', "
                         f"'numpy' or 'native', got {impl!r}")
    if impl == "native":
        raise NotImplementedError(
            "tile_csr: impl='native' (the legacy scalar-perm C++ layout "
            "pass of raft_tpu/native) is not ported; use the default v2 "
            "layout")
    rows, cols, vals, shape = _checked_coo_parts(A, C, R, E, "tile_csr",
                                                 device)
    return _tile_csr_torch(rows, cols, vals, shape, C, R, E)


def _tile_csr_torch(r64, c64, vals, shape, C: int, R: int,
                    E: int) -> TiledELL:
    dev = r64.device
    i32 = torch.int32
    n_ct = max(1, -(-shape[1] // C))
    n_rt = max(1, -(-shape[0] // R))
    nnz = r64.shape[0]
    if nnz == 0:                                 # the reference's empty form
        return TiledELL(
            shape=shape, C=C, R=R, E=E,
            vals=torch.zeros((1, E), dtype=torch.float32, device=dev),
            col_local=torch.zeros((1, E), dtype=i32, device=dev),
            chunk_col_tile=torch.zeros(1, dtype=i32, device=dev),
            perm_rows=torch.full((E // 8,), E // 8, dtype=i32, device=dev),
            row_local=torch.full((1, E), R, dtype=i32, device=dev),
            chunk_row_tile=torch.zeros(1, dtype=i32, device=dev),
            visited_row_tiles=torch.zeros(n_rt, dtype=torch.bool,
                                          device=dev),
            n_col_tiles=n_ct, n_row_tiles=n_rt)

    # buckets (col tile, row tile), ct-major; a stable sort keeps the
    # input order inside a bucket
    bucket = (c64 // C) * n_rt + r64 // R
    bsorted, order_g = torch.sort(bucket, stable=True)
    del bucket
    ub, counts = torch.unique_consecutive(bsorted, return_counts=True)
    del bsorted
    nb = ub.shape[0]
    padded = (counts + 7) // 8 * 8               # 8-aligned bucket sizes
    b_off8 = _excl(padded)
    bidx = _ids(counts, nnz)                     # bucket of each element
    within = torch.arange(nnz, device=dev) - _excl(counts)[bidx]

    # gather stream: each col tile's buckets padded together to E
    b_ct = ub // n_rt
    grp_ids, grp_nb = torch.unique_consecutive(b_ct, return_counts=True)
    grp_of_b = _ids(grp_nb, nb)
    grp_sizes = torch.zeros(grp_ids.shape[0], dtype=torch.int64,
                            device=dev).index_add_(0, grp_of_b, padded)
    grp_padded = (grp_sizes + E - 1) // E * E
    b_final0 = (_excl(grp_padded)[grp_of_b] + b_off8
                - _excl(grp_sizes)[grp_of_b])   # bucket start, final stream
    n_gather = int(grp_padded.sum())
    n_chunks = n_gather // E
    elem_final = b_final0[bidx] + within
    pv = torch.zeros(n_gather, dtype=torch.float32, device=dev)
    pv[elem_final] = vals[order_g]
    pc = torch.zeros(n_gather, dtype=i32, device=dev)
    pc[elem_final] = (c64[order_g] % C).to(i32)
    del elem_final
    chunk_col_tile = torch.repeat_interleave(
        grp_ids, grp_padded // E, output_size=n_chunks).to(i32)

    # scatter stream: the same buckets rt-major (ct-minor), each row tile's
    # buckets padded together to E with whole pad rows
    b_rt = ub % n_rt
    order_b = torch.sort(b_rt * n_ct + b_ct, stable=True).indices
    sc_sizes = padded[order_b]
    sc_rows = sc_sizes // 8
    rt_ids, rt_nb = torch.unique_consecutive(b_rt[order_b],
                                             return_counts=True)
    rt_of_sb = _ids(rt_nb, nb)
    slots_per_rt = torch.zeros(rt_ids.shape[0], dtype=torch.int64,
                               device=dev).index_add_(0, rt_of_sb, sc_sizes)
    rt_padded = (slots_per_rt + E - 1) // E * E
    m_slots = int(rt_padded.sum())
    m_chunks = m_slots // E
    chunk_row_tile = torch.repeat_interleave(
        rt_ids, rt_padded // E, output_size=m_chunks).to(i32)
    dst_slot0 = (_excl(rt_padded)[rt_of_sb] + _excl(sc_sizes)
                 - _excl(slots_per_rt)[rt_of_sb])  # per bucket, scatter order

    zero_row = n_gather // 8                     # one past the gather rows
    perm_rows = torch.full((m_slots // 8,), zero_row, dtype=i32, device=dev)
    n_rows8 = int(sc_rows.sum())
    sb_of_row = _ids(sc_rows, n_rows8)
    row_within = torch.arange(n_rows8, device=dev) - _excl(sc_rows)[sb_of_row]
    src_row0 = (b_final0 // 8)[order_b]
    perm_rows[(dst_slot0 // 8)[sb_of_row] + row_within] = (
        src_row0[sb_of_row] + row_within).to(i32)
    del sb_of_row, row_within

    inv_pos = torch.empty(nb, dtype=torch.int64, device=dev)
    inv_pos[order_b] = torch.arange(nb, device=dev)
    elem_dst = dst_slot0[inv_pos][bidx] + within
    rloc = torch.full((m_slots,), R, dtype=i32, device=dev)
    rloc[elem_dst] = (r64[order_g] % R).to(i32)

    visited = torch.zeros(n_rt, dtype=torch.bool, device=dev)
    visited[chunk_row_tile.long()] = True
    return TiledELL(
        shape=shape, C=C, R=R, E=E,
        vals=pv.reshape(n_chunks, E), col_local=pc.reshape(n_chunks, E),
        chunk_col_tile=chunk_col_tile, perm_rows=perm_rows,
        row_local=rloc.reshape(m_chunks, E), chunk_row_tile=chunk_row_tile,
        visited_row_tiles=visited, n_col_tiles=n_ct, n_row_tiles=n_rt)


def tile_pairs(structure, R: int = 256, C: int = 512, E: int = 2048,
               impl: str = "auto", device=None) -> TiledPairs:
    """Bucket a sparsity structure by (row tile, col tile), on the device
    that holds it: the structure operand of :func:`sparse.linalg.sddmm`
    (the kernel reads its ``rows`` and ``cols``). ``impl`` "auto" and
    "numpy" run the one torch pass."""
    if impl not in ("auto", "numpy"):
        raise ValueError(f"tile_pairs: impl must be 'auto' or 'numpy', "
                         f"got {impl!r}")
    rows, cols, _, shape = _checked_coo_parts(structure, C, R, E,
                                              "tile_pairs", device)
    return _tile_pairs_torch(rows, cols, shape, R, C, E)


def _pad_groups(order, keys, E: int):
    """Given a sort order and a group key per entry (``keys[order]``
    nondecreasing), pad each group to a multiple of E. Returns (the padded
    index array, −1 for pads; the group key of each chunk)."""
    n = order.shape[0]
    dev = order.device
    uniq, counts = torch.unique_consecutive(keys[order], return_counts=True)
    padded = (counts + E - 1) // E * E
    total = int(padded.sum())
    idx = torch.full((total,), -1, dtype=torch.int64, device=dev)
    g = _ids(counts, n)
    ranks = torch.arange(n, device=dev) - _excl(counts)[g]
    idx[_excl(padded)[g] + ranks] = order
    chunk_key = torch.repeat_interleave(uniq, padded // E,
                                        output_size=total // E)
    return idx, chunk_key


def _tile_pairs_torch(r64, c64, shape, R: int, C: int, E: int) -> TiledPairs:
    dev = r64.device
    i32 = torch.int32
    n_rt = max(1, -(-shape[0] // R))
    n_ct = max(1, -(-shape[1] // C))
    key = (r64 // R) * n_ct + c64 // C
    if r64.shape[0]:
        # the reference's lexsort((cols, rows, key)) as one stable sort:
        # inside a bucket, row and col order are those of row % R, col % C
        order = torch.sort(key * (R * C) + (r64 % R) * C + c64 % C,
                           stable=True).indices
        pad_idx, chunk_key = _pad_groups(order, key, E)
        gr, gc = r64, c64
    else:                                        # empty structure
        pad_idx = torch.full((E,), -1, dtype=torch.int64, device=dev)
        chunk_key = torch.zeros(1, dtype=torch.int64, device=dev)
        gr = gc = torch.zeros(1, dtype=torch.int64, device=dev)
    real = pad_idx >= 0
    safe = pad_idx.clamp_min(0)
    rloc = torch.where(real, gr[safe] % R, R).to(i32)
    cloc = torch.where(real, gc[safe] % C, 0).to(i32)
    pos = torch.empty(r64.shape[0], dtype=i32, device=dev)
    pos[pad_idx[real]] = torch.nonzero(real).squeeze(1).to(i32)
    m_chunks = pad_idx.shape[0] // E
    return TiledPairs(
        shape=shape, R=R, C=C, E=E,
        row_local=rloc.reshape(m_chunks, E),
        col_local=cloc.reshape(m_chunks, E),
        chunk_row_tile=(chunk_key // n_ct).to(i32),
        chunk_col_tile=(chunk_key % n_ct).to(i32),
        pos=pos, rows=r64.to(i32), cols=c64.to(i32),
        n_row_tiles=n_rt, n_col_tiles=n_ct)


@instrument("sparse.tile_csr_pairs")
def tile_csr_pairs(A, R: int = 256, C: int = 512, E: int = 2048,
                   impl: str = "auto", device=None) -> TiledPairsSpmv:
    """One-time conversion of a sparse matrix (values included) to the
    pair-tiled SpMV operand (see :class:`TiledPairsSpmv`)."""
    pairs = tile_pairs(A, R=R, C=C, E=E, impl=impl, device=device)
    A = to_device(A, pairs.device)
    flat = torch.zeros(pairs.m_chunks * pairs.E, dtype=torch.float32,
                       device=pairs.device)
    flat[pairs.pos.long()] = A.values.to(torch.float32)
    visited = torch.zeros(pairs.n_row_tiles, dtype=torch.bool,
                          device=pairs.device)
    visited[pairs.chunk_row_tile.long()] = True
    blowup = pairs.m_chunks * pairs.E / max(1, pairs.nnz)
    if pairs.nnz > 0 and blowup > 4:
        _log.warning(
            "tile_csr_pairs: %.0fx pad blowup (%d slots for %d nnz) — the "
            "pair layout only wins for block-clustered structures; use "
            "prepare_spmv(layout='ell') for scattered matrices",
            blowup, pairs.m_chunks * pairs.E, pairs.nnz)
    return TiledPairsSpmv(pairs=pairs,
                          vals=flat.reshape(pairs.m_chunks, pairs.E),
                          visited=visited)
