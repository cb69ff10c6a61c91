"""IndexLayout — the slab description the IVF-Flat planes share.

Counterpart of ``raft_tpu/mutable/layout.py``, holding only what IVF-Flat
and IVF-PQ call: the :class:`IndexLayout` struct (``:50``, with the PQ
sidecar slots), the padded ragged slab
(``ragged_layout_from_lists``, ``:138``), its per-list int8 sidecar
(``quantize_layout``, ``:174``) and the certified-fused operands over a
layout (``fused_geometry`` / ``fused_ops_for_layout``, ``:244`` / ``:274``),
which the degenerate-exact plane runs K1 over. The reference builds the
layout with numpy on the host; the port builds it with torch on the
layout's device, so a 1M-row slab never leaves the card. The mutable
index, its WAL and checkpoints are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from raft_tpu_torch.core.resources import as_f32

#: slab row quantum every list pads to (the reference's 8-row multiple)
ROW_QUANTUM = 8


class IndexLayout:
    """One slab of index rows and its masks and sidecars.

    ``slab`` [R, d] f32 (pad rows zero), ``ids`` [R] int32 (slab row →
    global row id, −1 on pads), ``rows_valid`` [R] bool (live rows).
    ``offsets`` [L+1] / ``sizes`` [L] / ``padded_sizes`` [L] int32 carry the
    inverted-list geometry; the int8 sidecar (``slab_q`` int8 [R, d],
    ``row_scale`` and ``eq_rows`` f32 [R]) is per row, each row holding
    its list's scale and quantization bound. The product-quantized sidecar
    of an IVF-PQ index (reference ``:65-98``) rides the same rows:
    ``pq_codes`` (packed codes), ``pq_yy`` (‖ŷ‖²) and ``pq_eq_rows`` (the
    round-trip bound), with the per-index ``pq_rot`` (OPQ rotation or
    None) and ``pq_meta`` (``pq_dim``, ``pq_bits``, ``pq_mode``,
    ``codebooks``)."""

    __slots__ = ("slab", "ids", "rows_valid", "offsets", "sizes",
                 "padded_sizes", "row_quantum", "d_orig", "n_rows",
                 "db_dtype", "slab_q", "row_scale", "eq_rows",
                 "pq_codes", "pq_yy", "pq_eq_rows", "pq_rot", "pq_meta")

    def __init__(self, slab, ids, rows_valid, n_rows: int, d_orig: int,
                 offsets=None, sizes=None, padded_sizes=None,
                 row_quantum: int = ROW_QUANTUM, db_dtype: str = "f32",
                 slab_q=None, row_scale=None, eq_rows=None, pq_codes=None,
                 pq_yy=None, pq_eq_rows=None, pq_rot=None, pq_meta=None):
        self.slab = slab
        self.ids = ids
        self.rows_valid = rows_valid
        self.n_rows = int(n_rows)
        self.d_orig = int(d_orig)
        self.offsets = offsets
        self.sizes = sizes
        self.padded_sizes = padded_sizes
        self.row_quantum = int(row_quantum)
        self.db_dtype = db_dtype
        self.slab_q = slab_q
        self.row_scale = row_scale
        self.eq_rows = eq_rows
        self.pq_codes = pq_codes
        self.pq_yy = pq_yy
        self.pq_eq_rows = pq_eq_rows
        self.pq_rot = pq_rot
        self.pq_meta = pq_meta

    @property
    def slab_rows(self) -> int:
        return int(self.slab.shape[0])

    @property
    def ragged(self) -> bool:
        return self.offsets is not None

    def __repr__(self):
        return (f"IndexLayout(rows={self.n_rows}, slab={self.slab_rows}, "
                f"d={self.d_orig}, ragged={self.ragged}, "
                f"db_dtype={self.db_dtype})")


def ragged_layout_from_lists(y, labels, n_lists: int,
                             row_quantum: int = ROW_QUANTUM
                             ) -> IndexLayout:
    """The padded ragged slab: rows of ``y`` [m, d] bucketed by ``labels``
    into ``n_lists`` inverted lists, each padded up to the row quantum
    (empty lists cost no rows), laid back to back in one [R, d] slab with
    offsets, sizes and global ids alongside. Rows keep their input order
    within a list. Runs on ``y``'s device."""
    y = as_f32(y, y.device if isinstance(y, torch.Tensor) else "cpu")
    dev = y.device
    labels = torch.as_tensor(labels, device=dev).long().reshape(-1)
    m, d = y.shape
    L = int(n_lists)
    sizes = torch.bincount(labels, minlength=L)
    padded = (sizes + row_quantum - 1) // row_quantum * row_quantum
    offsets = torch.zeros(L + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(padded, 0)
    R = int(offsets[-1])
    order = torch.sort(labels, stable=True).indices
    sorted_labels = labels[order]
    first = torch.cumsum(sizes, 0) - sizes
    rank = torch.arange(m, device=dev) - first[sorted_labels]
    dest = offsets[sorted_labels] + rank
    slab = y.new_zeros((R, d))
    slab[dest] = y[order]
    ids = torch.full((R,), -1, dtype=torch.int32, device=dev)
    ids[dest] = order.to(torch.int32)
    return IndexLayout(slab, ids, ids >= 0, n_rows=m, d_orig=d,
                       offsets=offsets.to(torch.int32),
                       sizes=sizes.to(torch.int32),
                       padded_sizes=padded.to(torch.int32),
                       row_quantum=row_quantum)


def list_of_rows(layout: IndexLayout) -> torch.Tensor:
    """[R] int64: the inverted list each slab row belongs to."""
    L = int(layout.sizes.shape[0])
    return torch.repeat_interleave(
        torch.arange(L, device=layout.slab.device),
        layout.padded_sizes.long(), output_size=layout.slab_rows)


def quantize_layout(layout: IndexLayout) -> IndexLayout:
    """Per-list symmetric int8 sidecar over a ragged layout (``quantize_
    rows_q8`` grouped by inverted list, pads kept out of the scales; each
    row stores its list's scale and Eq bound). The f32 slab stays: it is
    the exact-rescore data plane."""
    from raft_tpu_torch.distance.knn_fused import q8_eq_bound, quantize_rows_q8

    if not layout.ragged:
        raise ValueError("quantize_layout: per-list quantization needs a "
                         "ragged (IVF) layout")
    L = int(layout.sizes.shape[0])
    gid = list_of_rows(layout)
    slab_q, list_scale = quantize_rows_q8(layout.slab, gid, L,
                                          valid=layout.ids >= 0)
    eq_lists = q8_eq_bound(list_scale, layout.slab.shape[1])
    return IndexLayout(layout.slab, layout.ids, layout.rows_valid,
                       n_rows=layout.n_rows, d_orig=layout.d_orig,
                       offsets=layout.offsets, sizes=layout.sizes,
                       padded_sizes=layout.padded_sizes,
                       row_quantum=layout.row_quantum, db_dtype="int8",
                       slab_q=slab_q, row_scale=list_scale[gid],
                       eq_rows=eq_lists[gid])


class FusedOps(NamedTuple):
    """Prepared certified-fused operands over one layout: the ragged
    :class:`~raft_tpu_torch.distance.knn_fused.KnnIndex` (its
    ``rows_valid`` mask hides every pad) and ``ids`` [M] int32 mapping
    prepared slab positions back to global ids (−1 on pads)."""

    index: object
    ids: torch.Tensor

    @property
    def pool_width(self) -> int:
        idx = self.index
        n_tiles = idx.y_hi.shape[0] // idx.T
        return 2 * (-(-n_tiles // idx.g)) * 128


def fused_geometry(slab_rows: int, d: int, passes: int = 3,
                   T: Optional[int] = None, g: Optional[int] = None
                   ) -> Tuple[int, int, int]:
    """(T, g, pbits) of a certified-fused program over ``slab_rows`` ×
    ``d``: the built-in tiling, the auto pack width, and ``g`` clamped
    into the packed-code space (the ragged mask rides in the packed
    sentinel). The reference's scoped-VMEM fit and its query block are
    TPU terms and have no counterpart here."""
    from raft_tpu_torch.distance.knn_fused import (
        _LANES, _PACK_BITS, _PBITS_MAX, auto_pack_bits, fused_config)

    cfg = fused_config(passes)
    T = cfg.T if T is None else T
    n_tiles_est = max(1, -(-slab_rows // T))
    if g is None:
        g = max(cfg.g,
                (1 << auto_pack_bits(n_tiles_est, T)) // (T // _LANES))
    n_ch = T // _LANES
    pbits = min(_PBITS_MAX, max(_PACK_BITS, int(math.ceil(math.log2(
        max(g * n_ch, 2))))))
    if g * n_ch > (1 << pbits):
        g = max(1, (1 << pbits) // n_ch)
    return T, g, pbits


def fused_ops_for_layout(layout: IndexLayout, passes: int = 3,
                         metric: str = "l2", T: Optional[int] = None,
                         g: Optional[int] = None) -> FusedOps:
    """Prepare the certified-fused operands for ``layout``: resolve the
    packed geometry (:func:`fused_geometry`) and run ``prepare_knn_index``
    over the f32 slab with the layout's ``rows_valid`` as the ragged
    never-wins mask; ``ids`` is padded to the prepared row count."""
    from raft_tpu_torch.distance.knn_fused import prepare_knn_index

    R, d = layout.slab.shape
    T, g, _ = fused_geometry(R, d, passes, T=T, g=g)
    index = prepare_knn_index(layout.slab, passes=passes, metric=metric,
                              T=T, g=g, device=layout.slab.device,
                              rows_valid=layout.rows_valid)
    M = index.y_hi.shape[0]
    ids = layout.ids.to(torch.int32)
    if M > R:
        ids = torch.cat([ids, ids.new_full((M - R,), -1)])
    return FusedOps(index, ids)
