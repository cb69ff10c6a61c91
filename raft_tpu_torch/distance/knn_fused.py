"""Certified fused KNN — the main path of the port.

Counterpart of ``raft_tpu/distance/knn_fused.py`` (ref: brute-force knn =
pairwise distance + select_k with the distance tiles consumed by the
selector; BASELINE config 2). The pipeline:

1. K1 (``ops.fused_l2_topk.fused_l2_group_topk_packed``, a Hopper kernel)
   streams the index against the queries and keeps, per (lane class, group
   of g tiles) bucket, the two smallest packed half-distances and the third
   smallest; the distance matrix never reaches memory. The candidate's
   within-group code rides in the low ``pbits`` mantissa bits.
2. Twin-pool selection: the k + 32 smallest a1 values, each with its a2
   twin, pruned back to C by kernel order, and decoded to row ids.
3. The C candidates are rescored exactly in f32 (or, in the lite mode of
   an index without its f32 rows, the kernel values are returned).
4. Per-query exactness certificate: every non-candidate has a kernel value
   ≥ B = min(group 3rd-min, Ca-th a1, C-th candidate); with the kernel
   error E (zero at passes=1 unless ``certify="f32"``), ``B − E ≥ θ``
   proves the returned top-k exact.
5. Queries that fail are re-solved exactly against the whole index. The
   reference runs static tiers inside ``lax.cond``; PyTorch is eager, so
   the port reads the failure count once and re-solves the failed rows in
   chunks whose [F, M] f32 tile stays inside ``_FIXUP_TILE_BUDGET``.

Modes: ``passes=3`` (bf16 hi/lo split, certified exact w.r.t. f32 scores)
and ``passes=1`` (one bf16 product; exact w.r.t. bf16 scores, or w.r.t.
f32 with ``certify="f32"``); metrics ``l2`` and ``ip``.

``db_dtype="int8"`` streams the index as per-group symmetric int8 codes
through K2 (``ops.fused_l2_topk.fused_l2_group_topk_packed_q8``), half of
bf16's bytes. The kernel then scores the dequantized rows ŷ exactly up to
the bf16 error of x; the certificate is widened by the groups' recorded
quantization bound Eq, and the candidates are always rescored in f32
from the original rows, so returned ids are certified against the f32
oracle.

Wide features (512 < d ≤ 4096) take K1's d-chunked form
(``fused_l2_group_topk_packed_dchunk``), 64 queries a block, held or
streamed beside the index's feature slices as shared memory allows;
features pad to a multiple of 128, what the kernel slices by (not the
reference's 256). A geometry whose g·T/128
codes do not fit the packed mantissa (2¹³) takes the unpacked form
(``fused_l2_group_topk``, or ``_dchunk`` for d > 512): the pool is the
2S′ values (a1, a2) with their row ids, recovered as 2·a + ‖x‖², padded
rows carry +inf, and there is no packing margin. An int8 request there
takes bf16, as the reference does. The reference's grid orders
(query/db/dbuf) are TPU schedules of one function, and its
``RAFT_TPU_POOL_SELECT`` A/B knob is not ported: the port selects the pool
with ``torch.topk``, what the knob's default ``xla`` does.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch.core.kvp import flip_sign, order_key, select_smallest
from raft_tpu_torch.core.resources import as_f32, resolve_device
from raft_tpu_torch.observability import explain
from raft_tpu_torch.observability.quality import record_pending
from raft_tpu_torch.ops.fused_l2_topk import (
    _LANES, _PACK_BITS, _PACK_PAD, _PBITS_MAX, fused_l2_group_topk,
    fused_l2_group_topk_dchunk, fused_l2_group_topk_packed,
    fused_l2_group_topk_packed_dchunk, fused_l2_group_topk_packed_q8,
    split_hi_lo)
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point

_log = logging.getLogger(__name__)

#: storage dtypes of the streamed index (reference ``:102``)
DB_DTYPES = ("bf16", "int8")
# past this width the query block no longer fits a block's shared memory
# resident, and the d-chunked kernel forms stream it
_D_SINGLE_SHOT = 512
# the fused pipeline's widest features (the reference's gate)
_D_MAX = 4096
# budget of one [F, M] f32 fixup tile (the reference's figure)
_FIXUP_TILE_BUDGET = 4_200_000_000
# pool oversampling beyond k before exact rescoring
_POOL_PAD = 32
# queries per pass: bounds the [Q, S'] bucket arrays and the [Q, C, d]
# rescore gather
_Q_CHUNK = 2048


def _err_bound_coeff(d: int) -> float:
    """Upper bound on |d2_kernel − d2_exact| / (‖x‖·‖y‖) for the bf16x3
    mode (passes=3), with bf16 factors rounded to nearest (u = 2⁻⁸) and
    f32 accumulation (u = 2⁻²⁴): the dropped lo·lo term, the re-rounding
    of the lo factors and three f32 accumulations, doubled for d2 and
    doubled again as margin (derivation in the reference)."""
    return 2.0 ** -12 + d * 2.0 ** -20


def _err_bound_coeff_p1(d: int) -> float:
    """|d2_kernel − d2_f32| / (‖x‖·‖y‖) bound for the one-pass bf16
    product — the margin behind ``certify="f32"`` at passes=1: bf16
    rounding of both factors plus the f32 accumulation, doubled for d2
    and doubled again as margin."""
    return 2.0 ** -5 + 2.0 ** -14 + d * 2.0 ** -22


def decode_packed_pool(cand_p, pos, S_: int, T: int, g: int,
                       pbits: int = _PACK_BITS):
    """Row ids from (packed value, pool position): the decode of K1's
    mantissa codes. Returns -1 for sentinel entries."""
    n_ch = T // _LANES
    slot = pos % S_
    local = (cand_p.view(torch.int32) & ((1 << pbits) - 1)).to(pos.dtype)
    col = ((slot // _LANES) * g + local // n_ch) * T \
        + (local % n_ch) * _LANES + (slot % _LANES)
    return torch.where(cand_p < _PACK_PAD * 0.25, col, -1).to(torch.int32)


def auto_pack_bits(n_tiles: int, T: int) -> int:
    """Pack-code width for an index of ``n_tiles`` tiles of T rows: the
    widest codes that keep ≥ ~2.5k buckets, clamped to [8, 13]."""
    return min(_PBITS_MAX, max(_PACK_BITS, int(math.floor(
        math.log2(max(n_tiles * T / 2560.0, 256.0))))))


def pad_query_rows(x, rows: int):
    """Pad a ragged query batch with zero rows up to ``rows`` (the serving
    buckets' fixed shapes); zero rows are inert, and callers slice the
    first ``n`` results back out. Raises when the batch is larger."""
    n = x.shape[0]
    if n > rows:
        raise ValueError(f"pad_query_rows: batch of {n} rows does not "
                         f"fit the {rows}-row bucket")
    if n == rows:
        return x
    return torch.cat([x, x.new_zeros((rows - n, x.shape[1]))])


def _prepare_ops(y, T: int, g: int, metric: str, pbits: int = _PACK_BITS,
                 rows_valid=None):
    """Index-side operands: rows padded to whole tiles, the bf16 hi/lo
    split, row norms and the half-norm carrier with the never-wins
    sentinel on padded rows: the finite ``_PACK_PAD`` for the packed
    kernels (code bits would turn +inf into NaN), +inf for the unpacked
    ones. Returns ``(yp, y_hi, y_lo, yyh_k, yy_raw)``; the reference's
    [8, M] sublane carrier is TPU layout, the port keeps [M].

    ``rows_valid`` ([M] bool over the padded rows) is the ragged mask of
    the IVF slab: pads may sit anywhere, and every masked-out row carries
    the same never-wins sentinel as the trailing tile pad, so K1's fold
    and the certificate never see it (reference ``:344-377``)."""
    m = y.shape[0]
    pad = (-m) % T
    yp = torch.cat([y, y.new_zeros((pad, y.shape[1]))]) if pad else y
    M = yp.shape[0]
    yy_raw = (yp * yp).sum(1)
    valid = (torch.arange(M, device=y.device) < m if rows_valid is None
             else rows_valid)
    packed = g * (T // _LANES) <= (1 << pbits)
    pad_sentinel = _PACK_PAD if packed else float("inf")
    if metric == "ip":
        # r = 0/2 − x·(y/2) = −x·y/2, so the score −x·y = 2·r
        y_hi, y_lo = split_hi_lo(yp * 0.5)
        yyh_k = torch.where(valid, 0.0, pad_sentinel)
    else:
        y_hi, y_lo = split_hi_lo(yp)
        yyh_k = torch.where(valid, 0.5 * yy_raw, pad_sentinel)
    return yp, y_hi, y_lo, yyh_k.float(), yy_raw


_Q8_LEVELS = 127
# per-element round-trip error of the int8 quantizer in code steps: half a
# step plus headroom for the f32 divide / round / multiply
_Q8_ERR = 0.5 * (1.0 + 2.0 ** -10)


def quantize_rows_q8(z, gid, n_groups: int, valid=None):
    """Per-group symmetric int8 quantization of ``z`` [M, d] (group of row
    i = ``gid[i]``; reference ``:383``): scale = max|z_group| / 127, codes
    round half to even and clip to ±127. ``valid`` keeps pad rows out of
    the scales (their codes are still produced; consumers mask them).
    Returns (codes int8 [M, d], scales f32 [n_groups])."""
    absz = z.abs()
    if valid is not None:
        absz = torch.where(valid.reshape(-1, 1), absz, 0.0)
    row_max = absz.max(dim=1).values
    gid = gid.long()
    gmax = torch.zeros(n_groups, dtype=z.dtype, device=z.device)
    gmax = gmax.scatter_reduce(0, gid, row_max, reduce="amax")
    scales = torch.where(gmax > 0, gmax / _Q8_LEVELS, 1.0)
    q = torch.clamp(torch.round(z / scales[gid].reshape(-1, 1)),
                    -_Q8_LEVELS, _Q8_LEVELS)
    return q.to(torch.int8), scales


def q8_eq_bound(scales, d: int):
    """Per-group bound Eq on the row-vector L2 error of the int8 round
    trip (reference ``:405``): scale·_Q8_ERR per element, times √d."""
    return scales * (_Q8_ERR * math.sqrt(max(d, 1)))


def _pad_valid(rows_valid, m: int, M: int, device):
    """[M] bool live mask: ``rows_valid`` ([m], or None for the first m
    rows) with the rows padded on to M masked out."""
    if rows_valid is None:
        return torch.arange(M, device=device) < m
    return torch.cat([rows_valid, rows_valid.new_zeros(M - m)])


def _prepare_ops_q8(y, T: int, g: int, metric: str, rows_valid=None):
    """Index-side operands of the int8-streamed index (reference
    ``:424-487``): rows padded to whole certificate groups of g·T rows,
    the stream operand (y, or y/2 for ip) quantized per group (group of
    row i = i // (g·T)), and the carriers from the DEQUANTIZED rows ŷ, so
    K2's folded value is exactly d2(x, ŷ)/2 and the decode and certificate
    downstream are K1's. Returns ``(yp, y_q, scales, yyh_k, yy_raw,
    eq_groups)``: scales and eq_groups [G] (the reference's [G, 8, 128]
    scale tile is TPU layout), yy_raw the dequantized full-scale norms
    (the bf16 error bound's ymax). ``rows_valid`` ([m] bool) keeps pads
    out of the scales and gives them the never-wins sentinel."""
    m, d = y.shape
    pad = (-m) % (g * T)
    yp = torch.cat([y, y.new_zeros((pad, d))]) if pad else y
    M = yp.shape[0]
    G = M // (g * T)
    valid = _pad_valid(rows_valid, m, M, y.device)
    z = yp * 0.5 if metric == "ip" else yp
    gid = torch.arange(M, device=y.device) // (g * T)
    y_q, scales = quantize_rows_q8(z, gid, G, valid=valid)
    eq_groups = q8_eq_bound(scales, d)
    zq = y_q.float() * scales[gid].reshape(-1, 1)
    if metric == "ip":
        yyh_k = torch.where(valid, 0.0, _PACK_PAD)
        yhat = 2.0 * zq            # full-scale dequantized ŷ (= 2·ẑ)
    else:
        yyh_k = torch.where(valid, 0.5 * (zq * zq).sum(1), _PACK_PAD)
        yhat = zq
    yy_raw = (yhat * yhat).sum(1)
    return yp, y_q, scales, yyh_k.float(), yy_raw, eq_groups


class FusedConfig(NamedTuple):
    """(T, Qb, g, grid_order): the reference's tiling config. The port
    reads T (rows per tile) and g (tiles per group); Qb and grid_order are
    TPU scheduling knobs, kept so the built-in config reads the same."""

    T: int
    Qb: int
    g: int
    grid_order: str = "query"


_BUILTIN_CONFIG = FusedConfig(2048, 256, 16, "query")


def fused_config(passes: int = 3) -> FusedConfig:
    """The built-in tiling. The reference's ``TUNE_FUSED.json`` holds TPU
    measurements and is never read by the port."""
    return _BUILTIN_CONFIG


def resolve_db_dtype(db_dtype: str, d: int, packed: bool,
                     store_yp: bool = True) -> str:
    """The dtype an index build really stores (reference ``:1095``). A
    lite int8 index is an error: int8 results are certified by rescoring
    candidates from the f32 rows. Outside K2's envelope (d > 512, or a
    geometry outside the packed codes) int8 downgrades to bf16, logged,
    and the bf16 index then runs K1's d-chunked or unpacked form."""
    if db_dtype not in DB_DTYPES:
        raise ValueError(f"db_dtype must be one of {DB_DTYPES}, "
                         f"got {db_dtype!r}")
    if db_dtype == "bf16":
        return db_dtype
    if not store_yp:
        raise ValueError(
            "db_dtype='int8' requires store_yp=True: quantized results "
            "are certified by exact-rescoring candidates from the "
            "original f32 rows — a lite index has nothing to rescore from")
    reason = None
    if d > _D_SINGLE_SHOT:
        reason = f"d={d} > {_D_SINGLE_SHOT} takes the d-chunked kernel"
    elif not packed:
        reason = "config is outside the packed-code envelope"
    if reason is None:
        return db_dtype
    _log.warning("db_dtype='int8' outside the quantized-streaming envelope "
                 "(%s) — storing bf16 for this index", reason)
    return "bf16"


def fused_eligible(n_rows: int, d: int, device) -> bool:
    """The fused pipeline's gate, the reference's: a CUDA device, at
    least 4096 rows and d ≤ 4096 (shared by ``knn``'s auto routing)."""
    return (torch.device(device).type == "cuda" and n_rows >= 4096
            and d <= _D_MAX)


def _bf16_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")    # a writable copy (JAX exports read-only)
    if a.dtype.name == "bfloat16":             # ml_dtypes, as JAX exports
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a, dtype=torch.float32).to(
        device=device, dtype=torch.bfloat16)


class KnnIndex:
    """Prepared fused-KNN index: the index-side operands computed once
    (row padding, bf16 hi/lo split or int8 codes, norms and sentinel
    carrier), with the tiling, passes, metric and storage dtype frozen at
    build. Build with :func:`prepare_knn_index` or :meth:`from_numpy`;
    query with ``knn_fused(x, index, k)`` or ``distance.knn(res, index,
    queries, k)``. ``yp`` (the row-padded f32 rows) is None for a lite
    index. An int8 index (``db_dtype="int8"``) holds ``y_q`` [M, d] int8
    with one scale and one quantization bound Eq per group of g·T rows
    (``scales``, ``eq_groups`` [G]) instead of ``y_hi``/``y_lo``. ``Qb``
    is the query block the serving ladder tops out at."""

    def __init__(self, yp, y_hi, y_lo, yyh_k, yy_raw, n_rows: int, T: int,
                 g: int, passes: int, metric: str, d_orig: int,
                 pbits: int = _PACK_BITS, rows_valid=None,
                 Qb: Optional[int] = None,
                 db_dtype: str = "bf16", y_q=None, scales=None,
                 eq_groups=None):
        self.yp = yp
        self.y_hi, self.y_lo = y_hi, y_lo
        self.yyh_k, self.yy_raw = yyh_k, yy_raw
        self.n_rows = n_rows
        self.T, self.g = T, g
        self.Qb = _BUILTIN_CONFIG.Qb if Qb is None else Qb
        self.passes, self.metric = passes, metric
        self.d_orig = d_orig
        self.pbits = pbits
        # [M] bool live mask of a ragged index (None: the first n_rows
        # rows are live)
        self.rows_valid = rows_valid
        self.db_dtype = db_dtype
        self.y_q, self.scales, self.eq_groups = y_q, scales, eq_groups

    def row_norms(self) -> torch.Tensor:
        """[M] ‖y‖² of the stored f32 rows: ``yy_raw`` itself, except on
        an int8 index, whose ``yy_raw`` holds the dequantized rows' norms
        (computed per call there, as the reference's fixup does)."""
        if self.db_dtype != "int8":
            return self.yy_raw
        return (self.yp * self.yp).sum(1)

    @property
    def _stream(self) -> torch.Tensor:
        return self.y_q if self.db_dtype == "int8" else self.y_hi

    @property
    def prepared_rows(self) -> int:
        """M: the rows the kernel streams (padded to whole tiles, or to
        whole groups of g·T rows for int8)."""
        return self._stream.shape[0]

    def live_columns(self) -> torch.Tensor:
        """[M] bool: the prepared rows a result may name."""
        col = torch.arange(self.prepared_rows, device=self.device)
        live = col < self.n_rows
        return live if self.rows_valid is None else live & self.rows_valid

    @property
    def device(self) -> torch.device:
        return self._stream.device

    @property
    def stream_width(self) -> int:
        """Feature width of the streamed operand (queries pad to it)."""
        return self._stream.shape[1]

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "KnnIndex":
        """The port's index from a reference ``KnnIndex``'s state as
        numpy: ``yp`` (or None), ``y_hi``, ``y_lo`` (or None), ``yyh_k``
        ([8, M] or [M]), ``yy_raw`` ([1, M] or [M]), and the scalars
        ``n_rows, T, g, passes, metric, d_orig, pbits`` (``Qb`` if
        given). A reference int8 index (``db_dtype="int8"``) brings
        ``y_q``, ``y_scale_k`` ([G, 8, 128], or ``scales`` [G]) and
        ``eq_groups`` instead of ``y_hi``/``y_lo``. Queries against it give
        the reference index's answers."""
        dev = resolve_device(device)

        def f32(a):
            return None if a is None else as_f32(np.asarray(a), dev)

        yyh = np.asarray(arrays["yyh_k"])
        db_dtype = str(arrays.get("db_dtype") or "bf16")
        kw = {}
        if db_dtype == "int8":
            scales = arrays.get("scales")
            if scales is None:
                scales = np.asarray(arrays["y_scale_k"])[:, 0, 0]
            kw = dict(y_q=torch.from_numpy(np.array(
                arrays["y_q"], np.int8, order="C")).to(dev),
                scales=f32(scales), eq_groups=f32(arrays["eq_groups"]))
            y_hi = y_lo = None
        else:
            y_hi = _bf16_from_numpy(arrays["y_hi"], dev)
            y_lo = arrays.get("y_lo")
            y_lo = None if y_lo is None else _bf16_from_numpy(y_lo, dev)
        qb = arrays.get("Qb")
        return cls(
            f32(arrays.get("yp")), y_hi, y_lo,
            f32(yyh[0] if yyh.ndim == 2 else yyh),
            f32(np.asarray(arrays["yy_raw"]).reshape(-1)),
            int(arrays["n_rows"]), int(arrays["T"]), int(arrays["g"]),
            int(arrays["passes"]), str(arrays["metric"]),
            int(arrays["d_orig"]), int(arrays["pbits"]),
            Qb=None if qb is None else int(qb), db_dtype=db_dtype, **kw)


@instrument("distance.prepare_knn_index")
def prepare_knn_index(y, passes: int = 3, metric: str = "l2",
                      T: Optional[int] = None, g: Optional[int] = None,
                      store_yp: bool = True, device=None,
                      rows_valid=None, db_dtype: str = "bf16",
                      Qb: Optional[int] = None) -> KnnIndex:
    """Build a :class:`KnnIndex` for repeated queries against ``y``
    (numpy or tensor; ``device=None`` is ``y``'s device, else ``cuda``).

    ``store_yp=False`` builds a lite index without the f32 rows: queries
    then return the exact top-k of the kernel score function (bf16 /
    bf16x3), values within 2^(pbits−23) relative. ``rows_valid`` ([m]
    bool) marks the live rows of a ragged slab (the IVF-Flat layout);
    results then never name a masked row, and positions are slab rows.
    The mask rides the packed kernels' sentinel carrier, so it needs the
    packed-code envelope (g·T/128 ≤ 2¹³) and raises outside it.

    ``db_dtype="int8"`` (:data:`DB_DTYPES`) streams the index as int8
    codes with one symmetric scale per certificate group of g·T rows (the
    rows pad to whole groups): K2 reads M·d bytes instead of bf16's
    M·d·2(·2), the certificate is widened by the groups' bound Eq, and
    candidates are rescored in f32 from the stored rows, so it needs
    ``store_yp=True``; outside K2's envelope it downgrades to bf16 (see
    :func:`resolve_db_dtype`). ``Qb`` (default the built-in 256) is the
    query block the serving engine's default bucket ladder tops out at."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"prepare_knn_index: metric must be 'l2' or "
                         f"'ip', got {metric!r}")
    if passes not in (1, 3):
        raise ValueError(f"prepare_knn_index: passes must be 1 or 3, got "
                         f"{passes}")
    if db_dtype not in DB_DTYPES:
        raise ValueError(f"prepare_knn_index: db_dtype must be one of "
                         f"{DB_DTYPES}, got {db_dtype!r}")
    dev = resolve_device(device, y)
    y = as_f32(y, dev)
    m, d = y.shape
    cfg = fused_config(passes)
    T = cfg.T if T is None else T
    if T <= 0 or T % _LANES:
        raise ValueError(f"prepare_knn_index: T={T} must be a positive "
                         f"multiple of {_LANES}")
    n_ch = T // _LANES
    if g is None:
        g = max(cfg.g, (1 << auto_pack_bits(max(1, -(-m // T)), T)) // n_ch)
    if g < 1:
        raise ValueError(f"prepare_knn_index: g={g} must be ≥ 1")
    pbits = min(_PBITS_MAX, max(_PACK_BITS, int(math.ceil(math.log2(
        max(g * n_ch, 2))))))
    packed = g * n_ch <= (1 << pbits)
    db_dtype = resolve_db_dtype(db_dtype, d, packed, store_yp)
    if rows_valid is not None and not packed:
        raise ValueError(
            f"prepare_knn_index: rows_valid (a ragged mask) needs the "
            f"packed-code envelope, but g·T/128 = {g * n_ch} codes exceed "
            f"2^{pbits}")
    dpad = (-d) % _LANES
    if dpad:
        y = torch.cat([y, y.new_zeros((m, dpad))], dim=1)
    if rows_valid is not None:
        rows_valid = torch.as_tensor(rows_valid, device=dev).reshape(-1).to(
            torch.bool)
        if rows_valid.shape[0] != m:
            raise ValueError(f"prepare_knn_index: rows_valid has "
                             f"{rows_valid.shape[0]} entries for {m} rows")
    if db_dtype == "int8":
        fault_point("quantize_index")
        yp, y_q, scales, yyh_k, yy_raw, eq = _prepare_ops_q8(
            y, T, g, metric, rows_valid)
        if rows_valid is not None:
            rows_valid = _pad_valid(rows_valid, m, yp.shape[0], dev)
        return KnnIndex(yp, None, None, yyh_k, yy_raw, m, T, g, passes,
                        metric, d, pbits=pbits, rows_valid=rows_valid, Qb=Qb,
                        db_dtype="int8", y_q=y_q, scales=scales,
                        eq_groups=eq)
    if rows_valid is not None:
        rows_valid = _pad_valid(rows_valid, m, m + (-m) % T, dev)
    yp, y_hi, y_lo, yyh_k, yy_raw = _prepare_ops(y, T, g, metric, pbits,
                                                 rows_valid)
    if not store_yp:
        yp = None
        if passes == 1:
            y_lo = None    # the 1-pass kernel and lite fixup never read it
    return KnnIndex(yp, y_hi, y_lo, yyh_k, yy_raw, m, T, g, passes, metric,
                    d, pbits=pbits, rows_valid=rows_valid, Qb=Qb)


def _rescore(x, xx, idx: KnnIndex, pid):
    """Exact f32 scores (d2, or −x·y for ip) of the candidate rows ``pid``
    [Q, C] (−1: none, scored +inf): one row-wise dot product each, not a
    batched GEMM, so a query's values do not depend on the batch it rides
    in (a served request equals the same query asked alone)."""
    safe = pid.long().clamp(0, max(idx.n_rows, 1) - 1)
    yc = idx.yp[safe]                                           # [Q, C, d]
    dot = (yc * x[:, None, :]).sum(2)
    norms = xx[:, None] + (yc * yc).sum(2)
    if idx.metric == "ip":
        d2 = -dot
    else:
        d2 = (norms - 2.0 * dot).clamp_min(0.0)
    return _nan_signed(d2, norms, idx.metric).masked_fill(pid < 0,
                                                          float("inf"))


def _nan_signed(d2, norms, metric: str):
    """``d2`` with each NaN given the sign the reference's arithmetic gives
    it on the CPU, where ``jax.lax.top_k(−d2, k)`` ranks a negative NaN
    first and a positive one last. The card's default NaN is positive and
    torch's bf16 split of a NaN is negative, so without this a NaN row or
    a row that holds ±inf would rank otherwise here. For l2, whose
    reference is (xx + yy) − 2s, a NaN takes the sign of the ``norms``
    (xx + yy) where they are NaN (a NaN operand), and is negative where
    they are not (∞ − ∞ or 0·∞ on a ±inf row: the CPU's default NaN).
    ip's −s flips both signs."""
    carried, made = norms, -2 ** 22
    if metric == "ip":
        carried, made = flip_sign(norms), 0x7FC00000
    made = d2.new_full((), made, dtype=torch.int32).view(torch.float32)
    return torch.where(torch.isnan(norms), carried, torch.where(
        torch.isnan(d2), made, d2))


def _smallest_k(vals, ids, k: int):
    """The k smallest ``vals`` [Q, n] (f32) with their ``ids``, ties
    broken by id: one top-k over the unique (value, id) key
    (:func:`order_key`), so the result does not depend on the top-k
    algorithm a batch size selects. ``ids`` None takes the positions
    (int32) as the ids."""
    key = order_key(vals, ids)
    _, pos = torch.topk(key, k, dim=1, largest=False, sorted=True)
    del key                       # [Q, n] int64: freed before the gathers
    out = pos.to(torch.int32) if ids is None else torch.gather(ids, 1, pos)
    return torch.gather(vals, 1, pos), out


def _exact_rows(xq, idx: KnnIndex, k: int):
    """Exact top-k of a [F, d] query block against the whole index: f32
    against the stored rows, or — lite index — the kernel's own bf16(x3)
    score function, which lite results are certified against."""
    y_hi, y_lo = idx.y_hi, idx.y_lo
    xs = (xq * xq).sum(1)
    if idx.yp is not None:
        s = xq @ idx.yp.T
    else:
        xhi = xq.to(torch.bfloat16)
        s = xhi.float() @ y_hi.float().T
        if idx.passes == 3:
            xlo = (xq - xhi.float()).to(torch.bfloat16)
            s = s + xhi.float() @ y_lo.float().T
            s = s + xlo.float() @ y_hi.float().T
    # the f32 rows' norms (an int8 index's yy_raw is the dequantized
    # rows')
    yy = idx.yy_raw if idx.yp is None else idx.row_norms()
    if idx.metric == "ip":
        # lite operands are the split of y/2: −x·y = −2·s there
        d2 = -s if idx.yp is not None else -2.0 * s
    else:
        d2 = (xs[:, None] + yy[None, :] - 2.0 * s).clamp_min(0.0)
    del s
    # d2 holds a NaN only where a norm is not finite (a NaN or ±inf
    # operand, or xx + yy past f32's range); one host read a chunk
    # decides whether its NaNs need the reference's signs
    if not bool(torch.isfinite(xs.max() + yy.max())):
        d2 = _nan_signed(d2, xs[:, None] + yy[None, :], idx.metric)
    live = idx.live_columns()
    d2 = d2.masked_fill(~live[None, :], float("inf"))
    # the nomination breaks exact ties at the lower column, as the
    # reference's jax.lax.top_k(−d2, k) does. With stored rows it only
    # nominates k + _POOL_PAD candidates: the GEMM's rounding depends on
    # how many query rows it multiplies, the row-wise rescore does not,
    # so a query's answer is the same bits whichever batch (and path) it
    # rides in
    kk = k if idx.yp is None else min(k + _POOL_PAD, d2.shape[1])
    vals, pos = select_smallest(d2, kk)
    # a live row keeps its id whatever it scores: a row that holds ±inf
    # scores NaN or ±inf, and the reference's top_k returns it so
    ids = torch.where(live[pos], pos.to(torch.int32), -1)
    if idx.yp is not None:
        vals, ids = _smallest_k(_rescore(xq, xs, idx, ids), ids, k)
    return vals, ids


def _real_half(v):
    return torch.where(v < _PACK_PAD * 0.25, v.abs(), 0.0)


def _knn_fused_core(x, idx: KnnIndex, k: int, rescore: bool,
                    certify: str, margins: Optional[list] = None):
    """Certified fused KNN on prepared operands; ``x`` [Q, stream_width]
    f32. Returns (scores [Q, k] ascending, ids [Q, k], n_fail): the score
    is d2 for l2 and −x·y for ip. A ``margins`` list receives the
    per-query certificate margin [Q] (bound − θ − err, a device tensor;
    negative = the query paid the exact fixup)."""
    wide = x.shape[1] > _D_SINGLE_SHOT
    xx = (x * x).sum(1)                                         # [Q]
    cand_p = None
    if idx.g * (idx.T // _LANES) > (1 << idx.pbits):
        C, cand_v_hat, cand_pid, a3_min = _unpacked_pool(x, xx, idx, k,
                                                         wide)
        e_pack = torch.zeros_like(xx)
    else:
        C, cand_v_hat, cand_pid, a3_min, cand_p, e_pack = _packed_pool(
            x, xx, idx, k, wide)
    if rescore:
        vals, ids = _smallest_k(_rescore(x, xx, idx, cand_pid), cand_pid, k)
    else:
        # lite: candidates are sorted by kernel order, so the head is the
        # result; a packed value has its code bits cleared first
        vals = cand_v_hat[:, :k]
        if cand_p is not None:
            vals = 2.0 * (cand_p[:, :k].view(torch.int32)
                          & ~((1 << idx.pbits) - 1)).view(torch.float32)
        if idx.metric != "ip":
            vals = vals.clamp_min(0.0)
        ids = cand_pid[:, :k]
        vals = vals.masked_fill(ids < 0, float("inf"))
    return _certify(x, xx, idx, k, vals, ids, C, cand_v_hat, a3_min, e_pack,
                    certify, margins)


def _unpacked_pool(x, xx, idx: KnnIndex, k: int, wide: bool):
    """The unpacked kernel's pool (reference ``:716-735``): (a1, a2) with
    their row ids, back in score space as 2·a + xx (0 for ip; +inf stays
    +inf), the C smallest of the 2S′ pool, ids −1 where the value is not
    finite, and the group 3rd-min bound. Returns (C, cand_v_hat,
    cand_pid, a3_min)."""
    kern = fused_l2_group_topk_dchunk if wide else fused_l2_group_topk
    a1, id1, a2, id2, a3 = kern(x, idx.y_hi, idx.y_lo, idx.yyh_k, T=idx.T,
                                g=idx.g, passes=idx.passes)
    xx_r = (torch.zeros_like(xx) if idx.metric == "ip" else xx)[:, None]
    pool_v = torch.cat([2.0 * a1 + xx_r, 2.0 * a2 + xx_r], dim=1)
    pool_id = torch.cat([id1, id2], dim=1)
    C = min(k + _POOL_PAD, pool_v.shape[1])
    cand_v_hat, pos = torch.topk(pool_v, C, dim=1, largest=False,
                                 sorted=True)
    cand_pid = torch.gather(pool_id, 1, pos)
    cand_pid = torch.where(torch.isfinite(cand_v_hat), cand_pid, -1)
    a3_min = 2.0 * a3.min(dim=1).values + xx_r[:, 0]
    return C, cand_v_hat, cand_pid, a3_min


def _packed_pool(x, xx, idx: KnnIndex, k: int, wide: bool):
    """The packed kernels' twin pool, its decode and the packing margin.
    Returns (C, cand_v_hat, cand_pid, a3_min, cand_p, e_pack)."""
    T, g, passes, pbits = idx.T, idx.g, idx.passes, idx.pbits
    # the query half-norm rides into the kernel, so packed values are
    # d2/2 — small, and the pack perturbation is relative to them
    xxh = 0.5 * xx if idx.metric != "ip" else torch.zeros_like(xx)
    # the reference pairs chunks at passes=1 on the single-shot forms only
    kw = dict(T=T, g=g, passes=passes, pbits=pbits, xxh=xxh,
              pair=not wide and passes == 1 and (T // _LANES) % 2 == 0)
    if idx.db_dtype == "int8":
        a1p, a2p, a3p = fused_l2_group_topk_packed_q8(
            x, idx.y_q, idx.yyh_k, idx.scales, **kw)
    else:
        kern = (fused_l2_group_topk_packed_dchunk if wide
                else fused_l2_group_topk_packed)
        a1p, a2p, a3p = kern(x, idx.y_hi, idx.y_lo, idx.yyh_k, **kw)
    S_ = a1p.shape[1]
    # twin pool: the Ca smallest bucket minima, each with its a2 twin,
    # pruned back to C by kernel order. topk returns the input's values,
    # so the packed codes survive bit for bit.
    Ca = min(k + _POOL_PAD, S_)
    C = min(k + _POOL_PAD, 2 * Ca)
    a1_sel, pos1 = torch.topk(a1p, Ca, dim=1, largest=False, sorted=True)
    a2_sel = torch.gather(a2p, 1, pos1)
    cands = torch.cat([a1_sel, a2_sel], dim=1)                  # [Q, 2Ca]
    cpos = torch.cat([pos1, pos1], dim=1)
    cand_p, sel = torch.topk(cands, C, dim=1, largest=False, sorted=True)
    pos = torch.gather(cpos, 1, sel)
    cand_pid = decode_packed_pool(cand_p, pos, S_, T, g, pbits)
    cand_v_hat = 2.0 * cand_p                        # = d2 (xx folded in)
    bound_a1 = 2.0 * a1_sel[:, Ca - 1]
    a3_half_min = a3p.min(dim=1).values
    a3_min = torch.minimum(2.0 * a3_half_min, bound_a1)
    # packing margin per query from the magnitudes in play; sentinel terms
    # are left out (see the reference), the θ slot stays unmasked
    half_mag = torch.maximum(
        torch.maximum(_real_half(cand_p[:, 0]),
                      _real_half(cand_p[:, C - 1])),
        torch.maximum(
            torch.maximum(_real_half(a3_half_min),
                          _real_half(a1_sel[:, Ca - 1])),
            cand_p[:, k - 1].abs()))
    e_pack = 8.0 * half_mag * 2.0 ** (pbits - 23)
    return C, cand_v_hat, cand_pid, a3_min, cand_p, e_pack


def _certify(x, xx, idx: KnnIndex, k: int, vals, ids, C: int, cand_v_hat,
             a3_min, e_pack, certify: str, margins: Optional[list] = None):
    """The per-query certificate and the exact fixup of the queries that
    fail it. Returns (vals, ids, n_fail); appends the margin to
    ``margins`` when given."""
    M, passes = idx.prepared_rows, idx.passes
    quant = idx.db_dtype == "int8"
    theta = vals[:, k - 1]
    bound = torch.minimum(a3_min, cand_v_hat[:, C - 1])
    if quant or passes == 3 or certify == "f32":
        d = x.shape[1]
        coeff = _err_bound_coeff(d) if passes == 3 else _err_bound_coeff_p1(d)
        ymax = idx.yy_raw.max().sqrt()       # finite norms (padded rows: 0)
        err = coeff * xx.sqrt() * ymax + e_pack
    else:
        err = e_pack
    if quant:
        # quantization widening (reference :803-822): the kernel scores ŷ,
        # so a row with true d2 < θ has d2(x, ŷ) < (√θ + Eq)²; for ip
        # |x·(ŷ − y)| ≤ ‖x‖·2·Eq (Eq bounds the halved stream operand)
        eq_max = idx.eq_groups.max()
        if idx.metric == "ip":
            err = err + 2.0 * xx.sqrt() * eq_max
        else:
            err = err + 2.0 * theta.clamp_min(0.0).sqrt() * eq_max \
                + eq_max * eq_max
    failed = ~(bound >= theta + err)
    if margins is not None:
        margins.append(bound - (theta + err))

    # ---- fixup: failed queries re-solved exactly, in budgeted chunks ----
    n_fail = int(failed.sum())               # the one host read
    if n_fail:
        vals, ids = vals.clone(), ids.clone()
        fidx = failed.nonzero().squeeze(1)
        F = max(1, _FIXUP_TILE_BUDGET // (M * 4))
        for s in range(0, n_fail, F):
            rows = fidx[s:s + F]
            vals[rows], ids[rows] = _exact_rows(x[rows], idx, k)
    return vals, ids, n_fail


@instrument("distance.knn_fused")
def knn_fused(x, y, k: int, passes: int = 3, T: Optional[int] = None,
              g: Optional[int] = None, metric: str = "l2",
              rescore: Optional[bool] = None, certify: str = "kernel",
              device=None, with_stats: bool = False,
              db_dtype: Optional[str] = None):
    """Certified fused brute-force KNN.

    ``y`` is a raw [m, d] index (prepared per call, streamed as
    ``db_dtype``, default bf16) or a :class:`KnnIndex`, whose
    T/g/passes/metric/db_dtype and device then hold.
    ``metric="l2"`` returns (d2 [Q, k] ascending, ids [Q, k] int32);
    ``metric="ip"`` returns (x·y [Q, k] descending, ids). ``passes=3`` is
    certified exact w.r.t. f32 scores; ``passes=1`` w.r.t. bf16 scores, or
    w.r.t. f32 with ``certify="f32"`` (adaptive precision: the margin is
    widened by the one-pass error bound and failures pay the exact fixup).
    ``rescore`` — None rescores in f32 when the index stores its rows;
    False returns lite results. ``with_stats`` appends the number of
    queries that failed the certificate (and were re-solved exactly).
    An int8 index is always rescored (``rescore=False`` is an error)."""
    fault_point("knn_fused")
    idx = y if isinstance(y, KnnIndex) else None
    if idx is not None:
        passes, metric = idx.passes, idx.metric
        m, d = idx.n_rows, idx.d_orig
        dev = idx.device
        db_dtype = idx.db_dtype
    else:
        dev = resolve_device(device, x, y)
        db_dtype = "bf16" if db_dtype is None else db_dtype
    if db_dtype not in DB_DTYPES:
        raise ValueError(f"knn_fused: db_dtype must be one of "
                         f"{DB_DTYPES}, got {db_dtype!r}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"knn_fused: metric must be 'l2' or 'ip', "
                         f"got {metric!r}")
    if certify not in ("kernel", "f32"):
        raise ValueError(f"knn_fused: certify must be 'kernel' or "
                         f"'f32', got {certify!r}")
    if certify == "f32" and rescore is False:
        raise ValueError("knn_fused: certify='f32' needs the exact "
                         "rescore (θ must be an f32 value)")
    if passes == 3:
        certify = "kernel"          # p3 is already f32-certified
    x = as_f32(x, dev)
    Q, d_x = x.shape
    if idx is None:
        y = as_f32(y, dev)
        m, d = y.shape
    if d_x != d:
        raise ValueError(f"knn_fused: query width {d_x} != index {d}")
    if k > m:
        raise ValueError(f"knn_fused: k={k} > index size {m}")
    if idx is None:
        idx = prepare_knn_index(y, passes=passes, metric=metric, T=T, g=g,
                                db_dtype=db_dtype)
    n_tiles = (max(m, idx.T) + idx.T - 1) // idx.T
    pool = 2 * (-(-n_tiles // idx.g)) * _LANES
    if k > pool:
        raise NotImplementedError(
            f"knn_fused: k={k} too large for pool size {pool} "
            f"(shrink g or T, or use the streamed path)")
    rescore = resolve_rescore(idx, rescore, certify, "knn_fused")
    margins = [] if explain.active() is not None else None
    vals, ids, n_fail = query_prepared(x, idx, k, rescore, certify, margins)
    record_telemetry("distance.knn_fused", idx, k, Q, n_fail, margins,
                     certify=certify)
    if with_stats:
        return vals, ids, n_fail
    return vals, ids


def rescore_pool_width(idx: KnnIndex, k: int) -> int:
    """The exact-rescore candidate pool C of a query of ``idx``: k + 32
    clamped to the kernel's pool (the packed twin pool is 2·Ca of the S
    bucket minima, the unpacked pool 2S)."""
    n_tiles = -(-max(idx.n_rows, idx.T) // idx.T)
    S = -(-n_tiles // idx.g) * _LANES
    if idx.g * (idx.T // _LANES) > (1 << idx.pbits):
        return min(k + _POOL_PAD, 2 * S)
    return min(k + _POOL_PAD, 2 * min(k + _POOL_PAD, S))


def record_telemetry(site: str, idx: KnnIndex, k: int, n_queries: int,
                     n_fail: int, margins: Optional[list], **meta) -> None:
    """The quality and explain record of one certified call (reference
    ``:1736-1755``): the failure count, already an int on the host, is
    queued for the certificate counters, and under an active explain
    capture the per-query margins (still on the card) are noted. Never
    raises into the result path."""
    try:
        record_pending(site, n_fail, n_queries=n_queries,
                       pool_width=rescore_pool_width(idx, k),
                       db_dtype=idx.db_dtype, passes=idx.passes, **meta)
        if margins:
            explain.note_margin(site, margins[0] if len(margins) == 1
                                else torch.cat(margins))
    except Exception:
        pass


def resolve_rescore(idx: KnnIndex, rescore: Optional[bool], certify: str,
                    who: str) -> bool:
    """Whether a query of ``idx`` rescores in f32 (None: when the index
    stores its rows), with the contracts that pin it: rows to rescore
    from, an f32 θ for ``certify="f32"``, and always for an int8 index."""
    if rescore is None:
        rescore = idx.yp is not None
    if rescore and idx.yp is None:
        raise ValueError(f"{who}: rescore=True needs an index that "
                         f"stores its f32 rows (store_yp=True)")
    if certify == "f32" and not rescore:
        raise ValueError(f"{who}: certify='f32' needs a yp-storing "
                         f"index (store_yp=True) for the exact rescore")
    if idx.db_dtype == "int8" and not rescore:
        raise ValueError(f"{who}: an int8-streamed index is always "
                         f"exact-rescored (rescore=False would return the "
                         f"top-k of the quantized score function)")
    return rescore


def query_prepared(x, idx: KnnIndex, k: int, rescore: bool, certify: str,
                   margins: Optional[list] = None):
    """The certified pipeline on validated arguments: ``x`` [Q, d_orig]
    f32 on the index's device, padded here to the stream width and run in
    chunks of ``_Q_CHUNK`` queries. Returns (vals, ids, n_fail) in the
    metric's own order (ip descending); a ``margins`` list receives each
    chunk's certificate margins."""
    Q, d = x.shape
    dpad = idx.stream_width - d
    if dpad:
        x = torch.cat([x, x.new_zeros((Q, dpad))], dim=1)
    outs = [_knn_fused_core(x[s:s + _Q_CHUNK], idx, k, rescore, certify,
                            margins)
            for s in range(0, Q, _Q_CHUNK)]
    if outs:
        vals = torch.cat([o[0] for o in outs])
        ids = torch.cat([o[1] for o in outs])
    else:
        vals = x.new_zeros((0, k))
        ids = torch.zeros((0, k), dtype=torch.int32, device=x.device)
    if idx.metric == "ip":
        vals = -vals                # internal −x·y ascending → IP desc
    return vals, ids, sum(o[2] for o in outs)
