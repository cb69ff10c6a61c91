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

Not in this port yet (each raises naming the missing kernel): the
unpacked and d-chunked K1 forms (an index outside the packed-code envelope
or with d > 512) and the int8-streamed index (K2). The reference's grid
orders (query/db/dbuf) are TPU schedules of one function; the port has one
kernel, so there is nothing to choose.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_f32, resolve_device
from raft_tpu_torch.ops.fused_l2_topk import (
    _LANES, _PACK_BITS, _PACK_PAD, _PBITS_MAX, fused_l2_group_topk_packed,
    split_hi_lo)

_D_SINGLE_SHOT = 512
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
    sentinel on padded rows. Returns ``(yp, y_hi, y_lo, yyh_k, yy_raw)``;
    the reference's [8, M] sublane carrier is TPU layout, the port keeps
    [M].

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
    if metric == "ip":
        # r = 0/2 − x·(y/2) = −x·y/2, so the score −x·y = 2·r
        y_hi, y_lo = split_hi_lo(yp * 0.5)
        yyh_k = torch.where(valid, 0.0, _PACK_PAD)
    else:
        y_hi, y_lo = split_hi_lo(yp)
        yyh_k = torch.where(valid, 0.5 * yy_raw, _PACK_PAD)
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


def fused_eligible(n_rows: int, d: int, device) -> bool:
    """The fused pipeline's gate: a CUDA device and a shape inside the
    ported packed kernel's envelope (shared by ``knn``'s auto routing)."""
    return (torch.device(device).type == "cuda" and n_rows >= 4096
            and d <= _D_SINGLE_SHOT)


def _bf16_from_numpy(a, device) -> torch.Tensor:
    a = np.array(a, order="C")    # a writable copy (JAX exports read-only)
    if a.dtype.name == "bfloat16":             # ml_dtypes, as JAX exports
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(a, dtype=torch.float32).to(
        device=device, dtype=torch.bfloat16)


class KnnIndex:
    """Prepared fused-KNN index: the index-side operands computed once
    (row padding, bf16 hi/lo split, norms and sentinel carrier), with the
    tiling, passes and metric frozen at build. Build with
    :func:`prepare_knn_index` or :meth:`from_numpy`; query with
    ``knn_fused(x, index, k)`` or ``distance.knn(res, index, queries, k)``.
    ``yp`` (the row-padded f32 rows) is None for a lite index."""

    def __init__(self, yp, y_hi, y_lo, yyh_k, yy_raw, n_rows: int, T: int,
                 g: int, passes: int, metric: str, d_orig: int,
                 pbits: int = _PACK_BITS, rows_valid=None):
        self.yp = yp
        self.y_hi, self.y_lo = y_hi, y_lo
        self.yyh_k, self.yy_raw = yyh_k, yy_raw
        self.n_rows = n_rows
        self.T, self.g = T, g
        self.passes, self.metric = passes, metric
        self.d_orig = d_orig
        self.pbits = pbits
        # [M] bool live mask of a ragged index (None: the first n_rows
        # rows are live)
        self.rows_valid = rows_valid

    def live_columns(self) -> torch.Tensor:
        """[M] bool: the prepared rows a result may name."""
        col = torch.arange(self.y_hi.shape[0], device=self.device)
        live = col < self.n_rows
        return live if self.rows_valid is None else live & self.rows_valid

    @property
    def device(self) -> torch.device:
        return self.y_hi.device

    @property
    def stream_width(self) -> int:
        """Feature width of the streamed operand (queries pad to it)."""
        return self.y_hi.shape[1]

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "KnnIndex":
        """The port's index from a reference ``KnnIndex``'s state as
        numpy: ``yp`` (or None), ``y_hi``, ``y_lo`` (or None), ``yyh_k``
        ([8, M] or [M]), ``yy_raw`` ([1, M] or [M]), and the scalars
        ``n_rows, T, g, passes, metric, d_orig, pbits``. Queries against
        it give the reference index's answers."""
        dev = resolve_device(device)

        def f32(a):
            return None if a is None else as_f32(np.asarray(a), dev)

        yyh = np.asarray(arrays["yyh_k"])
        y_lo = arrays.get("y_lo")
        return cls(
            f32(arrays.get("yp")), _bf16_from_numpy(arrays["y_hi"], dev),
            None if y_lo is None else _bf16_from_numpy(y_lo, dev),
            f32(yyh[0] if yyh.ndim == 2 else yyh),
            f32(np.asarray(arrays["yy_raw"]).reshape(-1)),
            int(arrays["n_rows"]), int(arrays["T"]), int(arrays["g"]),
            int(arrays["passes"]), str(arrays["metric"]),
            int(arrays["d_orig"]), int(arrays["pbits"]))


def _missing_kernel(what: str):
    raise NotImplementedError(
        f"knn_fused: {what} — that kernel is not ported to the GPU yet")


def prepare_knn_index(y, passes: int = 3, metric: str = "l2",
                      T: Optional[int] = None, g: Optional[int] = None,
                      store_yp: bool = True, device=None,
                      rows_valid=None) -> KnnIndex:
    """Build a :class:`KnnIndex` for repeated queries against ``y``
    (numpy or tensor; ``device=None`` is ``y``'s device, else ``cuda``).

    ``store_yp=False`` builds a lite index without the f32 rows: queries
    then return the exact top-k of the kernel score function (bf16 /
    bf16x3), values within 2^(pbits−23) relative. ``rows_valid`` ([m]
    bool) marks the live rows of a ragged slab (the IVF-Flat layout);
    results then never name a masked row, and positions are slab rows."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"prepare_knn_index: metric must be 'l2' or "
                         f"'ip', got {metric!r}")
    if passes not in (1, 3):
        raise ValueError(f"prepare_knn_index: passes must be 1 or 3, got "
                         f"{passes}")
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
    if g * n_ch > (1 << pbits):
        _missing_kernel(
            f"g·T/128 = {g * n_ch} codes exceed the packed envelope and "
            f"need the unpacked group kernel (raft_tpu/ops/"
            f"fused_l2_topk_pallas.py:1230, fused_l2_group_topk)")
    if d > _D_SINGLE_SHOT:
        _missing_kernel(
            f"d={d} > {_D_SINGLE_SHOT} needs the d-chunked kernel "
            f"(fused_l2_topk_pallas.py:1294, "
            f"fused_l2_group_topk_packed_dchunk)")
    dpad = (-d) % _LANES
    if dpad:
        y = torch.cat([y, y.new_zeros((m, dpad))], dim=1)
    if rows_valid is not None:
        rows_valid = torch.as_tensor(rows_valid, device=dev).reshape(-1).to(
            torch.bool)
        if rows_valid.shape[0] != m:
            raise ValueError(f"prepare_knn_index: rows_valid has "
                             f"{rows_valid.shape[0]} entries for {m} rows")
        rows_valid = torch.cat([rows_valid,
                                rows_valid.new_zeros((-m) % T)])
    yp, y_hi, y_lo, yyh_k, yy_raw = _prepare_ops(y, T, g, metric, pbits,
                                                 rows_valid)
    if not store_yp:
        yp = None
        if passes == 1:
            y_lo = None    # the 1-pass kernel and lite fixup never read it
    return KnnIndex(yp, y_hi, y_lo, yyh_k, yy_raw, m, T, g, passes, metric,
                    d, pbits=pbits, rows_valid=rows_valid)


def _exact_rows(xq, idx: KnnIndex, k: int):
    """Exact top-k of a [F, d] query block against the whole index: f32
    against the stored rows, or — lite index — the kernel's own bf16(x3)
    score function, which lite results are certified against."""
    y_hi, y_lo = idx.y_hi, idx.y_lo
    if idx.yp is not None:
        s = xq @ idx.yp.T
    else:
        xhi = xq.to(torch.bfloat16)
        s = xhi.float() @ y_hi.float().T
        if idx.passes == 3:
            xlo = (xq - xhi.float()).to(torch.bfloat16)
            s = s + xhi.float() @ y_lo.float().T
            s = s + xlo.float() @ y_hi.float().T
    if idx.metric == "ip":
        # lite operands are the split of y/2: −x·y = −2·s there
        d2 = -s if idx.yp is not None else -2.0 * s
    else:
        xs = (xq * xq).sum(1)
        d2 = (xs[:, None] + idx.yy_raw[None, :] - 2.0 * s).clamp_min(0.0)
    d2 = d2.masked_fill(~idx.live_columns()[None, :], float("inf"))
    vals, ids = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    ids = torch.where(torch.isfinite(vals), ids, -1)
    return vals, ids.to(torch.int32)


def _real_half(v):
    return torch.where(v < _PACK_PAD * 0.25, v.abs(), 0.0)


def _knn_fused_core(x, idx: KnnIndex, k: int, rescore: bool,
                    certify: str):
    """Certified fused KNN on prepared operands; ``x`` [Q, stream_width]
    f32. Returns (scores [Q, k] ascending, ids [Q, k], n_fail): the score
    is d2 for l2 and −x·y for ip."""
    Q = x.shape[0]
    T, g, passes, pbits = idx.T, idx.g, idx.passes, idx.pbits
    M = idx.y_hi.shape[0]
    xx = (x * x).sum(1)                                         # [Q]
    # the query half-norm rides into the kernel, so packed values are
    # d2/2 — small, and the pack perturbation is relative to them
    xxh = 0.5 * xx if idx.metric != "ip" else torch.zeros_like(xx)
    a1p, a2p, a3p = fused_l2_group_topk_packed(
        x, idx.y_hi, idx.y_lo, idx.yyh_k, T=T, g=g, passes=passes,
        pair=passes == 1 and (T // _LANES) % 2 == 0, pbits=pbits, xxh=xxh)
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

    if rescore:
        safe_pid = cand_pid.long().clamp(0, max(idx.n_rows, 1) - 1)
        yc = idx.yp[safe_pid]                                   # [Q, C, d]
        dot = torch.einsum("qd,qcd->qc", x, yc)
        if idx.metric == "ip":
            d2c = -dot
        else:
            d2c = ((xx[:, None] + (yc * yc).sum(2)) - 2.0 * dot
                   ).clamp_min(0.0)
        d2c = d2c.masked_fill(cand_pid < 0, float("inf"))
        vals, ord_k = torch.topk(d2c, k, dim=1, largest=False, sorted=True)
        ids = torch.gather(cand_pid, 1, ord_k)
    else:
        # lite: candidates are sorted by kernel order, so the head is the
        # result; only the code bits are cleared from the values
        clean = (cand_p.view(torch.int32) & ~((1 << pbits) - 1)).view(
            torch.float32)
        vals = 2.0 * clean[:, :k]
        if idx.metric != "ip":
            vals = vals.clamp_min(0.0)
        ids = cand_pid[:, :k]
        vals = vals.masked_fill(ids < 0, float("inf"))

    # ---- certificate ----
    theta = vals[:, k - 1]
    bound = torch.minimum(a3_min, cand_v_hat[:, C - 1])
    if passes == 3 or certify == "f32":
        d = x.shape[1]
        coeff = _err_bound_coeff(d) if passes == 3 else _err_bound_coeff_p1(d)
        ymax = idx.yy_raw.max().sqrt()       # finite norms (padded rows: 0)
        err = coeff * xx.sqrt() * ymax + e_pack
    else:
        err = e_pack
    failed = ~(bound >= theta + err)

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


def knn_fused(x, y, k: int, passes: int = 3, T: Optional[int] = None,
              g: Optional[int] = None, metric: str = "l2",
              rescore: Optional[bool] = None, certify: str = "kernel",
              device=None, with_stats: bool = False):
    """Certified fused brute-force KNN.

    ``y`` is a raw [m, d] index (prepared per call) or a
    :class:`KnnIndex`, whose T/g/passes/metric and device then hold.
    ``metric="l2"`` returns (d2 [Q, k] ascending, ids [Q, k] int32);
    ``metric="ip"`` returns (x·y [Q, k] descending, ids). ``passes=3`` is
    certified exact w.r.t. f32 scores; ``passes=1`` w.r.t. bf16 scores, or
    w.r.t. f32 with ``certify="f32"`` (adaptive precision: the margin is
    widened by the one-pass error bound and failures pay the exact fixup).
    ``rescore`` — None rescores in f32 when the index stores its rows;
    False returns lite results. ``with_stats`` appends the number of
    queries that failed the certificate (and were re-solved exactly)."""
    idx = y if isinstance(y, KnnIndex) else None
    if idx is not None:
        passes, metric = idx.passes, idx.metric
        m, d = idx.n_rows, idx.d_orig
        dev = idx.device
    else:
        dev = resolve_device(device, x, y)
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
        idx = prepare_knn_index(y, passes=passes, metric=metric, T=T, g=g)
    n_tiles = (max(m, idx.T) + idx.T - 1) // idx.T
    pool = 2 * (-(-n_tiles // idx.g)) * _LANES
    if k > pool:
        raise NotImplementedError(
            f"knn_fused: k={k} too large for pool size {pool} "
            f"(shrink g or T, or use the streamed path)")
    if rescore is None:
        rescore = idx.yp is not None
    if rescore and idx.yp is None:
        raise ValueError("knn_fused: rescore=True needs an index that "
                         "stores its f32 rows (store_yp=True)")
    if certify == "f32" and not rescore:
        raise ValueError("knn_fused: certify='f32' needs a yp-storing "
                         "index (store_yp=True) for the exact rescore")
    dpad = idx.stream_width - d
    if dpad:
        x = torch.cat([x, x.new_zeros((Q, dpad))], dim=1)
    outs = [_knn_fused_core(x[s:s + _Q_CHUNK], idx, k, rescore, certify)
            for s in range(0, Q, _Q_CHUNK)]
    if outs:
        vals = torch.cat([o[0] for o in outs])
        ids = torch.cat([o[1] for o in outs])
    else:
        vals = x.new_zeros((0, k))
        ids = torch.zeros((0, k), dtype=torch.int32, device=dev)
    if metric == "ip":
        vals = -vals                # internal −x·y ascending → IP desc
    if with_stats:
        return vals, ids, sum(o[2] for o in outs)
    return vals, ids
