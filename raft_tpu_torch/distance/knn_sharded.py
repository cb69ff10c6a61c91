"""Sharded certified KNN: the database or the queries split over a mesh.

Counterpart of ``raft_tpu/distance/knn_sharded.py`` (ref: the MNMG
brute-force path, per-shard fused L2/top-k whose candidates meet in
``knn_merge_parts``; FAISS's ``IndexShards``). The reference runs one
``shard_map`` program; on an in-process mesh the port runs one controller
(:func:`raft_tpu_torch.parallel.for_each_rank`) that takes each rank's
shard in turn and then merges the ranks' candidates itself. A rank that
runs in a process of its own (a process group) runs the rank-local
:func:`knn_fused_shard`, whose merges are the rank-local collectives of
:class:`~raft_tpu_torch.comms.comms.MeshComms`; both give the same bits.

``shard_mode="db"``: each rank holds a :class:`KnnIndex` over its block
of ``rows_per`` rows (padded to whole certificate groups, the pads masked
by the never-wins sentinel), runs the port's certified pipeline
(:func:`~raft_tpu_torch.distance.knn_fused._knn_fused_core`: K1's packed
kernel, or K2 at ``db_dtype="int8"``) over it, shifts its ids by its row
offset, maps every non-finite candidate to (+inf, −1) as the reference's
shard function does, and merges:

- ``"allgather"``: every rank's [nq, k] candidates gathered, one select
  of k over the rank-major p·k pool;
- ``"tournament"``: log₂(p) butterfly rounds of pair exchanges, each a
  select over 2k, lower rank's candidates first (on the controller, the
  same pair merges as a tree: each round moves one block a pair);
- ``"host"`` (the bottom rung of the ladder, or asked for): no merge
  collective; the ranks' candidates are gathered by the caller and
  selected once, in the same rank-major pool order.

Every select ranks as ``jax.lax.top_k(−v)`` does on the CPU (IEEE total
order on the sign-flipped bits, ties to the lower pool position), so all
three give the same bits, and, since a shard's candidates come sorted by
(value, id), the merged answer is ordered by (value, global id) like the
single-device :func:`~raft_tpu_torch.distance.knn_fused.knn_fused`.
``micro_batches`` splits the queries into blocks, each merged before the
next block's kernel launches.

``shard_mode="query"``: the serving shape, a replicated :class:`KnnIndex`
and the queries split over the ranks; no merge.

The resilience driver walks the reference's ladder: an out-of-memory
halves the query block, then doubles the micro-batches; a device error in
the dispatch or a merge (a failed collective included) steps the merge
down tournament → allgather → host.
"""

from __future__ import annotations

import copy
import math
import os
from typing import List, Optional, Tuple

import torch

from raft_tpu_torch.comms.comms import _count
from raft_tpu_torch.core.error import (DeviceError, OutOfMemoryError,
                                       expects)
from raft_tpu_torch.core.resources import as_f32, resolve_device
from raft_tpu_torch.distance.knn_fused import (
    _LANES, _PACK_BITS, _PBITS_MAX, _Q_CHUNK, DB_DTYPES, KnnIndex,
    _knn_fused_core, _prepare_ops, _prepare_ops_q8,
    auto_pack_bits, fused_config, prepare_knn_index, query_prepared,
    rescore_pool_width, resolve_db_dtype)
from raft_tpu_torch.matrix.select_k_slotted import _smallest
from raft_tpu_torch.observability.costmodel import (MERGE_STRATEGIES,
                                                    choose_merge_strategy)
from raft_tpu_torch.observability.quality import record_pending
from raft_tpu_torch.parallel.mesh import (axis_devices, for_each_rank,
                                          line_mesh)
from raft_tpu_torch.resilience import (PoisonedOutputError, degrade_merge,
                                       fault_point, faults_active,
                                       get_policy_table, record_degradation,
                                       record_exhausted, record_retry)
from raft_tpu_torch.observability.spans import instrument

SHARD_MODES = ("db", "query")

#: the reference's grid orders; a database-major order pads each shard to
#: whole groups of g·T rows, "query" to whole tiles
GRID_ORDERS = ("query", "db", "dbuf")

_SITE = "distance.knn_fused_sharded"


def resolve_merge_strategy(merge: str, p: int, nq: int, k: int,
                           spec=None) -> str:
    """The merge a call runs (reference ``:90``): ``"auto"`` takes the
    cost model's choice on ``spec`` (default the device's figures),
    ``"host"`` is taken as asked, and a tournament on a non-power-of-two
    ``p`` downgrades to the allgather, logged."""
    if merge not in ("auto", "host") + MERGE_STRATEGIES:
        raise ValueError(f"merge must be 'auto', 'host' or one of "
                         f"{MERGE_STRATEGIES}, got {merge!r}")
    if merge == "host":
        return merge
    if merge == "auto":
        return choose_merge_strategy(p, nq, k, spec)
    if merge == "tournament" and (p & (p - 1)):
        from raft_tpu_torch.core.logger import log_warn

        log_warn("merge='tournament' needs a power-of-two shard count "
                 "(got p=%d) — using 'allgather' for this call", p)
        return "allgather"
    return merge


def default_micro_batches(nq: int, Qb: int) -> int:
    """Query blocks when the caller does not say (reference ``:114``): up
    to 4, never smaller than one query block of ``Qb``, and each at most
    ``_Q_CHUNK`` queries."""
    if nq <= max(Qb, 8):
        nb = 1
    else:
        nb = min(4, max(1, nq // max(Qb, 8)))
    return max(nb, -(-nq // _Q_CHUNK))


class ShardedFusedIndex:
    """A database-sharded fused-KNN index (reference ``:128``):
    ``shards[r]`` is rank r's :class:`KnnIndex` over global rows
    [r·rows_per, (r+1)·rows_per), on rank r's device, its pad rows masked
    (``m_valid[r]`` live rows). The tiling, metric and mesh are frozen at
    build (:func:`prepare_knn_index_sharded`)."""

    def __init__(self, shards: List[KnnIndex], m_valid: List[int],
                 n_rows: int, rows_per: int, mesh, axis: str, T: int,
                 Qb: int, g: int, passes: int, metric: str, d_orig: int,
                 pbits: int, grid_order: str, db_dtype: str):
        self.shards = shards
        self.m_valid = m_valid
        self.n_rows = n_rows
        self.rows_per = rows_per
        self.mesh, self.axis = mesh, axis
        self.T, self.Qb, self.g = T, Qb, g
        self.passes, self.metric = passes, metric
        self.d_orig = d_orig
        self.pbits = pbits
        self.grid_order = grid_order
        self.db_dtype = db_dtype

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def stream_width(self) -> int:
        return self.shards[0].stream_width

    @property
    def has_rows(self) -> bool:
        """Whether the shards hold their f32 rows (``store_yp``)."""
        return self.shards[0].yp is not None

    def rows(self) -> torch.Tensor:
        """The index's f32 rows [n_rows, d], gathered on the first
        shard's device (needs ``store_yp``)."""
        expects(self.has_rows, "ShardedFusedIndex.rows: a lite index "
                "keeps no f32 rows")
        dev = self.shards[0].device
        return torch.cat([s.yp[:m, :self.d_orig].to(dev)
                          for s, m in zip(self.shards, self.m_valid)])


def _shard_geometry(m: int, d: int, p: int, passes: int, T, Qb, g,
                    grid_order, db_dtype: str, store_yp: bool):
    cfg = fused_config(passes)
    T = cfg.T if T is None else int(T)
    Qb = cfg.Qb if Qb is None else int(Qb)
    grid_order = cfg.grid_order if grid_order is None else grid_order
    if grid_order not in GRID_ORDERS:
        raise ValueError(f"prepare_knn_index_sharded: grid_order must be "
                         f"one of {GRID_ORDERS}, got {grid_order!r}")
    if db_dtype == "int8":
        grid_order = "db"       # int8 codes are grouped by g·T rows
    expects(T > 0 and T % _LANES == 0,
            "prepare_knn_index_sharded: T=%d must be a positive multiple "
            "of %d", T, _LANES)
    n_ch = T // _LANES
    m_shard = -(-m // p)
    if g is None:
        n_tiles_est = max(1, -(-m_shard // T))
        g = max(cfg.g, (1 << auto_pack_bits(n_tiles_est, T)) // n_ch)
    g = int(g)
    pbits = min(_PBITS_MAX, max(_PACK_BITS, int(math.ceil(math.log2(
        max(g * n_ch, 2))))))
    packed = g * n_ch <= (1 << pbits)
    db_dtype = resolve_db_dtype(db_dtype, d, packed, store_yp)
    if db_dtype == "int8":
        grid_order = "db"
    row_mult = g * T if grid_order in ("db", "dbuf") else T
    rows_per = max(1, -(-m_shard // row_mult)) * row_mult
    return T, Qb, g, pbits, packed, grid_order, db_dtype, rows_per


def _shard_index(y_r, m_loc: int, T: int, g: int, passes: int, metric: str,
                 pbits: int, store_yp: bool, db_dtype: str, Qb: int,
                 d: int) -> KnnIndex:
    """One rank's :class:`KnnIndex` over its padded block ``y_r``
    [rows_per, d_eff]: rows past ``m_loc`` carry the never-wins sentinel
    and never name a result (the reference's ``n_valid``)."""
    rows_per = y_r.shape[0]
    valid = (None if m_loc == rows_per else
             torch.arange(rows_per, device=y_r.device) < m_loc)
    if db_dtype == "int8":
        yp, y_q, scales, yyh_k, yy_raw, eq = _prepare_ops_q8(
            y_r, T, g, metric, valid)
        return KnnIndex(yp, None, None, yyh_k, yy_raw, rows_per, T, g,
                        passes, metric, d, pbits=pbits, rows_valid=valid,
                        Qb=Qb, db_dtype="int8", y_q=y_q, scales=scales,
                        eq_groups=eq)
    yp, y_hi, y_lo, yyh_k, yy_raw = _prepare_ops(y_r, T, g, metric, pbits,
                                                 valid)
    if not store_yp:
        yp = None
        if passes == 1:
            y_lo = None
    return KnnIndex(yp, y_hi, y_lo, yyh_k, yy_raw, rows_per, T, g, passes,
                    metric, d, pbits=pbits, rows_valid=valid, Qb=Qb)


def _mesh_of(mesh, y, res, who: str):
    if mesh is None:
        mesh = (y.mesh if isinstance(y, ShardedFusedIndex)
                else getattr(res, "mesh", None))
    expects(mesh is not None, "%s: pass mesh= or set it on res", who)
    return mesh


def prepare_knn_index_sharded(y, mesh=None, axis: str = "x",
                              passes: int = 3, metric: str = "l2",
                              T: Optional[int] = None,
                              Qb: Optional[int] = None,
                              g: Optional[int] = None,
                              store_yp: bool = True,
                              grid_order: Optional[str] = None,
                              db_dtype: str = "bf16",
                              res=None) -> ShardedFusedIndex:
    """Build a :class:`ShardedFusedIndex` (reference ``:176``): ``y``
    [m, d] (numpy, or a tensor on any device) splits into p blocks of
    ``rows_per`` rows, whole tiles (whole g·T groups for the
    database-major orders and int8), each prepared on its rank's device.
    The tiling resolves against the per-shard shape, as the reference's:
    a 1M-row index over 4 ranks packs like a 250k-row one."""
    mesh = _mesh_of(mesh, y, res, "prepare_knn_index_sharded")
    expects(axis in mesh.axis_names,
            "prepare_knn_index_sharded: axis %r not in mesh axes %s", axis,
            tuple(mesh.axis_names))
    if metric not in ("l2", "ip"):
        raise ValueError(f"prepare_knn_index_sharded: metric must be "
                         f"'l2' or 'ip', got {metric!r}")
    if passes not in (1, 3):
        raise ValueError(f"prepare_knn_index_sharded: passes must be 1 "
                         f"or 3, got {passes}")
    if db_dtype not in DB_DTYPES:
        raise ValueError(f"prepare_knn_index_sharded: db_dtype must be "
                         f"one of {DB_DTYPES}, got {db_dtype!r}")
    devs = axis_devices(mesh, axis)
    src_dev = y.device if isinstance(y, torch.Tensor) else devs[0]
    y = as_f32(y, src_dev)
    m, d = y.shape
    p = len(devs)
    T, Qb, g, pbits, _, grid_order, db_dtype, rows_per = _shard_geometry(
        m, d, p, passes, T, Qb, g, grid_order, db_dtype, store_yp)
    if db_dtype == "int8":
        fault_point("quantize_index")
    shards = [_rank_block(y, r, rows_per, dev, T, g, passes, metric, pbits,
                          store_yp, db_dtype, Qb)
              for r, dev in enumerate(devs)]
    return ShardedFusedIndex([s[0] for s in shards], [s[1] for s in shards],
                             m, rows_per, mesh, axis, T, Qb, g, passes,
                             metric, d, pbits, grid_order, db_dtype)


def _rank_block(y, r: int, rows_per: int, dev, T: int, g: int, passes: int,
                metric: str, pbits: int, store_yp: bool, db_dtype: str,
                Qb: int):
    """Rank r's :class:`KnnIndex` over global rows [r·rows_per,
    (r+1)·rows_per) of ``y``, and its count of real rows."""
    m, d = y.shape
    lo = r * rows_per
    m_loc = int(min(max(m - lo, 0), rows_per))
    y_r = torch.zeros((rows_per, d + (-d) % _LANES), dtype=torch.float32,
                      device=dev)
    if m_loc:
        y_r[:m_loc, :d] = y[lo:lo + m_loc].to(dev)
    return _shard_index(y_r, m_loc, T, g, passes, metric, pbits, store_yp,
                        db_dtype, Qb, d), m_loc


def prepare_knn_index_shard(y, rank: int, n_shards: int, passes: int = 3,
                            metric: str = "l2", T: Optional[int] = None,
                            Qb: Optional[int] = None,
                            g: Optional[int] = None, store_yp: bool = True,
                            grid_order: Optional[str] = None,
                            db_dtype: str = "bf16", device=None
                            ) -> Tuple[KnnIndex, int]:
    """One rank's part of :func:`prepare_knn_index_sharded`, for a rank
    that runs in a process of its own (a process group, see
    :func:`knn_fused_shard`): its :class:`KnnIndex` over its block of
    ``y`` on ``device`` (default ``y``'s device for a tensor, the card
    for numpy; without a card that raises
    :class:`~raft_tpu_torch.core.error.DeviceError`), and its global row
    offset. Every rank must pass the same ``y`` shape and options."""
    dev = resolve_device(device, y)
    y = as_f32(y, y.device if isinstance(y, torch.Tensor) else dev)
    m, d = y.shape
    T, Qb, g, pbits, _, _, db_dtype, rows_per = _shard_geometry(
        m, d, n_shards, passes, T, Qb, g, grid_order, db_dtype, store_yp)
    shard, _ = _rank_block(y, rank, rows_per, dev, T, g, passes, metric,
                           pbits, store_yp, db_dtype, Qb)
    return shard, rank * rows_per


# ------------------------------------------------------------------ merges
def _merge_allgather(comms, p: int, k: int, v, i):
    """Rank-local: every rank's [nq, k] candidates, and the k smallest of
    the rank-major p·k pool (reference ``:288``): the same pool on every
    rank, so the result is replicated bit for bit."""
    return _merge_host_pool(comms.allgather(v), comms.allgather(i), k)


def _merge_tournament(comms, p: int, k: int, v, i):
    """Rank-local: log₂(p) butterfly rounds (reference ``:302``): each
    round a rank swaps its k candidates with rank ^ 2ʲ and keeps the k
    smallest of the pair, the lower rank's candidates first on both
    sides, so partners hold the same result and, by induction, every rank
    does."""
    rr = comms.get_rank()
    rounds = int(math.log2(p)) if p > 1 else 0
    for j in range(rounds):
        dlt = 1 << j
        perm = [(s, s ^ dlt) for s in range(p)]
        ov = comms.collective_permute(v, perm)
        oi = comms.collective_permute(i, perm)
        if rr & dlt == 0:
            v, i = _pair_merge(v, i, ov, oi, k)
        else:
            v, i = _pair_merge(ov, oi, v, i, k)
    return v, i


def _pair_merge(lo_v, lo_i, hi_v, hi_i, k: int):
    """The k smallest of two candidate lists, the lower group's first."""
    cat_v, cat_i = torch.cat([lo_v, hi_v], 1), torch.cat([lo_i, hi_i], 1)
    v, pos = _smallest(cat_v, k)
    return v, torch.gather(cat_i, 1, pos)


def _merge_host_pool(gv, gi, k: int):
    """The bottom rung (reference ``:327``): the ranks' candidates [p, nq,
    k], gathered by the caller, and one select over the rank-major pool,
    the allgather merge's pool, so the bits are the same."""
    p, nq, kk = gv.shape
    pool_v = gv.permute(1, 0, 2).reshape(nq, p * kk)
    pool_i = gi.permute(1, 0, 2).reshape(nq, p * kk)
    vals, pos = _smallest(pool_v, k)
    return vals, torch.gather(pool_i, 1, pos)


#: the rank-local merges (process groups, :func:`knn_fused_shard`)
_RANK_MERGES = {"allgather": _merge_allgather,
                "tournament": _merge_tournament}


def _host_merge(vs, is_, k: int, axis: str):
    """The controller's host merge: the ranks' candidates (rank order)
    stacked on the first rank's device, one select, no collective."""
    dev = vs[0].device
    return _merge_host_pool(torch.stack([v.to(dev) for v in vs]),
                            torch.stack([i.to(dev) for i in is_]), k)


def _gather_merge(vs, is_, k: int, axis: str):
    """The controller's allgather merge: the gather (one copy a rank onto
    the first rank's device, none where the ranks share a card) and the
    host merge's select; counted as the rank-local merge's two
    allgathers."""
    _count("allgather", vs[0], axis)
    _count("allgather", is_[0], axis)
    return _host_merge(vs, is_, k, axis)


def _tree_merge(vs, is_, k: int, axis: str):
    """The controller's tournament: in round j the group of 2ʲ ranks at
    ``lo`` merges with the group at ``lo + 2ʲ`` on ``lo``'s device, the
    lower group first, which is the pair merge both partners of the
    butterfly compute, so the bits are the rank-local tournament's. Each
    round moves one block a pair; counted as the rank-local round's two
    permutes."""
    p = len(vs)
    expects(p & (p - 1) == 0, "tournament merge: p=%d is not a power of "
            "two", p)
    vs, is_ = list(vs), list(is_)
    step = 1
    while step < p:
        _count("collective_permute", vs[0], axis)
        _count("collective_permute", is_[0], axis)
        for lo in range(0, p, 2 * step):
            dev = vs[lo].device
            vs[lo], is_[lo] = _pair_merge(vs[lo], is_[lo],
                                          vs[lo + step].to(dev),
                                          is_[lo + step].to(dev), k)
        step *= 2
    return vs[0], is_[0]


#: the controller's merges of the ranks' candidates (in-process meshes)
_MERGES = {"allgather": _gather_merge, "tournament": _tree_merge,
           "host": _host_merge}


def _shard_candidates(xb, shard: KnnIndex, off: int, k: int, rescore: bool,
                      certify: str):
    """One rank's candidates for a block of queries: the certified
    pipeline over its shard, ids shifted by ``off``, every pad, sentinel
    or non-finite candidate mapped to (+inf, −1) so it loses every merge
    (the reference's shard function). Returns (vals, ids, queries that
    paid the exact fixup)."""
    vals, ids, nf = _knn_fused_core(xb, shard, k, rescore, certify)
    gid = torch.where((ids >= 0) & torch.isfinite(vals), ids + off,
                      -1).to(torch.int32)
    return torch.where(gid >= 0, vals, float("inf")), gid, nf


def _rank_blocks(comms, x, shard: KnnIndex, off: int, k: int,
                 rescore: bool, certify: str, merge_fn, blocks):
    """One rank-local rank's work: its candidates for each query block,
    each block merged by ``merge_fn`` (a rank-local merge). Returns
    (vals, ids, queries that paid the exact fixup)."""
    xr = x.to(shard.device)
    out_v, out_i, nf = [], [], 0
    for s, e in blocks:
        vals, gid, nfb = _shard_candidates(xr[s:e], shard, off, k, rescore,
                                           certify)
        nf += nfb
        vals, gid = merge_fn(comms, comms.get_size(), k, vals, gid)
        out_v.append(vals)
        out_i.append(gid)
    return torch.cat(out_v), torch.cat(out_i), nf


def knn_fused_shard(comms, x, shard: KnnIndex, offset: int, k: int,
                    merge: str = "allgather",
                    micro_batches: Optional[int] = None,
                    rescore: Optional[bool] = None,
                    certify: str = "kernel"):
    """The rank-local database-sharded KNN: this rank's part of
    :func:`knn_fused_sharded`, for ranks that each run their own program
    (a process group, :func:`raft_tpu_torch.comms.process_comms`). Every
    rank passes the same queries ``x``, its shard and offset from
    :func:`prepare_knn_index_shard`, and the same ``merge``
    (``"allgather"`` or ``"tournament"``); every rank returns the merged
    (values, global ids), the same bits on all. ``micro_batches`` as in
    :func:`knn_fused_sharded`."""
    from raft_tpu_torch.distance.knn_fused import resolve_rescore

    expects(merge in MERGE_STRATEGIES, "knn_fused_shard: merge must be "
            "one of %s, got %r", MERGE_STRATEGIES, merge)
    p = comms.get_size()
    merge = resolve_merge_strategy(merge, p, 1, k)
    x = as_f32(x, shard.device)
    nq, d = x.shape
    if shard.stream_width != d:
        x = torch.cat([x, x.new_zeros((nq, shard.stream_width - d))], 1)
    rescore = resolve_rescore(shard, rescore, certify, "knn_fused_shard")
    _, qb_len = _block_geometry(nq, micro_batches, shard.Qb)
    blocks = [(s, min(s + qb_len, nq)) for s in range(0, nq, qb_len)]
    vals, ids, _ = _rank_blocks(comms, x, shard, offset, k, rescore,
                                certify, _RANK_MERGES[merge], blocks)
    return (-vals if shard.metric == "ip" else vals), ids


def _block_geometry(nq: int, nb, Qb_base: int):
    """(micro-batches, queries a block) of a call (reference ``:490``)."""
    nb = default_micro_batches(nq, Qb_base) if nb is None else int(nb)
    nb = max(1, min(nb, nq))
    nb = max(nb, -(-nq // _Q_CHUNK))
    qb0 = -(-nq // nb)
    Qb_eff = min(Qb_base, ((qb0 + 7) // 8) * 8)
    return nb, -(-qb0 // Qb_eff) * Qb_eff


# ------------------------------------------------------------ the entry
@instrument("distance.knn_fused_sharded")
def knn_fused_sharded(x, y, k: int, mesh=None, axis: str = "x",
                      shard_mode: str = "db", merge: str = "auto",
                      micro_batches: Optional[int] = None,
                      passes: int = 3, metric: str = "l2",
                      T: Optional[int] = None, Qb: Optional[int] = None,
                      g: Optional[int] = None,
                      grid_order: Optional[str] = None,
                      db_dtype: str = "bf16",
                      rescore: Optional[bool] = None,
                      certify: str = "kernel", store_yp: bool = True,
                      res=None, with_stats: bool = False):
    """Certified fused brute-force KNN over a mesh (reference ``:343``).

    ``shard_mode="db"``: ``y`` is a raw [m, d] matrix (prepared per call)
    or a :class:`ShardedFusedIndex` (its frozen config holds). Each rank
    runs the certified pipeline over its shard and the candidates merge
    by ``merge`` (``"auto"``: the cost model's choice; see the module
    doc); ``micro_batches`` (None: :func:`default_micro_batches`) splits
    the queries. ``shard_mode="query"``: ``y`` is a raw matrix or a
    :class:`KnnIndex`, replicated; the queries split over the ranks
    (``merge`` and ``micro_batches`` unused).

    Returns :func:`~raft_tpu_torch.distance.knn_fused.knn_fused`'s
    contract: (values [nq, k] ascending, ip descending, global ids [nq,
    k] int32), on the first rank's device; ``with_stats`` appends the
    queries that paid the exact fixup, summed over the shards."""
    if shard_mode not in SHARD_MODES:
        raise ValueError(f"knn_fused_sharded: shard_mode must be one "
                         f"of {SHARD_MODES}, got {shard_mode!r}")
    mesh = _mesh_of(mesh, y, res, "knn_fused_sharded")
    expects(axis in mesh.axis_names,
            "knn_fused_sharded: axis %r not in mesh axes %s", axis,
            tuple(mesh.axis_names))
    if certify not in ("kernel", "f32"):
        raise ValueError(f"knn_fused_sharded: certify must be 'kernel' "
                         f"or 'f32', got {certify!r}")
    line = line_mesh(mesh, axis)
    devs = line.device_list()
    p = len(devs)
    x = as_f32(x, devs[0])
    nq = x.shape[0]

    if shard_mode == "query":
        fault_point("sharded_dispatch")
        out = _knn_query_sharded(x, y, k, line, axis, passes, metric, T,
                                 Qb, g, rescore, certify, db_dtype)
        return out if with_stats else out[:2]

    if isinstance(y, ShardedFusedIndex):
        idx = y
        expects(idx.axis == axis and idx.mesh == mesh,
                "knn_fused_sharded: index prepared for a different "
                "mesh/axis — re-prepare or pass its mesh")
    else:
        idx = prepare_knn_index_sharded(
            y, mesh=mesh, axis=axis, passes=passes, metric=metric, T=T,
            Qb=Qb, g=g, store_yp=store_yp, grid_order=grid_order,
            db_dtype=db_dtype)
    m = idx.n_rows
    expects(k <= m, "knn_fused_sharded: k=%d > index size %d", k, m)
    if x.shape[1] != idx.d_orig:
        raise ValueError(f"knn_fused_sharded: query width {x.shape[1]} "
                         f"!= index {idx.d_orig}")
    if nq == 0:
        out = (x.new_zeros((0, k)),
               torch.zeros((0, k), dtype=torch.int32, device=x.device), 0)
        return out if with_stats else out[:2]
    n_tiles_loc = idx.rows_per // idx.T
    pool_loc = 2 * (-(-n_tiles_loc // idx.g)) * _LANES
    if k > pool_loc:
        raise NotImplementedError(
            f"knn_fused_sharded: k={k} too large for the per-shard "
            f"candidate pool {pool_loc} (fewer shards, or shrink g/T)")
    if rescore is None:
        rescore = idx.has_rows
    if rescore and not idx.has_rows:
        raise ValueError("knn_fused_sharded: rescore=True needs a "
                         "yp-storing index (store_yp=True)")
    if certify == "f32" and not rescore:
        raise ValueError("knn_fused_sharded: certify='f32' needs the "
                         "exact rescore (store_yp=True)")
    if idx.db_dtype == "int8" and not rescore:
        raise ValueError("knn_fused_sharded: an int8-streamed index is "
                         "always exact-rescored")
    d_eff = idx.stream_width
    if d_eff != x.shape[1]:
        x = torch.cat([x, x.new_zeros((nq, d_eff - x.shape[1]))], 1)

    xs = {dv: x.to(dv) for dv in set(devs)}
    offs = [r * idx.rows_per for r in range(p)]

    def _dispatch(merge_eff, nb_in, Qb_base):
        _, qb_len = _block_geometry(nq, nb_in, Qb_base)
        merge_fn = _MERGES[merge_eff]
        out_v, out_i, nf = [], [], 0
        for s in range(0, nq, qb_len):
            e = min(s + qb_len, nq)
            cands = for_each_rank(line, _shard_candidates, [
                (xs[dv][s:e], sh, off, k, rescore, certify)
                for dv, sh, off in zip(devs, idx.shards, offs)])
            nf += sum(c[2] for c in cands)
            vals, ids = merge_fn([c[0] for c in cands],
                                 [c[1] for c in cands], k, axis)
            out_v.append(vals)
            out_i.append(ids)
        return torch.cat(out_v), torch.cat(out_i), nf

    # ---- the resilience driver (reference :564-660) ----------------------
    nb_req = micro_batches
    merge_eff = resolve_merge_strategy(
        merge, p, _block_geometry(nq, nb_req, idx.Qb)[1], k)
    validate = (faults_active()
                or bool(os.environ.get("RAFT_TPU_VALIDATE_OUTPUTS")))
    Qb_base, nb_cur, retries = idx.Qb, nb_req, 0
    while True:
        try:
            poison = fault_point("sharded_dispatch")
            if merge_eff == "tournament":
                fault_point("merge_permute")
            elif merge_eff == "allgather":
                fault_point("merge_allgather")
            vals, ids, n_fail = _dispatch(merge_eff, nb_cur, Qb_base)
            if poison == "nan":
                vals = torch.full_like(vals, float("nan"))
            if validate and not bool(torch.isfinite(vals).all()):
                raise PoisonedOutputError(
                    f"{_SITE}: non-finite values in merged top-k")
            break
        except PoisonedOutputError as e:
            retries += 1
            if retries > get_policy_table().policy_for(_SITE).max_retries:
                record_exhausted(_SITE)
                raise
            record_retry(_SITE, e, retries)
        except OutOfMemoryError:
            nb_now = _block_geometry(nq, nb_cur, Qb_base)[0]
            if Qb_base > 8:
                new_Qb = max(8, (Qb_base // 2) // 8 * 8)
                record_degradation(_SITE, f"fit:Qb:{Qb_base}->{new_Qb}")
                Qb_base = new_Qb
            elif nb_now < min(nq, 64):
                record_degradation(
                    _SITE, f"fit:micro_batches:{nb_now}->{2 * nb_now}")
                nb_cur = min(nq, 2 * nb_now)
            else:
                record_exhausted(_SITE)
                raise
        except DeviceError:
            nxt = degrade_merge(merge_eff)
            if nxt is None:
                record_exhausted(_SITE)
                raise
            record_degradation(_SITE, f"merge:{merge_eff}->{nxt}")
            merge_eff = nxt
    try:
        record_pending(_SITE, n_fail, n_queries=p * nq,
                       pool_width=rescore_pool_width(idx.shards[0], k),
                       db_dtype=idx.db_dtype, merge=merge_eff, shards=p)
    except Exception:
        pass
    if idx.metric == "ip":
        vals = -vals                # internal −x·y ascending → IP desc
    return (vals, ids, n_fail) if with_stats else (vals, ids)


def _index_on(idx: KnnIndex, dev: torch.device) -> KnnIndex:
    """``idx`` with its tensors on ``dev`` (itself when already there)."""
    if idx.device == dev:
        return idx
    out = copy.copy(idx)
    for name, val in vars(idx).items():
        if isinstance(val, torch.Tensor):
            setattr(out, name, val.to(dev))
    return out


def _knn_query_sharded(x, y, k: int, line, axis: str, passes: int,
                       metric: str, T, Qb, g, rescore, certify: str,
                       db_dtype: str):
    """Query-sharded mode (reference ``:668``): the index replicated on
    every rank's device, rank r answering the r-th block of ⌈nq/p⌉
    queries through the certified pipeline; no cross-rank traffic."""
    from raft_tpu_torch.distance.knn_fused import resolve_rescore

    devs = line.device_list()
    p = len(devs)
    if isinstance(y, KnnIndex):
        idx = y
    else:
        idx = prepare_knn_index(as_f32(y, devs[0]), passes=passes,
                                metric=metric, T=T, g=g, Qb=Qb,
                                db_dtype=db_dtype, device=devs[0])
    m = idx.n_rows
    expects(k <= m, "knn_fused_sharded: k=%d > index size %d", k, m)
    if x.shape[1] != idx.d_orig:
        raise ValueError(f"knn_fused_sharded: query width {x.shape[1]} "
                         f"!= index {idx.d_orig}")
    nq = x.shape[0]
    if nq == 0:
        return (x.new_zeros((0, k)),
                torch.zeros((0, k), dtype=torch.int32, device=x.device), 0)
    n_tiles = -(-max(m, idx.T) // idx.T)
    if k > 2 * (-(-n_tiles // idx.g)) * _LANES:
        raise NotImplementedError(
            f"knn_fused_sharded: k={k} too large for the index's pool")
    rescore = resolve_rescore(idx, rescore, certify, "knn_fused_sharded")
    replicas = {d: _index_on(idx, d) for d in set(devs)}
    qs = -(-nq // p)

    def rank_fn(r):
        dev = devs[r]
        xr = x[r * qs:(r + 1) * qs].to(dev)
        return query_prepared(xr, replicas[dev], k, rescore, certify)

    outs = for_each_rank(line, rank_fn, [(r,) for r in range(p)])
    vals = torch.cat([o[0].to(devs[0]) for o in outs])
    ids = torch.cat([o[1].to(devs[0]) for o in outs])
    n_fail = sum(o[2] for o in outs)
    try:
        record_pending(_SITE, n_fail, n_queries=nq,
                       pool_width=rescore_pool_width(idx, k),
                       db_dtype=idx.db_dtype, merge="query_sharded",
                       shards=p)
    except Exception:
        pass
    return vals, ids, n_fail
