"""IVF-Flat: inverted-list ANN over the port's fused KNN primitives.

Counterpart of ``raft_tpu/ann/ivf_flat.py`` (ref: neighbors/ivf_flat.cuh):
past the brute-force stream, the only speedup left is reading less of the
database, and IVF-Flat reads ``n_probes / n_lists`` of it.

Index layout (:func:`build_ivf_flat`): rows bucketed by nearest coarse
centroid (balanced k-means, :mod:`raft_tpu_torch.cluster`), each inverted
list padded to the row quantum, lists back to back in one [R, d] slab
(``offsets`` / ``sizes`` / ``padded_sizes``, global ``ids`` with −1 on
pads); ``db_dtype="int8"`` adds a per-list symmetric int8 copy of the slab.

Search (:func:`search_ivf_flat`):

1. coarse probe: the ``n_probes`` nearest centroids per query, through the
   streamed ``distance.fused_l2nn.knn`` sweep;
2. fine scan, one of two schedules (:func:`resolve_fine_scan`):
   ``"query"`` gathers each query's probed windows and scores them in f32
   (plain torch); ``"list"`` runs the list-major kernel K4
   (``ops.fine_scan``), which reads each probed list once per batch and
   keeps a 256-slot candidate pool per query, exact-rescores the pool,
   and certifies per query that nothing outside the pool can beat the
   k-th value. Queries that fail the certificate rerun query-major — the
   algorithm, not a fallback: a K4 failure to build or launch on the card
   raises. The int8 query-major scan keeps a certified pool likewise and
   reruns its failures in f32. Every exact answer is finished by
   :func:`_rescore_smallest` (one row-wise dot a candidate, in the
   query-major candidate order), so the schedule, the batch and the rung
   a query takes change none of its bits;
3. ``n_probes ≥ n_lists`` (or ``k`` beyond the probed capacity) is the
   degenerate-exact plane: the certified fused pipeline (K1) over the
   whole ragged slab, whose pads ride K1's never-wins sentinel.

The certificates feed the quality counters and, under an active explain
capture, the explain record (plane, probes, schedule, margins, reruns);
``RAFT_TPU_IVF_FINE_SCAN`` picks the schedule of callers that pass none.
The sharded index (:class:`ShardedIvfIndex`, :func:`shard_ivf_lists`,
reference ``:1168-1424``) spreads whole lists over a mesh axis; its search
scans query-major on every rank (each rank its own probed lists) and the
ranks' top-k merge as the sharded KNN's do (``merge``). Left out:
``warm_fine_scan`` (serving), the TPU tune table, and the reference's
flight markers, fault sites and ``@instrument`` wrappers here.
"""

from __future__ import annotations

import logging
from typing import NamedTuple, Optional

import numpy as np
import torch

from raft_tpu_torch.core import env
from raft_tpu_torch.core.error import LogicError, expects
from raft_tpu_torch.core.kvp import order_key
from raft_tpu_torch.core.resources import (DeviceResources, as_f32,
                                           ensure_resources, resolve_device)
from raft_tpu_torch.observability import explain
from raft_tpu_torch.observability.quality import (record_certificate,
                                                  record_pending)
from raft_tpu_torch.ops.fine_scan import (
    LISTS_PER_CELL, MAX_D, fine_scan_list_major, fine_scan_list_major_q8,
    max_list_chunk, pad_window)

_log = logging.getLogger(__name__)

#: inverted-list row quantum: every list pads to a multiple of this
DEFAULT_ROW_QUANTUM = 8

#: query-major gather budget: queries chunk so the [nq, P·W, d] candidate
#: tile stays under ~256 MB f32
_FINE_TILE = 1 << 26

IVF_DB_DTYPES = ("f32", "int8")

#: candidates exact-rescored per query beyond k by the int8 gather scan
_IVF_RESCORE_PAD = 32

#: certificate counters' and explain margins' call site
_SITE = "ann.search_ivf_flat"

#: fine-scan schedules; "auto" runs the cost-model crossover
FINE_SCANS = ("auto", "query", "list")

#: list-major envelope: k must leave headroom in the 256-slot pool, or
#: the completeness certificate fails every query
_LIST_K_MAX = 96


class IvfFlatIndex:
    """The padded ragged IVF-Flat index (see the module doc). Built by
    :func:`build_ivf_flat` or carried over from the reference's arrays by
    :meth:`from_numpy`; queried by :func:`search_ivf_flat`."""

    def __init__(self, centroids, slab, ids, yy_slab, offsets, sizes,
                 padded_sizes, n_rows: int, d_orig: int, row_quantum: int,
                 n_probes_default: int, kmeans_iters: int = 0,
                 db_dtype: str = "f32",
                 slab_q=None, row_scale=None, yy_q=None, eq_rows=None):
        self.centroids = centroids          # [L, d] f32
        self.slab = slab                    # [R, d] f32 (pad rows zero)
        self.ids = ids                      # [R] int32 global ids, −1 pads
        self.yy_slab = yy_slab              # [R] f32 row norms (pads 0)
        self.offsets = offsets              # [L+1] int32 slab row offsets
        self.sizes = sizes                  # [L] int32 real list lengths
        self.padded_sizes = padded_sizes    # [L] int32 quantum-padded
        self.n_rows = int(n_rows)
        self.d_orig = int(d_orig)
        self.row_quantum = int(row_quantum)
        self.n_probes_default = int(n_probes_default)
        self.kmeans_iters = int(kmeans_iters)
        # int8 sidecar: per-row copies of the list scale and Eq bound, and
        # the dequantized row norms the approximate scorers use
        self.db_dtype = db_dtype
        self.slab_q = slab_q                # [R, d] int8 or None
        self.row_scale = row_scale          # [R] f32
        self.yy_q = yy_q                    # [R] f32
        self.eq_rows = eq_rows              # [R] f32
        # host copies of the geometry for build_list_schedule
        self._np_offsets = offsets.cpu().numpy()
        self._np_sizes = sizes.cpu().numpy()
        self._np_padded = padded_sizes.cpu().numpy()
        self._fused_ops = None
        self._list_host = None

    @property
    def device(self) -> torch.device:
        return self.slab.device

    @property
    def n_lists(self) -> int:
        return int(self.sizes.shape[0])

    @property
    def probe_window(self) -> int:
        """Per-probe gather window: the largest padded list."""
        return max(int(self._np_padded.max()), self.row_quantum)

    @property
    def slab_rows(self) -> int:
        return int(self.slab.shape[0])

    def __repr__(self):
        return (f"IvfFlatIndex(n_rows={self.n_rows}, "
                f"n_lists={self.n_lists}, d={self.d_orig}, "
                f"slab_rows={self.slab_rows}, window={self.probe_window}, "
                f"db_dtype={self.db_dtype})")

    def layout(self):
        """This index's slab as an :class:`~raft_tpu_torch.mutable.layout.
        IndexLayout`."""
        from raft_tpu_torch.mutable.layout import IndexLayout

        return IndexLayout(
            self.slab, self.ids, self.ids >= 0, n_rows=self.n_rows,
            d_orig=self.d_orig, offsets=self.offsets, sizes=self.sizes,
            padded_sizes=self.padded_sizes, row_quantum=self.row_quantum,
            db_dtype=self.db_dtype, slab_q=self.slab_q,
            row_scale=self.row_scale, eq_rows=self.eq_rows)

    @classmethod
    def from_numpy(cls, arrays: dict, device=None) -> "IvfFlatIndex":
        """The port's index from a reference ``IvfFlatIndex``'s state as
        numpy: ``centroids, slab, ids, yy_slab, offsets, sizes,
        padded_sizes`` and the scalars ``n_rows, d_orig, row_quantum,
        n_probes_default`` (``kmeans_iters`` optional); an
        int8 index adds ``db_dtype="int8"``, ``slab_q, row_scale, yy_q,
        eq_rows``. Both packages then search the same index."""
        dev = resolve_device(device)

        def f32(name):
            a = arrays.get(name)
            return None if a is None else as_f32(np.asarray(a), dev)

        def i32(name, dt=np.int32):
            a = arrays.get(name)
            return None if a is None else torch.from_numpy(
                np.array(a, dtype=dt)).to(dev)

        return cls(
            f32("centroids"), f32("slab"), i32("ids"),
            f32("yy_slab").reshape(-1), i32("offsets"), i32("sizes"),
            i32("padded_sizes"), int(arrays["n_rows"]),
            int(arrays["d_orig"]), int(arrays["row_quantum"]),
            int(arrays["n_probes_default"]),
            int(arrays.get("kmeans_iters", 0)),
            db_dtype=str(arrays.get("db_dtype", "f32")),
            slab_q=i32("slab_q", np.int8), row_scale=f32("row_scale"),
            yy_q=f32("yy_q"), eq_rows=f32("eq_rows"))


def require_finite_rows(y, who: str) -> None:
    """Raise :class:`LogicError` naming the first row of ``y`` that holds
    a NaN or ±inf. Such a row has no nearest centroid, so k-means
    labels it (and, once it has made a centroid non-finite, every row)
    2³¹ − 1; the reference's build then sizes its inverted lists by that
    label (``np.bincount``: 2³¹ counters, 17 GB) instead of refusing."""
    bad = (~torch.isfinite(y).all(1)).nonzero()
    if bad.numel():
        raise LogicError(f"{who}: row {int(bad[0, 0])} holds a NaN or ±inf "
                         f"({bad.shape[0]} such rows); it has no nearest "
                         f"list")


def build_ivf_flat(res, y, n_lists: int, n_probes: Optional[int] = None,
                   max_iter: int = 10, seed: int = 0, balanced: bool = True,
                   row_quantum: int = DEFAULT_ROW_QUANTUM,
                   max_train_rows: Optional[int] = None,
                   db_dtype: str = "f32") -> IvfFlatIndex:
    """Build an :class:`IvfFlatIndex` over ``y`` [m, d] (numpy, or a
    tensor whose device the index takes; else the handle's device).

    Coarse training runs balanced k-means on at most ``max_train_rows``
    rows (default ``max(32·n_lists, 4096)``, drawn with numpy's
    ``default_rng(seed)`` as the reference draws them), every row is
    assigned by the argmin sweep, and the lists are laid out as the padded
    ragged slab. ``db_dtype="int8"`` adds the per-list int8 slab."""
    from raft_tpu_torch.cluster import kmeans_fit, kmeans_predict
    from raft_tpu_torch.mutable.layout import (quantize_layout,
                                               ragged_layout_from_lists)

    if db_dtype not in IVF_DB_DTYPES:
        raise ValueError(f"build_ivf_flat: db_dtype must be one of "
                         f"{IVF_DB_DTYPES}, got {db_dtype!r}")
    res = ensure_resources(res)
    dev = y.device if isinstance(y, torch.Tensor) else res.device
    y = as_f32(y, dev)
    m, d = y.shape
    L = int(n_lists)
    expects(L >= 1, "build_ivf_flat: n_lists must be >= 1, got %d", L)
    expects(L <= m, "build_ivf_flat: n_lists=%d > %d rows", L, m)
    expects(row_quantum >= 1, "build_ivf_flat: row_quantum must be >= 1")
    require_finite_rows(y, "build_ivf_flat")
    cap = max_train_rows or max(32 * L, 4096)
    train = y
    if m > cap:
        rng = np.random.default_rng(seed)
        train = y[torch.from_numpy(rng.choice(m, cap, replace=False)).to(
            dev)]
    km = kmeans_fit(res, train, L, max_iter=max_iter, seed=seed,
                    balanced=balanced)
    labels = kmeans_predict(res, km.centroids, y)
    lay = ragged_layout_from_lists(y, labels, L, row_quantum)
    n_probes_default = int(n_probes) if n_probes else max(
        1, min(L, 1 + L // 8))
    q8_kw = {}
    if db_dtype == "int8":
        lay = quantize_layout(lay)
        deq = lay.slab_q.float() * lay.row_scale[:, None]
        q8_kw = dict(db_dtype="int8", slab_q=lay.slab_q,
                     row_scale=lay.row_scale, yy_q=(deq * deq).sum(1),
                     eq_rows=lay.eq_rows)
    return IvfFlatIndex(
        km.centroids, lay.slab, lay.ids, (lay.slab * lay.slab).sum(1),
        lay.offsets, lay.sizes, lay.padded_sizes, n_rows=m, d_orig=d,
        row_quantum=row_quantum, n_probes_default=n_probes_default,
        kmeans_iters=km.n_iter, **q8_kw)


# --------------------------------------------------- query-major fine scan
def _smallest(v, k: int):
    """The ``k`` smallest of each row, ascending; equal values keep their
    column order, XLA's ``top_k`` rule, so ties break as the reference's."""
    vals, pos = torch.sort(v, dim=1, stable=True)
    return vals[:, :k], pos[:, :k]


def _probe_rows(slab, ids, starts, psizes, W: int):
    """Slab rows of each query's probe windows, [nq, P·W], and which of
    them are live."""
    nq, P = starts.shape
    ar = torch.arange(W, device=starts.device)
    rows = starts.long()[:, :, None] + ar
    within = (ar < psizes[:, :, None]).reshape(nq, P * W)
    rows = rows.clamp(0, slab.shape[0] - 1).reshape(nq, P * W)
    cid = ids[rows]
    return rows, cid, within & (cid >= 0)


def _scores(x, xx, yc, yy):
    """``xx + yy − 2·x·y`` in f32 as one batched product: it only
    nominates candidates (its rounding depends on the batch shape); the
    values returned come from :func:`_rescore_smallest`."""
    return xx + yy - 2.0 * torch.einsum("qd,qcd->qc", x, yc)


def _rescore_smallest(x, xx, rows, cid, slab, yy_slab, k: int):
    """The top-k of candidate slab ``rows`` [nq, C] (their ids ``cid``,
    −1 = none, scored +inf), taken in the given candidate order (equal
    values keep it, XLA's tie rule): each candidate rescored exactly in
    f32 as ``(xx + yy) − 2·x·y``, one row-wise dot a candidate rather than
    a batched product, so a query's values do not depend on the batch, the
    schedule or the rung it rides in (a served request equals the query
    asked alone). Every exact IVF answer is finished here."""
    rc = rows.long().clamp_min(0)
    dot = (slab[rc] * x[:, None, :]).sum(2)
    d2 = torch.where(cid >= 0, ((xx + yy_slab[rc]) - 2.0 * dot)
                     .clamp_min(0.0), float("inf"))
    vals, pos = _smallest(d2, k)
    out = torch.gather(cid, 1, pos)
    return vals, torch.where(torch.isfinite(vals), out, -1)


def _nominate_columns(d2, C: int):
    """The columns of each row's ``C`` smallest values, in column order.
    The key (value, column) is unique, so the set does not depend on the
    top-k algorithm a batch size selects."""
    return torch.sort(torch.topk(order_key(d2), C, dim=1,
                                 largest=False).indices, dim=1).values


def _fine_scan(x, slab, ids, yy_slab, starts, psizes, k: int, P: int,
               W: int):
    """Score the probed windows in f32 and select the top-k (reference
    ``:313``). ``starts`` / ``psizes`` [nq, P]: slab offsets and padded
    lengths of the probed lists. The batched product only nominates each
    query's k + 32 best candidates; :func:`_rescore_smallest` scores them
    in the query-major candidate order (probe slot × window column), as
    the list-major pool finish does, so both schedules give the same
    bits."""
    rows, cid, valid = _probe_rows(slab, ids, starts, psizes, W)
    xx = (x * x).sum(1, keepdim=True)
    d2 = _scores(x, xx, slab[rows], yy_slab[rows])
    d2 = torch.where(valid, d2.clamp_min(0.0), float("inf"))
    pos = _nominate_columns(d2, min(k + _IVF_RESCORE_PAD, P * W))
    return _rescore_smallest(x, xx, torch.gather(rows, 1, pos),
                             torch.gather(torch.where(valid, cid, -1), 1,
                                          pos), slab, yy_slab, k)


def _fine_scan_q8(x, slab, slab_q, row_scale, ids, yy_slab, yy_q, eq_rows,
                  starts, psizes, k: int, P: int, W: int, C: int):
    """The int8 gather scan (reference ``:344``): approximate scores
    against the dequantized rows ŷ, the top ``C`` kept and exact-rescored
    from the f32 slab, and a per-query certificate that the true top-k
    cannot hide outside the pool. Returns (vals, ids, certified,
    margin)."""
    rows, cid, valid = _probe_rows(slab_q, ids, starts, psizes, W)
    yc = slab_q[rows].float() * row_scale[rows][:, :, None]
    xx = (x * x).sum(1, keepdim=True)
    yyq = yy_q[rows]
    d2h = torch.where(valid, _scores(x, xx, yc, yyq).clamp_min(0.0),
                      float("inf"))
    del yc
    approx, cpos = _smallest(d2h, C)
    bound = approx[:, C - 1]
    # the pool in the query-major candidate order, rescored as the f32
    # scan rescores, so a certified answer has the f32 scan's bits
    cpos = torch.sort(cpos, dim=1).values
    vals, out = _rescore_smallest(
        x, xx, torch.gather(rows, 1, cpos),
        torch.gather(torch.where(valid, cid, -1), 1, cpos), slab, yy_slab, k)
    theta = vals[:, k - 1]
    eq_w = torch.where(valid, eq_rows[rows], 0.0).max(1).values
    yymax = torch.where(valid, yyq, 0.0).max(1).values
    e_num = (x.shape[1] * 2.0 ** -22) * (xx[:, 0].sqrt()
                                          + yymax.sqrt()) ** 2
    sq_t = theta.clamp_min(0.0).sqrt()
    widen = 2.0 * sq_t * eq_w + eq_w * eq_w + e_num
    n_valid = valid.sum(1)
    certified = (bound >= theta + widen) | (n_valid <= C) \
        | ~torch.isfinite(bound)
    return vals, out, certified, bound - (theta + widen)


def _query_major_chunk(index: IvfFlatIndex, xs, st, ps, k: int, P: int,
                       W: int):
    """One query-major chunk: the f32 gather scan, or the certified int8
    one with its failed queries rerun in f32. Returns (vals, ids,
    reruns)."""
    if index.db_dtype != "int8":
        return (*_fine_scan(xs, index.slab, index.ids, index.yy_slab, st, ps,
                            k, P, W), 0)
    C = min(k + _IVF_RESCORE_PAD, P * W)
    vals, ids_c, ok, margin = _fine_scan_q8(
        xs, index.slab, index.slab_q, index.row_scale, index.ids,
        index.yy_slab, index.yy_q, index.eq_rows, st, ps, k, P, W, C)
    explain.note_margin(_SITE, margin)
    bad = (~ok).nonzero().squeeze(1)
    n_fail = int(bad.numel())
    # this path reads the failure count on the host anyway (it decides
    # the rerun), so the certificate counters cost nothing more
    record_certificate(_SITE, n_queries=int(xs.shape[0]), n_fail=n_fail,
                       pool_width=C, fixup_rows=n_fail or None,
                       rerun=bool(n_fail), db_dtype="int8", n_probes=P)
    if n_fail:
        explain.note(rerun="q8_exact", rerun_rows=n_fail)
        vals[bad], ids_c[bad] = _fine_scan(
            xs[bad], index.slab, index.ids, index.yy_slab, st[bad], ps[bad],
            k, P, W)
    return vals, ids_c, n_fail


def _query_major(index: IvfFlatIndex, x, starts, psizes, k: int, P: int,
                 W: int, chunk: int):
    """The query-major schedule in chunks of ``chunk`` queries."""
    outs = [_query_major_chunk(index, x[s:s + chunk], starts[s:s + chunk],
                               psizes[s:s + chunk], k, P, W)
            for s in range(0, x.shape[0], chunk)]
    return (torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs]),
            sum(o[2] for o in outs))


# ---------------------------------------------------- list-major fine scan
class _ListSchedule(NamedTuple):
    """Host-built list-major schedule of one query chunk: ``sched``
    [4, Lp] int32 rows (clamped window start, list length, list offset in
    the window, list id), Lp padded to the 8-list cell with the cell count
    rounded to a power of two as the reference rounds it; ``scale_l`` [Lp]
    the int8 list scales; the probed-list count and the rows they stream.
    The reference's transposed query-group table is left out: the kernel
    inverts the probe table itself, on the device."""

    sched: np.ndarray
    scale_l: np.ndarray
    n_lists_probed: int
    stream_rows: int


def _list_cells(n_probed: int, n_lists: int) -> int:
    cells = max(1, -(-n_probed // LISTS_PER_CELL))
    cap = max(1, -(-n_lists // LISTS_PER_CELL))
    return min(1 << (cells - 1).bit_length(), cap)


def build_list_schedule(index: IvfFlatIndex, probes_np) -> _ListSchedule:
    """Invert a chunk's probe lists [nq, P] into the list schedule
    (reference ``:456``); host-side numpy."""
    probes_np = np.asarray(probes_np)
    plist = np.unique(probes_np.ravel())
    plist = plist[plist >= 0].astype(np.int64)
    Lp = int(plist.size)
    Wk = pad_window(index.probe_window)
    R = index.slab_rows
    Lp_pad = _list_cells(Lp, index.n_lists) * LISTS_PER_CELL
    sched = np.zeros((4, Lp_pad), np.int32)
    sched[3, :] = -1
    starts = index._np_offsets[plist].astype(np.int64)
    clamped = np.clip(np.minimum(starts, R - Wk), 0, None)
    sched[0, :Lp] = clamped
    sched[1, :Lp] = index._np_sizes[plist]
    sched[2, :Lp] = starts - clamped
    sched[3, :Lp] = plist
    scale_l = np.ones(Lp_pad, np.float32)
    if index.db_dtype == "int8":
        scale_l[:Lp] = _list_host(index)["scale"][plist]
    return _ListSchedule(sched, scale_l, Lp,
                         int(index._np_padded[plist].sum()))


def _list_host(index: IvfFlatIndex) -> dict:
    """Per-list certificate inputs, computed once per index: the max
    (dequantized) row norm of each list and, for int8, its scale (host)
    and Eq bound."""
    if index._list_host is not None:
        return index._list_host
    from raft_tpu_torch.mutable.layout import list_of_rows

    L = index.n_lists
    gid = list_of_rows(index.layout())
    quant = index.db_dtype == "int8"
    yy = index.yy_q if quant else index.yy_slab
    host = {"yy_lmax": yy.new_zeros(L).scatter_reduce(0, gid, yy, "amax")}
    if quant:
        live = index.padded_sizes > 0
        first = index.offsets[:-1].long().clamp_max(
            max(index.slab_rows - 1, 0))
        host["scale"] = torch.where(live, index.row_scale[first],
                                    1.0).cpu().numpy()
        host["eq_list"] = torch.where(live, index.eq_rows[first], 0.0)
    index._list_host = host
    return host


def _pool_finish(x, xx, rows, slab, ids, yy_slab, starts_qm, psizes,
                 k: int, P: int, W: int):
    """Put the pooled rows [nq, C] (−1 = empty slot) in the query-major
    candidate order (probe slot × window column, so equal values break as
    there), exact-rescore them (:func:`_rescore_smallest`) and select the
    top-k (reference ``:535``). Rows whose id is masked (−1) score
    +inf."""
    valid = rows >= 0
    cid = torch.where(valid, ids[rows.long().clamp_min(0)], -1)
    valid = valid & (cid >= 0)
    w = rows[:, :, None].long() - starts_qm[:, None, :].long()
    match = (w >= 0) & (w < psizes[:, None, :]) & valid[:, :, None]
    slot = torch.argmax(match.to(torch.int32), dim=2)
    col = torch.gather(w, 2, slot[:, :, None])[:, :, 0]
    key = torch.where(match.any(2), slot * W + col, P * W)
    order = torch.argsort(key, dim=1, stable=True)
    return _rescore_smallest(x, xx, torch.gather(rows, 1, order),
                             torch.gather(cid, 1, order), slab, yy_slab, k)


def _pad_kernel_operands(x, probes):
    """Query rows padded to the 8-row quantum (pad probes −2 match no
    list, so pad queries pool nothing). The port's kernel takes the probe
    table at its own width."""
    nq, P = probes.shape
    nqp = -(-nq // 8) * 8
    xp, pp = x, probes.to(torch.int32)
    if nqp > nq:
        xp = torch.cat([x, x.new_zeros((nqp - nq, x.shape[1]))])
        pp = torch.cat([pp, pp.new_full((nqp - nq, P), -2)])
    return xp.contiguous(), pp.contiguous(), nqp


def _pools(kernel, args, x, probes, Wk: int):
    nq = x.shape[0]
    xx = (x * x).sum(1, keepdim=True)
    xp, pp, nqp = _pad_kernel_operands(x, probes)
    xxp = torch.cat([xx, xx.new_zeros((nqp - nq, 1))]) if nqp > nq else xx
    a1, i1, a2, i2, a3 = kernel(*args(xp, xxp.contiguous(), pp), Wk)
    return xx, torch.cat([i1[:nq], i2[:nq]], dim=1), a3[:nq].min(1).values


def _fine_scan_list(x, sched, probes, slab, ids, yy_slab, starts_qm, psizes,
                    yy_lmax, k: int, P: int, W: int, Wk: int):
    """List-major fine scan over the f32 slab (reference ``:594``): K4
    pools → exact rescore in the query-major order → certificate. Returns
    (vals, ids, certified, margin)."""
    d = x.shape[1]
    xx, rows, bound = _pools(
        fine_scan_list_major,
        lambda xp, xxp, pp: (sched, xp, xxp, pp, slab), x, probes, Wk)
    vals, out = _pool_finish(x, xx, rows, slab, ids, yy_slab, starts_qm,
                             psizes, k, P, W)
    theta = vals[:, k - 1]
    # the reference kernel's bf16x3 envelope; the port's kernel computes
    # the same bf16 hi/lo terms, within (2⁻¹⁶ + (5d + 8)·2⁻²⁴)·span of
    # the f32 score (csrc/fine_scan.cu), inside it for every d ≤ 1024
    yymax = yy_lmax[probes.long()].max(1).values
    span = (xx[:, 0].sqrt() + yymax.sqrt()) ** 2
    widen = (2.0 ** -13 + d * 2.0 ** -22) * span
    return vals, out, bound >= theta + widen, bound - (theta + widen)


def _fine_scan_list_q8(x, sched, scale_l, probes, slab_q, slab, ids,
                       yy_slab, yy_lmax, eq_list, starts_qm, psizes, k: int,
                       P: int, W: int, Wk: int):
    """List-major fine scan over the int8 slab (reference ``:625``): the
    same pipeline, the certificate widened by the probed lists' Eq."""
    d = x.shape[1]
    xx, rows, bound = _pools(
        fine_scan_list_major_q8,
        lambda xp, xxp, pp: (sched, scale_l, xp, xxp, pp, slab_q), x,
        probes, Wk)
    vals, out = _pool_finish(x, xx, rows, slab, ids, yy_slab, starts_qm,
                             psizes, k, P, W)
    theta = vals[:, k - 1]
    pl = probes.long()
    yymax = yy_lmax[pl].max(1).values
    eq_w = eq_list[pl].max(1).values
    span = (xx[:, 0].sqrt() + yymax.sqrt()) ** 2
    e_k = (2.0 ** -13 + d * 2.0 ** -22) * span
    sq_t = theta.clamp_min(0.0).sqrt()
    widen = 2.0 * sq_t * eq_w + eq_w * eq_w + e_k
    return vals, out, bound >= theta + widen, bound - (theta + widen)


def resolve_fine_scan(index: IvfFlatIndex, nq: int, k: int, P: int, W: int,
                      requested: Optional[str] = None, probes_np=None,
                      chunk: Optional[int] = None) -> str:
    """The fine-scan schedule of a call (reference ``:658``); ``None``
    means ``"auto"``.

    Envelope (outside it every request runs query-major, with a logged
    note for an explicit ``"list"``): the slab covers one kernel window,
    ``k ≤ 96`` leaves room in the pool, ``P ≤ 128`` probe columns, and
    ``d`` within the port kernel's limit (:data:`ops.fine_scan.MAX_D`).
    ``"auto"`` compares the gather's bytes with the stream's on the actual
    probe table (``probes_np``, in chunks of ``chunk`` queries) or, without
    one, on the traffic model."""
    from raft_tpu_torch.observability.costmodel import (
        DB_DTYPE_BYTES, FINE_SCAN_MARGIN, choose_fine_scan,
        ivf_traffic_model)

    req = "auto" if requested is None else requested
    if req not in FINE_SCANS:
        raise ValueError(f"fine_scan must be one of {FINE_SCANS}, "
                         f"got {req!r}")
    if req == "query":
        return "query"
    Wk = pad_window(W)
    d = index.d_orig
    quant = index.db_dtype == "int8"
    reason = None
    if index.slab_rows < Wk:
        reason = f"slab rows {index.slab_rows} < kernel window {Wk}"
    elif k > _LIST_K_MAX:
        reason = f"k={k} > {_LIST_K_MAX} exceeds the candidate pool"
    elif P > 128:
        reason = f"n_probes={P} > 128 exceeds the probe table"
    elif d > MAX_D:
        reason = f"d={d} > {MAX_D}, the kernel's widest feature dimension"
    if reason is not None:
        if req == "list":
            _log.warning("fine_scan='list' outside the list-major envelope "
                         "(%s): using 'query' for this call", reason)
        return "query"
    if req == "list":
        return "list"
    padded = index._np_padded
    if probes_np is not None:
        probes_np = np.asarray(probes_np)
        step = max(1, int(chunk or nq))
        per_row = d * DB_DTYPE_BYTES[index.db_dtype] + 8 + (8 if quant
                                                             else 0)
        stream = 0.0
        for s in range(0, probes_np.shape[0], step):
            u = np.unique(probes_np[s:s + step].ravel())
            stream += float(padded[u[u >= 0]].sum()) * per_row
        stream += float(nq) * min(256, P * W) * d * 4.0
        gather = float(nq) * P * W * per_row
        if quant:
            gather += float(nq) * min(k + _IVF_RESCORE_PAD, P * W) * d * 4.0
        return "list" if gather > FINE_SCAN_MARGIN * max(stream, 1.0) \
            else "query"
    model = ivf_traffic_model(
        nq, index.n_rows, d, k, index.n_lists, P, W, index.slab_rows,
        db_dtype=index.db_dtype, list_sizes=index._np_sizes,
        padded_sizes=padded)
    return choose_fine_scan(model)


def exact_reason(P: int, L: int, k: int, W: int) -> str:
    """Why a search runs the exact plane (the reference's wording)."""
    if P >= L:
        return f"n_probes={P} >= n_lists={L}"
    return (f"k={k} exceeds the probed candidate capacity "
            f"{P}x{W}={P * W}")


def probe_notes(sizes_np, probes_np) -> dict:
    """The explain record's probe fields (reference ``:1084-1095``): the
    first query's probed lists, the rows probed and the probed lists'
    size histogram."""
    sz = np.asarray(sizes_np)[probes_np]
    return {"probed_lists": probes_np[0].tolist(),
            "probed_rows": int(sz.sum()),
            "probed_size_hist": {"min": int(sz.min()),
                                 "p50": float(np.percentile(sz, 50)),
                                 "max": int(sz.max())}}


def _coarse_probe(res, centroids, x, n_probes: int):
    """The ``n_probes`` nearest centroids per query (the streamed
    fused-L2 top-k sweep)."""
    from raft_tpu_torch.distance.fused_l2nn import knn

    _, lists = knn(res, centroids, x, n_probes, metric="sqeuclidean",
                   algo="streamed")
    return lists


# ------------------------------------------------------ degenerate exact
def _slab_fused_geometry(index: IvfFlatIndex):
    """Lazy certified-fused operands over the whole ragged slab (the f32
    rows whatever the index streams), pads hidden by ``rows_valid``."""
    if index._fused_ops is None:
        from raft_tpu_torch.mutable.layout import fused_ops_for_layout

        index._fused_ops = fused_ops_for_layout(index.layout(), passes=3,
                                                metric="l2")
    return index._fused_ops


def _exact_search(index: IvfFlatIndex, x, k: int):
    """Exact top-k over the ragged slab through the certified fused
    pipeline (K1), slab positions mapped to global ids (reference
    ``:840``). Returns (vals, ids, queries the certificate sent to the
    exact fixup)."""
    from raft_tpu_torch.distance.knn_fused import _Q_CHUNK, _knn_fused_core

    fops = _slab_fused_geometry(index)
    kidx = fops.index
    expects(k <= fops.pool_width,
            "search_ivf_flat: k=%d too large for the exact-path pool %d",
            k, fops.pool_width)
    dpad = kidx.stream_width - x.shape[1]
    if dpad:
        x = torch.cat([x, x.new_zeros((x.shape[0], dpad))], dim=1)
    vals, ids, n_fail = [], [], 0
    margins = [] if explain.active() is not None else None
    for s in range(0, x.shape[0], _Q_CHUNK):
        v, pos, nf = _knn_fused_core(x[s:s + _Q_CHUNK], kidx, k, True,
                                     "kernel", margins)
        g = torch.where(pos >= 0, fops.ids[pos.long().clamp_min(0)], -1)
        vals.append(v)
        ids.append(torch.where(torch.isfinite(v), g, -1))
        n_fail += nf
    record_pending("ann.ivf_exact", n_fail, n_queries=x.shape[0],
                   pool_width=k)
    if margins:
        explain.note_margin("ann.ivf_exact", torch.cat(margins))
    return torch.cat(vals), torch.cat(ids), n_fail


# ------------------------------------------------------------------ search
def _search_list_major(index: IvfFlatIndex, x, probes, probes_host, starts,
                       psizes, k: int, P: int, W: int, chunk: int,
                       list_chunk: int):
    """The list-major search loop (reference ``:937``): per chunk of
    ``list_chunk`` queries, invert the probe table into the schedule, run
    K4, and rerun the queries that fail the certificate through the
    query-major scan (in chunks of ``chunk``). Results are per query, so
    ``list_chunk`` changes no id. Returns (vals, ids, reruns)."""
    Wk = pad_window(W)
    host = _list_host(index)
    quant = index.db_dtype == "int8"
    dev = x.device
    vals_out, ids_out, n_rerun = [], [], 0
    for s0 in range(0, x.shape[0], list_chunk):
        s1 = min(s0 + list_chunk, x.shape[0])
        xs, pr = x[s0:s1], probes[s0:s1]
        st, ps = starts[s0:s1], psizes[s0:s1]
        sch = build_list_schedule(index, probes_host[s0:s1])
        sched = torch.from_numpy(sch.sched).to(dev)
        if quant:
            vals, ids_c, ok, margin = _fine_scan_list_q8(
                xs, sched, torch.from_numpy(sch.scale_l).to(dev), pr,
                index.slab_q, index.slab, index.ids, index.yy_slab,
                host["yy_lmax"], host["eq_list"], st, ps, k, P, W, Wk)
        else:
            vals, ids_c, ok, margin = _fine_scan_list(
                xs, sched, pr, index.slab, index.ids, index.yy_slab, st, ps,
                host["yy_lmax"], k, P, W, Wk)
        explain.note_margin(_SITE, margin)
        bad = (~ok).nonzero().squeeze(1)
        n_fail = int(bad.numel())
        record_certificate(_SITE, n_queries=int(xs.shape[0]), n_fail=n_fail,
                           pool_width=256, fixup_rows=n_fail or None,
                           rerun=bool(n_fail), db_dtype=index.db_dtype,
                           fine_scan="list")
        if n_fail:
            explain.note(rerun="list_query_major", rerun_rows=n_fail)
            # the pool certificate failed: the true top-k may hide outside
            # the 256 slots, so these queries rerun query-major
            fv, fi, _ = _query_major(index, xs[bad], st[bad], ps[bad], k, P,
                                     W, chunk)
            vals[bad], ids_c[bad] = fv, fi
            n_rerun += n_fail
        vals_out.append(vals)
        ids_out.append(ids_c)
    return torch.cat(vals_out), torch.cat(ids_out), n_rerun


def search_ivf_flat(res, index, queries, k: int,
                    n_probes: Optional[int] = None,
                    fine_scan: Optional[str] = None,
                    with_stats: bool = False, merge: str = "auto"):
    """Approximate top-k against an IVF-Flat index (reference ``:1006``).

    Returns (d2 [nq, k] ascending, global ids [nq, k] int32); entries
    beyond the probed candidates are (+inf, −1). ``n_probes`` defaults to
    the index's. ``fine_scan`` (:data:`FINE_SCANS`, ``None`` reads
    ``RAFT_TPU_IVF_FINE_SCAN``, default ``"auto"``)
    picks the schedule, see the module doc; f32 ids of the two schedules
    are identical, int8 id sets likewise. ``n_probes ≥ n_lists`` (or ``k``
    beyond the probed capacity) runs the exact plane. ``with_stats``
    appends the number of queries whose certificate failed and were
    re-solved (list-major reruns, int8 gather reruns, or exact-plane
    fixups). Runs on the index's device.

    ``index`` may be a :class:`ShardedIvfIndex`: the fine scan then runs
    query-major on every rank over the probed lists it owns and the
    ranks' top-k merge by ``merge`` (``"auto"``, ``"allgather"`` or
    ``"tournament"``; see :mod:`raft_tpu_torch.distance.knn_sharded`);
    ``fine_scan`` is unused there."""
    sharded = isinstance(index, ShardedIvfIndex)
    if sharded:
        sh, index = index, index.base
    if res is None and index.device.type == "cpu":
        res = DeviceResources(device="cpu")
    res = ensure_resources(res)
    x = as_f32(queries, index.device)
    expects(x.ndim == 2 and x.shape[1] == index.d_orig,
            "search_ivf_flat: query width %s != index %d",
            tuple(x.shape[1:]), index.d_orig)
    expects(k >= 1, "search_ivf_flat: k must be >= 1")
    expects(k <= index.n_rows, "search_ivf_flat: k=%d > index size %d", k,
            index.n_rows)
    nq = x.shape[0]
    if nq == 0:
        out = (x.new_zeros((0, k)),
               torch.zeros((0, k), dtype=torch.int32, device=x.device), 0)
        return out if with_stats else out[:2]
    L = index.n_lists
    P = index.n_probes_default if n_probes is None else int(n_probes)
    expects(P >= 1, "search_ivf_flat: n_probes must be >= 1, got %d", P)
    W = index.probe_window
    if P >= L or k > P * W:
        _log.info("search_ivf_flat: n_probes=%d of %d lists, k=%d: exact "
                  "search over the full index", P, L, k)
        if explain.active() is not None:
            explain.note(plane="ivf_flat", exact_degrade=exact_reason(
                P, L, k, W), n_probes=P, n_lists=L, k=k)
        out = _exact_search(index, x, k)
        return out if with_stats else out[:2]

    probes = _coarse_probe(res, index.centroids, x, P)           # [nq, P]
    if explain.active() is not None:
        explain.note(plane="ivf_flat", n_probes=P, n_lists=L, k=k,
                     db_dtype=index.db_dtype,
                     **probe_notes(index._np_sizes, probes.cpu().numpy()),
                     pool_width=(min(k + _IVF_RESCORE_PAD, P * W)
                                 if index.db_dtype == "int8" else k))
    chunk = max(8, _FINE_TILE // max(1, P * W * x.shape[1]))
    if sharded:
        out = _search_sharded(sh, x, probes, k, P, W, merge, chunk)
        return out if with_stats else out[:2]
    pl = probes.long()
    starts, psizes = index.offsets[:-1][pl], index.padded_sizes[pl]
    req = env.get("RAFT_TPU_IVF_FINE_SCAN") if fine_scan is None \
        else fine_scan
    list_chunk = min(nq, max_list_chunk(P))
    probes_host = probes.cpu().numpy() if req != "query" else None
    schedule = resolve_fine_scan(index, nq, k, P, W, req,
                                 probes_np=probes_host, chunk=list_chunk)
    explain.note(fine_scan=schedule)
    if schedule == "list":
        out = _search_list_major(index, x, probes, probes_host, starts,
                                 psizes, k, P, W, chunk, list_chunk)
    else:
        out = _query_major(index, x, starts, psizes, k, P, W, chunk)
    return out if with_stats else out[:2]


# ----------------------------------------------------------------- sharded
class ShardedIvfIndex:
    """Whole inverted lists spread over a mesh axis (reference ``:1168``):
    rank r owns the list block [r·Ll, (r+1)·Ll) laid out in its own slab
    of ``rows_per`` rows on its device (``shards[r]``: slab, ids, yy_slab
    and, for int8, slab_q, row_scale, yy_q, eq_rows), ``starts_g`` the
    local start row and ``psizes_g`` the padded size of every list
    (lists padded to p equal blocks, the virtual ones empty). Global ids
    ride in the local slabs. Build with :func:`shard_ivf_lists`; query
    with :func:`search_ivf_flat`."""

    def __init__(self, base: IvfFlatIndex, mesh, axis: str, shards,
                 starts_g, psizes_g, lists_per: int, rows_per: int):
        self.base = base
        self.mesh, self.axis = mesh, axis
        self.shards = shards
        self.starts_g, self.psizes_g = starts_g, psizes_g
        self.lists_per = lists_per
        self.rows_per = rows_per

    @property
    def n_shards(self) -> int:
        return int(self.mesh.shape[self.axis])

    @property
    def probe_window(self) -> int:
        return self.base.probe_window

    @property
    def device(self) -> torch.device:
        return self.base.device

    @property
    def n_rows(self) -> int:
        return self.base.n_rows

    @property
    def d_orig(self) -> int:
        return self.base.d_orig


_SHARD_FIELDS = (("slab", 0.0), ("ids", -1), ("yy_slab", 0.0))
_SHARD_FIELDS_Q8 = (("slab_q", 0), ("row_scale", 1.0), ("yy_q", 0.0),
                    ("eq_rows", 0.0))


def shard_ivf_lists(index: IvfFlatIndex, mesh,
                    axis: str = "x") -> ShardedIvfIndex:
    """Lay ``index`` out list-sharded over ``mesh[axis]`` (reference
    ``:1208``): lists pad to p equal blocks, every rank's slab pads to the
    largest rank's rows, and each rank's rows are gathered from the base
    slab on its device (norms and int8 sidecar gathered too, never
    recomputed, so the sharded and unsharded scans score the same bits)."""
    from raft_tpu_torch.parallel.mesh import axis_devices

    expects(axis in mesh.axis_names,
            "shard_ivf_lists: axis %r not in mesh axes %s", axis,
            tuple(mesh.axis_names))
    devs = axis_devices(mesh, axis)
    p = len(devs)
    L = index.n_lists
    Lg = -(-L // p) * p
    Ll = Lg // p
    offsets, padded = index._np_offsets, index._np_padded
    shard_rows = [int(padded[r * Ll:min((r + 1) * Ll, L)].sum())
                  for r in range(p)]
    S = max(max(shard_rows), index.row_quantum)
    starts_g = np.zeros(Lg, np.int32)
    psizes_g = np.zeros(Lg, np.int32)
    psizes_g[:L] = padded
    fields = _SHARD_FIELDS + (_SHARD_FIELDS_Q8 if index.db_dtype == "int8"
                              else ())
    shards = []
    for r, dev in enumerate(devs):
        src, cursor = [], 0
        for gl in range(r * Ll, min((r + 1) * Ll, L)):
            w = int(padded[gl])
            starts_g[gl] = cursor
            src.append(np.arange(offsets[gl], offsets[gl] + w))
            cursor += w
        src = torch.from_numpy(np.concatenate(src) if src else
                               np.zeros(0, np.int64)).to(index.device)
        shard = {}
        for name, fill in fields:
            base = getattr(index, name)
            out = torch.full((S,) + tuple(base.shape[1:]), fill,
                             dtype=base.dtype, device=index.device)
            out[:cursor] = base[src]
            shard[name] = out.to(dev)
        shards.append(shard)
    return ShardedIvfIndex(index, mesh, axis, shards,
                           torch.from_numpy(starts_g).to(index.device),
                           torch.from_numpy(psizes_g).to(index.device),
                           Ll, S)


def _search_sharded(index: ShardedIvfIndex, x, probes, k: int, P: int,
                    W: int, merge: str, chunk: int):
    """List-sharded fine scan and rank-ordered merge (reference
    ``:1287``): for each chunk of queries, every rank scans the probed
    lists it owns (compacted to the front, so it gathers only those
    windows) and keeps its top-k with global ids, and the controller
    merges the ranks' candidates rank-major
    (:data:`~raft_tpu_torch.distance.knn_sharded._MERGES`). An int8 index
    scans its codes with the certified pool; a query any rank could not
    certify reruns the chunk in f32. Returns (vals, ids, reruns)."""
    from raft_tpu_torch.comms.comms import Op, reduce_parts
    from raft_tpu_torch.distance.knn_sharded import (
        _MERGES, resolve_merge_strategy)
    from raft_tpu_torch.parallel.mesh import for_each_rank, line_mesh
    from raft_tpu_torch.resilience import fault_point

    expects(merge in ("auto", "allgather", "tournament"),
            "search_ivf_flat: merge must be 'auto', 'allgather' or "
            "'tournament', got %r", merge)
    line = line_mesh(index.mesh, index.axis)
    devs = line.device_list()
    p = len(devs)
    nq = x.shape[0]
    merge_eff = resolve_merge_strategy(merge, p, min(nq, chunk), k)
    fault_point("merge_permute" if merge_eff == "tournament"
                else "merge_allgather")
    merge_fn = _MERGES[merge_eff]
    Ll = index.lists_per
    quant = index.base.db_dtype == "int8"
    C = min(k + _IVF_RESCORE_PAD, P * W)
    pl = probes.long()
    starts_q = index.starts_g[pl]
    psz_q = index.psizes_g[pl]
    xs = {dv: x.to(dv) for dv in set(devs)}

    def owned_probes(r: int, s: int, e: int):
        """Rank r's probes of queries [s, e) moved to the front, in slot
        order (the others zero-length), cut to the most any of them owns
        (at least k/W slots): the gather reads ~P/p windows a query, not
        P, and the candidates keep the unsharded scan's relative order."""
        owned = (pl[s:e] >= r * Ll) & (pl[s:e] < (r + 1) * Ll)
        order = torch.sort((~owned).to(torch.int8), dim=1,
                           stable=True).indices
        P_r = min(P, max(int(owned.sum(1).max()), -(-k // W)))
        sel = order[:, :P_r]
        ps = torch.where(torch.gather(owned, 1, sel),
                         torch.gather(psz_q[s:e], 1, sel), 0)
        return torch.gather(starts_q[s:e], 1, sel), ps, P_r

    def scan(r, sh, s, e, exact):
        """Rank r's top-k of queries [s, e) over the lists it owns (the
        int8 codes' certified scan unless ``exact``), and the int8 scan's
        per-query certificate (None for f32)."""
        dev = devs[r]
        st, ps, P_r = owned_probes(r, s, e)
        st, ps = st.to(dev), ps.to(dev)
        xr = xs[dev][s:e]
        if quant and not exact:
            v, i, ok, _ = _fine_scan_q8(
                xr, sh["slab"], sh["slab_q"], sh["row_scale"], sh["ids"],
                sh["yy_slab"], sh["yy_q"], sh["eq_rows"], st, ps, k, P_r,
                W, min(C, P_r * W))
            return v, i, ok
        v, i = _fine_scan(xr, sh["slab"], sh["ids"], sh["yy_slab"], st,
                          ps, k, P_r, W)
        return v, i, None

    def merged(s, e, exact):
        outs = for_each_rank(line, scan, [(r, sh, s, e, exact) for r, sh
                                          in enumerate(index.shards)])
        v, i = merge_fn([o[0] for o in outs], [o[1] for o in outs], k,
                        index.axis)
        return v, i, [o[2] for o in outs]

    out_v, out_i, n_fail = [], [], 0
    for s in range(0, nq, chunk):
        e = min(s + chunk, nq)
        v, i, oks = merged(s, e, False)
        if quant:
            ok = reduce_parts([o.to(torch.int32) for o in oks], Op.MIN,
                              index.axis) > 0
            if not bool(ok.all()):
                fv, fi, _ = merged(s, e, True)
                v = torch.where(ok[:, None], v, fv)
                i = torch.where(ok[:, None], i, fi)
            n_fail += int((~ok).sum())
        out_v.append(v)
        out_i.append(i)
    vals, ids = torch.cat(out_v), torch.cat(out_i)
    if quant:
        record_certificate(_SITE, n_queries=nq, n_fail=n_fail,
                           pool_width=C, fixup_rows=n_fail or None,
                           rerun=bool(n_fail), db_dtype="int8",
                           sharded=True)
    return vals, ids, n_fail
