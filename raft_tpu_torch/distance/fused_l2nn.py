"""Fused L2 nearest-neighbor and brute-force KNN (counterpart of
``raft_tpu/distance/fused_l2nn.py:32-388``; ref: the pre-cuVS
``raft::distance::fusedL2NN`` and brute-force knn, BASELINE config 2).

The streamed sweeps walk column tiles of Y: one f32 product X·Y_tileᵀ plus
norm corrections per tile, folded into a running minimum or top-k, so the
peak memory is [n, tile] + [n, k], never [n, m]. The tile comes from the
handle's workspace budget. They are the exact fallback of the certified
fused pipeline (``knn_fused``), which ``knn`` takes for a prepared index or,
under ``algo="auto"``, on a CUDA device inside the fused envelope.

PyTorch runs eagerly, so the reference's per-tile ``lax.cond`` gate
(merge only when a tile improves some query) would cost a host round trip
per tile; the port merges every tile instead — the same answer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.kvp import (KeyValuePair, flip_sign, ranked_head,
                                     smallest_by_key)
from raft_tpu_torch.core.resources import as_f32, ensure_resources
from raft_tpu_torch.observability.spans import instrument
from raft_tpu_torch.resilience.faults import fault_point

_INT32_MAX = 2 ** 31 - 1
#: entries the streamed sweeps keep past the k (see _sweep)
_MERGE_PAD = 8


def _pad_rows(y, tile: int):
    """Pad to a tile multiple with zeros; padded rows are masked out by the
    real row count in every sweep (zeros keep the product NaN-free)."""
    m = y.shape[0]
    pad = (-m) % tile
    if pad:
        y = torch.cat([y, y.new_zeros((pad, y.shape[1]))])
    return y, m + pad


def _tile_d2(x, x_sq, y_padded, i: int, tile: int, m_real: int):
    """[n, tile] squared distances of tile ``i`` (+inf past ``m_real``)
    and the tile's global column ids."""
    yt = y_padded[i * tile:(i + 1) * tile]
    d2 = x_sq[:, None] + (yt * yt).sum(1)[None, :] - 2.0 * (x @ yt.T)
    col = torch.arange(i * tile, (i + 1) * tile, dtype=torch.int32,
                       device=x.device)
    return d2.masked_fill(col[None, :] >= m_real, float("inf")), col


def _fused_l2nn(x, y_padded, m_real: int, tile: int, sqrt: bool):
    n = x.shape[0]
    x_sq = (x * x).sum(1)
    best_v = x.new_full((n,), float("inf"))
    best_i = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=x.device)
    for i in range(y_padded.shape[0] // tile):
        d2, _ = _tile_d2(x, x_sq, y_padded, i, tile, m_real)
        tv, ti = d2.min(dim=1)       # first minimum on ties, like argmin
        ti = ti.to(torch.int32) + i * tile
        take = (tv < best_v) | ((tv == best_v) & (ti < best_i))
        best_v = torch.where(take, tv, best_v)
        best_i = torch.where(take, ti, best_i)
    best_v = best_v.clamp_min(0.0)
    if sqrt:
        best_v = best_v.sqrt()
    return best_v, best_i


def _stream_tile(res, n_queries: int, n_rows: int, tile: Optional[int]):
    """The streamed sweeps' tile: [n_queries, tile] f32 (+ its temporaries)
    inside the workspace budget, at least 128 and at most 8192 columns."""
    if tile is None:
        tile = max(128, min(n_rows, res.allocation_limit
                            // (8 * max(n_queries, 1))))
        tile = min(tile, 8192)
    return int(tile)


@instrument("distance.fused_l2_nn_argmin")
def fused_l2_nn_argmin(res, x, y, sqrt: bool = False,
                       tile: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of x, the nearest row of y under (squared) L2.
    Returns (min_dist [n], argmin [n] int32); ties go to the lower row."""
    fault_point("fused_l2nn")
    res = ensure_resources(res)
    dev = x.device if isinstance(x, torch.Tensor) else res.device
    x, y = as_f32(x, dev), as_f32(y, dev)
    expects(x.shape[1] == y.shape[1], "fused_l2_nn: dim mismatch")
    tile = _stream_tile(res, x.shape[0], y.shape[0], tile)
    y_padded, _ = _pad_rows(y, tile)
    return _fused_l2nn(x, y_padded, y.shape[0], tile, sqrt)


def fused_l2_nn(res, x, y, sqrt: bool = False) -> KeyValuePair:
    """KVP-returning variant mirroring the reference's out type."""
    v, i = fused_l2_nn_argmin(res, x, y, sqrt)
    return KeyValuePair(key=i, value=v)


def _merge_topk(best_v, best_i, tile_v, tile_i, k: int, select_min: bool,
                unsure=None):
    """Merge a running top-k with a new tile and reselect in
    ``jax.lax.top_k``'s order (the reference's ``_xla_select_k``): ties go
    to the lower position, and the running best sits before the tile, so
    an exact tie keeps the lower id. The largest are the smallest of the
    sign-flipped bits (:func:`flip_sign`, the exact reversal of IEEE total
    order; arithmetic negation need not flip a zero's or a NaN's sign on
    the card), and the values are gathered from the merged ones as bits.
    With ``unsure`` [n] bool, the merge keeps k + _MERGE_PAD by
    :func:`ranked_head` and ors in the rows whose first k it may have got
    wrong; without, it keeps k through the int64 key. Neither waits on the
    device."""
    allv = torch.cat([best_v, tile_v], dim=1)
    alli = torch.cat([best_i, tile_i], dim=1)
    v = allv if select_min else flip_sign(allv)
    if unsure is None:
        _, pos = smallest_by_key(v, k)
    else:
        _, pos, tied = ranked_head(v, k, _MERGE_PAD)
        unsure |= tied
    bits = torch.gather(allv.view(torch.int32), 1, pos)
    return bits.view(torch.float32), torch.gather(alli, 1, pos)


def _sweep(tile_fn, n_tiles: int, n: int, k: int, select_min: bool, dev):
    """Merge every tile ``tile_fn(i)`` → (values [n, tile], column ids
    [tile]) into a running top-k. The host waits once a sweep, not once a
    tile. The running best keeps _MERGE_PAD entries past the k, so only a
    tie that runs from the k-th past them all leaves a row unsure (or a
    NaN); those rows are swept again with the key's merges at the end,
    over the same tile values (a smaller product could round
    differently)."""
    def run(rows):
        r = n if rows is None else rows.numel()
        width = k + _MERGE_PAD if rows is None else k
        best_v = torch.full((r, width),
                            float("inf" if select_min else "-inf"),
                            device=dev)
        best_i = torch.full((r, width), -1, dtype=torch.int32, device=dev)
        unsure = torch.zeros((r,), dtype=torch.bool, device=dev) \
            if rows is None else None
        for i in range(n_tiles):
            tv, col = tile_fn(i)
            if rows is not None:
                tv = tv[rows]
            best_v, best_i = _merge_topk(best_v, best_i, tv,
                                         col[None, :].expand_as(tv), k,
                                         select_min, unsure)
        return best_v[:, :k], best_i[:, :k], unsure

    best_v, best_i, unsure = run(None)
    rows = unsure.nonzero().squeeze(1)
    if rows.numel():
        best_v[rows], best_i[rows], _ = run(rows)
    return best_v, best_i


def _knn_sweep(x_sq, x, y_padded, m_real: int, k: int, tile: int):
    """Streamed exact top-k: merge every tile into the running top-k."""
    def tile_fn(i):
        return _tile_d2(x, x_sq, y_padded, i, tile, m_real)
    return _sweep(tile_fn, y_padded.shape[0] // tile, x.shape[0], k, True,
                  x.device)


def _knn_certified_approx(x, y_padded, m_real: int, k: int, tile: int):
    """Certified KNN sweep for big indexes (reference ``:146``).

    Sweep A merges the tiles into a candidate top-k; sweep B certifies it
    with one exact count pass — a query whose count of entries with
    d2 ≤ θ (its k-th candidate) is exactly k provably has its exact top-k;
    if any query fails, the exact merge sweep runs instead. The reference's
    sweep A uses the TPU's approximate bucketed ``approx_min_k``; PyTorch
    has no approximate top-k, so sweep A merges exactly, and the count
    then fails only on a tie at θ."""
    x_sq = (x * x).sum(1)
    best_v, best_i = _knn_sweep(x_sq, x, y_padded, m_real, k, tile)
    theta = best_v[:, -1]
    counts = torch.zeros((x.shape[0],), dtype=torch.int64, device=x.device)
    for i in range(y_padded.shape[0] // tile):
        d2, _ = _tile_d2(x, x_sq, y_padded, i, tile, m_real)
        counts += (d2 <= theta[:, None]).sum(1)
    if bool((counts == k).all()):
        return best_v, best_i
    return _knn_sweep(x_sq, x, y_padded, m_real, k, tile)


def _ip_sweep(x, y_padded, m_real: int, k: int, tile: int):
    def tile_fn(i):
        yt = y_padded[i * tile:(i + 1) * tile]
        col = torch.arange(i * tile, (i + 1) * tile, dtype=torch.int32,
                           device=x.device)
        return (x @ yt.T).masked_fill(col[None, :] >= m_real,
                                      float("-inf")), col
    return _sweep(tile_fn, y_padded.shape[0] // tile, x.shape[0], k, False,
                  x.device)


def _unit(a):
    # the reference's zero-norm guard (1e-30): a zero row normalizes to
    # the zero vector, at distance 0.5 from every unit vector
    n = a.norm(dim=1, keepdim=True)
    return a / n.clamp_min(1e-30)


@instrument("distance.knn")
def knn(res, index, queries, k: int, metric: str = "sqeuclidean",
        tile: Optional[int] = None, algo: str = "auto",
        certify: str = "kernel") -> Tuple[torch.Tensor, torch.Tensor]:
    """Brute-force k nearest neighbors. Returns (distances [nq, k],
    indices [nq, k] int32), nearest first (largest first for
    ``inner_product``).

    ``algo``: ``"auto"`` takes the certified fused pipeline (knn_fused)
    when ``fused_eligible`` holds — a CUDA device, at least 4096 rows and
    d ≤ 4096 (K1 at d ≤ 512, its d-chunked form above) — and the
    streamed sweep otherwise; the decision is made from the shapes before
    anything launches. ``"fused"`` / ``"fused_fast"`` force the fused
    pipeline at passes 3 / 1; ``"streamed"`` forces the sweep.

    ``metric="cosine"`` solves squared L2 on row-normalized operands and
    returns ``1 − cos = d2/2``; a zero-norm row normalizes to the zero
    vector (distance 0.5 to every unit vector).

    ``index`` may be a prepared :class:`~raft_tpu_torch.distance.knn_fused.
    KnnIndex` ("l2" serves sqeuclidean/euclidean/l2, "ip" serves
    inner_product); queries then run on the index's device.
    ``certify="f32"`` is the fused pipeline's adaptive precision (see
    knn_fused)."""
    from raft_tpu_torch.distance.knn_fused import (
        KnnIndex, fused_config, fused_eligible, knn_fused)

    expects(certify in ("kernel", "f32"),
            "knn: certify must be 'kernel' or 'f32', got %r", certify)
    if isinstance(index, KnnIndex):
        queries = as_f32(queries, index.device)
        if metric in ("sqeuclidean", "euclidean", "l2"):
            expects(index.metric == "l2",
                    "knn: index prepared for %r, metric %r needs 'l2'",
                    index.metric, metric)
            dists, idx = knn_fused(queries, index, k, certify=certify)
            if metric in ("euclidean", "l2"):
                dists = dists.clamp_min(0.0).sqrt()
            return dists, idx
        expects(metric == "inner_product" and index.metric == "ip",
                "knn: prepared-index metric %r cannot serve %r",
                index.metric, metric)
        return knn_fused(queries, index, k, certify=certify)
    res = ensure_resources(res)
    dev = index.device if isinstance(index, torch.Tensor) else res.device
    index, queries = as_f32(index, dev), as_f32(queries, dev)
    expects(metric in ("sqeuclidean", "euclidean", "l2", "inner_product",
                       "cosine"),
            "knn: unsupported metric %r", metric)
    if metric == "cosine":
        d2, idx = knn(res, _unit(index), _unit(queries), k,
                      metric="sqeuclidean", tile=tile, algo=algo,
                      certify=certify)
        return d2 * 0.5, idx
    expects(k <= index.shape[0], "knn: k larger than index size")
    expects(algo in ("auto", "fused", "fused_fast", "streamed"),
            "knn: unknown algo %r", algo)
    n = index.shape[0]
    # auto runs passes=3; the pool geometry mirrors knn_fused's own
    # (2·128 entries per group of g tiles of T rows)
    cfg = fused_config(3)
    n_tiles = -(-max(n, cfg.T) // cfg.T)
    fused_pool = 2 * (-(-n_tiles // cfg.g)) * 128
    auto_fused = (algo == "auto" and fused_eligible(n, queries.shape[1], dev)
                  and k <= fused_pool)
    if algo in ("fused", "fused_fast") or auto_fused:
        dists, idx = knn_fused(
            queries, index, k, passes=1 if algo == "fused_fast" else 3,
            metric="ip" if metric == "inner_product" else "l2",
            certify=certify)
        if metric in ("euclidean", "l2"):
            dists = dists.clamp_min(0.0).sqrt()
        return dists, idx

    expects(certify == "kernel",
            "knn: certify='f32' is a fused-pipeline contract, but this "
            "call routed to the streamed sweep (shape/device outside the "
            "fused envelope) — it cannot be honored silently")
    tile = _stream_tile(res, queries.shape[0], n, tile)
    y_padded, _ = _pad_rows(index, tile)
    if metric == "inner_product":
        return _ip_sweep(queries, y_padded, n, k, tile)
    if n >= 16 * tile and k <= 256:
        dists, idx = _knn_certified_approx(queries, y_padded, n, k, tile)
    else:
        x_sq = (queries * queries).sum(1)
        dists, idx = _knn_sweep(x_sq, queries, y_padded, n, k, tile)
    if metric in ("euclidean", "l2"):
        dists = dists.clamp_min(0.0).sqrt()
    return dists, idx


# ------------------------------------------------------------- sharded
def _local_res(res, dev: torch.device):
    """A handle on rank device ``dev`` with ``res``'s workspace budget,
    so each rank sizes its sweep tile as the caller's handle would."""
    from raft_tpu_torch.core.resources import DeviceResources

    return DeviceResources(device=dev,
                           workspace_limit=res.allocation_limit)


@instrument("distance.knn_sharded")
def knn_sharded(res, index, queries, k: int, mesh=None, axis: str = "x",
                metric: str = "sqeuclidean", algo: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data-parallel brute-force KNN over a mesh (reference ``:389``): the
    queries split into ⌈nq/p⌉-row blocks over ``mesh[axis]``, the index
    replicated, each rank running :func:`knn` on its block; no
    cross-rank traffic. Returns (distances, indices) on the first rank's
    device."""
    from raft_tpu_torch.parallel.mesh import for_each_rank, line_mesh

    res = ensure_resources(res)
    mesh = getattr(res, "mesh", None) if mesh is None else mesh
    expects(mesh is not None, "knn_sharded: pass mesh= or set it on res")
    expects(axis in mesh.axis_names,
            "knn_sharded: axis %r not in mesh axes %s", axis,
            tuple(mesh.axis_names))
    line = line_mesh(mesh, axis)
    devs = line.device_list()
    p = len(devs)
    index = as_f32(index, devs[0])
    queries = as_f32(queries, devs[0])
    nq = queries.shape[0]
    qs = -(-nq // p)
    replicas = {d: index.to(d) for d in set(devs)}

    def rank_fn(r):
        dev = devs[r]
        q = queries[r * qs:(r + 1) * qs].to(dev)
        if q.shape[0] == 0:
            return (q.new_zeros((0, k)),
                    torch.zeros((0, k), dtype=torch.int32, device=dev))
        return knn(_local_res(res, dev), replicas[dev], q, k,
                   metric=metric, algo=algo)

    outs = for_each_rank(line, rank_fn, [(r,) for r in range(p)])
    return (torch.cat([o[0].to(devs[0]) for o in outs]),
            torch.cat([o[1].to(devs[0]) for o in outs]))


class ShardedKnnIndex:
    """A row-sharded index prepared once (reference ``:465``):
    ``shards[r]`` is rank r's block of ``rows_per`` rows on its device
    (the pad rows, all in the trailing shards, are zeros), ``n`` the true
    row count."""

    def __init__(self, shards, n: int, rows_per: int, mesh, axis: str):
        self.shards, self.n, self.rows_per = shards, n, rows_per
        self.mesh, self.axis = mesh, axis

    def rows(self) -> torch.Tensor:
        """The index's true rows, gathered on the first shard's device."""
        dev = self.shards[0].device
        return torch.cat([s.to(dev) for s in self.shards])[:self.n]


def prepare_index_sharded(res, index, mesh=None, axis: str = "x"
                          ) -> ShardedKnnIndex:
    """Pad the index rows to a multiple of p and place one block on each
    rank's device (reference ``:479``)."""
    from raft_tpu_torch.parallel.mesh import axis_devices

    res_mesh = getattr(res, "mesh", None) if res is not None else None
    mesh = res_mesh if mesh is None else mesh
    expects(mesh is not None,
            "prepare_index_sharded: pass mesh= or set it on res")
    expects(axis in mesh.axis_names,
            "prepare_index_sharded: axis %r not in mesh axes %s", axis,
            tuple(mesh.axis_names))
    devs = axis_devices(mesh, axis)
    src = index.device if isinstance(index, torch.Tensor) else devs[0]
    arr = as_f32(index, src)
    n = arr.shape[0]
    p = len(devs)
    arr, n_pad = _pad_rows(arr, p)
    rows_per = n_pad // p
    shards = [arr[r * rows_per:(r + 1) * rows_per].to(d)
              for r, d in enumerate(devs)]
    return ShardedKnnIndex(shards, n, rows_per, mesh, axis)


def knn_index_sharded(res, index, queries, k: int, mesh=None,
                      axis: str = "x", metric: str = "sqeuclidean",
                      algo: str = "auto"
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model-parallel brute-force KNN (reference ``:509``): the index rows
    sharded over ``mesh[axis]``, the queries replicated. Each rank selects
    its local top-k + n_pads (the zero pad rows can rank inside a local
    top-k, so over-selecting by their count leaves ≥ k real candidates),
    shifts its ids by its row offset; the controller gathers the
    candidates (the reference's one allgather), masks the pads by global
    id and selects k, in ``jax.lax.top_k``'s order."""
    from raft_tpu_torch.comms.comms import _count
    from raft_tpu_torch.matrix.select_k_slotted import _smallest, lax_top_k
    from raft_tpu_torch.parallel.mesh import for_each_rank, line_mesh

    res = ensure_resources(res)
    if isinstance(index, ShardedKnnIndex):
        mesh = index.mesh if mesh is None else mesh
        expects(index.axis == axis,
                "knn_index_sharded: index prepared for axis %r, got %r",
                index.axis, axis)
        expects(index.mesh == mesh,
                "knn_index_sharded: index prepared for a different mesh — "
                "re-prepare or pass its mesh")
    else:
        mesh = getattr(res, "mesh", None) if mesh is None else mesh
        expects(mesh is not None,
                "knn_index_sharded: pass mesh= or set it on res")
        index = prepare_index_sharded(res, index, mesh, axis)
    line = line_mesh(mesh, axis)
    devs = line.device_list()
    p = len(devs)
    n, rows_per = index.n, index.rows_per
    expects(k <= n, "knn_index_sharded: k larger than index size")
    n_pads = p * rows_per - n
    k_loc = k + n_pads
    expects(k_loc <= rows_per,
            "knn_index_sharded: k=%d (+%d pad slots) exceeds the per-shard "
            "row count %d — use fewer shards or the query-sharded mode", k,
            n_pads, rows_per)
    queries = as_f32(queries, devs[0])

    def rank_fn(r, shard):
        dev = devs[r]
        d_loc, i_loc = knn(_local_res(res, dev), shard, queries.to(dev),
                           k_loc, metric=metric, algo=algo)
        return d_loc, (i_loc + r * rows_per).to(torch.int32)

    outs = for_each_rank(line, rank_fn,
                         [(r, s) for r, s in enumerate(index.shards)])
    _count("allgather", outs[0][0], axis)
    _count("allgather", outs[0][1], axis)
    nq = outs[0][0].shape[0]
    dg = torch.stack([o[0].to(devs[0]) for o in outs]).permute(
        1, 0, 2).reshape(nq, -1)
    ig = torch.stack([o[1].to(devs[0]) for o in outs]).permute(
        1, 0, 2).reshape(nq, -1)
    ip = metric == "inner_product"
    dg = torch.where(ig < n, dg, float("-inf") if ip else float("inf"))
    top, pos = lax_top_k(dg, k) if ip else _smallest(dg, k)
    return top, torch.gather(ig, 1, pos)
