"""Serving entry points of the port.

Counterpart of ``raft_tpu/runtime/entry_points.py``, holding only
:func:`knn_query` (reference ``:96-245``), the data plane of the serving
engine. The reference lowers and compiles one executable per (index
geometry, query-batch shape) into the handle's compile cache, so that a
warmed engine never traces on a live request. PyTorch is eager and has
nothing to compile; the port's counterpart of that contract is the kernel
libraries, which ``raft_tpu_torch.ops._build`` builds and loads once per
process (the engine's warm-up loads them, and counts that nothing loads
after it); the ``aot_compile`` fault site sits at a library build there.
Each call passes the ``aot_dispatch`` fault site and records a
``dispatch`` flight event before it queues its work, and feeds the
certificate counters and, under an active explain capture, the explain
record (the reference's ``:220-243``).
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.error import expects
from raft_tpu_torch.core.resources import as_f32
from raft_tpu_torch.distance.knn_fused import (
    _LANES, KnnIndex, query_prepared, record_telemetry, resolve_rescore)
from raft_tpu_torch.observability import explain
from raft_tpu_torch.observability.timeline import emit_dispatch
from raft_tpu_torch.resilience.faults import fault_point


def knn_query(res, index: KnnIndex, x, k: int,
              rescore: Optional[bool] = None, certify: str = "kernel",
              with_stats: bool = False):
    """Certified fused KNN of the query batch ``x`` [Q, d] against a
    prepared :class:`~raft_tpu_torch.distance.knn_fused.KnnIndex` (bf16 or
    int8), on the index's device and the caller's current stream; the
    feature padding happens here. ``res`` is accepted for the reference's
    signature (the port's handle holds no compile cache). Returns
    (vals [Q, k], ids [Q, k] int32), plus the number of queries that
    failed the certificate with ``with_stats``."""
    expects(isinstance(index, KnnIndex),
            "knn_query: index must be a prepared KnnIndex (see "
            "distance.prepare_knn_index)")
    expects(index.rows_valid is None,
            "knn_query: ragged-layout indexes (rows_valid) query through "
            "knn_fused, not the serving entry")
    if certify not in ("kernel", "f32"):
        raise ValueError(f"knn_query: certify must be 'kernel' or 'f32', "
                         f"got {certify!r}")
    x = as_f32(x, index.device)
    Q, d_x = x.shape
    expects(d_x == index.d_orig, "knn_query: query width %d != index %d",
            d_x, index.d_orig)
    expects(k <= index.n_rows, "knn_query: k=%d > index size %d", k,
            index.n_rows)
    if index.passes == 3:
        certify = "kernel"          # p3 is already f32-certified
    rescore = resolve_rescore(index, rescore, certify, "knn_query")
    n_tiles = -(-max(index.n_rows, index.T) // index.T)
    pool = 2 * (-(-n_tiles // index.g)) * _LANES
    if k > pool:
        raise NotImplementedError(f"knn_query: k={k} too large for pool "
                                  f"{pool}")
    if Q == 0:
        out = (x.new_zeros((0, k)),
               torch.zeros((0, k), dtype=torch.int32, device=x.device))
        return (*out, 0) if with_stats else out
    # the quality and explain record (reference ``:220-243``): the
    # failure count is the int the certificate already read on the host,
    # and the margins are computed and held only under an active capture
    margins = [] if explain.active() is not None else None
    fault_point("aot_dispatch")
    emit_dispatch("knn_query")
    vals, ids, n_fail = query_prepared(x, index, k, rescore, certify,
                                       margins)
    record_telemetry("runtime.knn_query", index, k, Q, n_fail, margins)
    if margins is not None:
        explain.note(plane="brute", db_dtype=index.db_dtype,
                     passes=index.passes, certify=certify, k=k,
                     kernel=("packed" if index.g * (index.T // _LANES)
                             <= (1 << index.pbits) else "unpacked"))
    if with_stats:
        return vals, ids, n_fail
    return vals, ids
