"""IVF traffic model and the fine-scan crossover.

Counterpart of the two functions of ``raft_tpu/observability/costmodel.py``
that ``ann.ivf_flat.resolve_fine_scan`` needs for ``fine_scan="auto"``:
``ivf_traffic_model`` (``:436``) and ``choose_fine_scan`` (``:425``), with
``FINE_SCAN_MARGIN`` (``:337``) and ``DB_DTYPE_BYTES`` (``:213``). Pure
arithmetic on shapes. The IVF-PQ keys of the reference's model belong to
the IVF-PQ slice and are left out.
"""

from __future__ import annotations

from typing import Dict

#: bytes per stored element of each index dtype
DB_DTYPE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}

#: list-major wins the crossover only past this modeled gather/stream
#: ratio: margin for the schedule build, the pool rescore and the work
#: the bytes model does not price
FINE_SCAN_MARGIN = 1.25

#: per-query candidate pool the list-major kernel exact-rescores
#: (2 × 128 lane-class slots)
_LIST_POOL = 256

#: queries per certified-fused pass (knn_fused._Q_CHUNK); the brute-force
#: bytes the IVF tier displaces stream the database once per such chunk
_Q_CHUNK = 2048


def choose_fine_scan(model: Dict) -> str:
    """``"list"`` when the query-major gather reads more than
    :data:`FINE_SCAN_MARGIN` × the list-major stream, else ``"query"``.
    Takes an :func:`ivf_traffic_model` result."""
    gather = model.get("fine_gather_bytes", 0.0)
    stream = model.get("fine_stream_bytes", 0.0)
    return "list" if gather > FINE_SCAN_MARGIN * max(stream, 1.0) \
        else "query"


def ivf_traffic_model(nq: int, m: int, d: int, k: int, n_lists: int,
                      n_probes: int, probe_window: int, slab_rows: int,
                      db_dtype: str = "f32", list_sizes=None,
                      padded_sizes=None) -> Dict:
    """Modeled memory traffic of one IVF-Flat search batch beside the
    brute-force bytes it displaces (reference ``:436``).

    ``fine_stream_bytes`` prices the list-major schedule (every probed
    list read once per query chunk, plus the per-query pool rescore);
    ``fine_gather_bytes`` the query-major gather (each query re-reads its
    own probe windows). With ``list_sizes`` / ``padded_sizes`` the
    streamed rows are the expected per-chunk union of probed lists under
    size-biased probe probabilities; without them a uniform mean window.
    ``brute_bytes`` is the fused pipeline's bf16 hi+lo stream."""
    if db_dtype not in DB_DTYPE_BYTES:
        raise ValueError(f"ivf_traffic_model: db_dtype must be one of "
                         f"{tuple(DB_DTYPE_BYTES)}, got {db_dtype!r}")
    lanes = 128
    d_eff = d + (-d) % lanes
    coarse_bytes = float(n_lists * d_eff * 4 + nq * d_eff * 4
                         + nq * n_lists * 4)
    bpe = DB_DTYPE_BYTES[db_dtype]
    per_row_f32 = d_eff * 4 + 4 + 4
    per_row = d_eff * bpe + 4 + 4 + (8 if db_dtype == "int8" else 0)
    out_bytes = float(nq) * k * 8
    chunks = max(1, -(-nq // _Q_CHUNK))
    nq_chunk = max(1, -(-nq // chunks))
    if list_sizes is not None:
        sizes = [max(0.0, float(s)) for s in list_sizes]
        padded = ([max(0.0, float(s)) for s in padded_sizes]
                  if padded_sizes is not None
                  else [-(-s // 8) * 8 for s in sizes])
        tot = max(1.0, sum(sizes))
        probed_rows = n_probes * sum(
            s * w for s, w in zip(sizes, padded)) / tot
        probed_frac = min(1.0, probed_rows / max(1, slab_rows))
        stream_rows = 0.0
        for s, w in zip(sizes, padded):
            p_l = min(1.0, float(n_probes) * s / tot)
            stream_rows += (1.0 - (1.0 - p_l) ** nq_chunk) * w
        stream_rows = min(stream_rows, float(slab_rows))
    else:
        probed_frac = min(1.0, float(n_probes) * probe_window
                          / max(1, slab_rows))
        stream_rows = probed_frac * max(slab_rows, 1)
    rescore_bytes = (float(nq) * min(k + 32, n_probes * probe_window)
                     * d_eff * 4 if db_dtype == "int8" else 0.0)
    list_rescore_bytes = (float(nq)
                          * min(_LIST_POOL, n_probes * probe_window)
                          * d_eff * 4)
    fine_stream_bytes = (float(chunks) * stream_rows * per_row
                         + list_rescore_bytes)
    fine_gather_bytes = (float(nq) * n_probes * probe_window * per_row
                         + rescore_bytes)
    total_stream = coarse_bytes + fine_stream_bytes + out_bytes
    total_gather = coarse_bytes + fine_gather_bytes + out_bytes
    brute_bytes = float(chunks) * max(m, 1) * d_eff * 2 * 2 \
        + float(nq) * d_eff * 4
    fine_gather_f32 = float(nq) * n_probes * probe_window * per_row_f32
    return {
        "db_dtype": db_dtype,
        "coarse_bytes": coarse_bytes,
        "fine_stream_bytes": fine_stream_bytes,
        "fine_gather_bytes": fine_gather_bytes,
        "rescore_bytes": rescore_bytes,
        "list_rescore_bytes": list_rescore_bytes,
        "out_bytes": out_bytes,
        "total_bytes": total_stream,
        "total_gather_bytes": total_gather,
        "brute_bytes": brute_bytes,
        "probed_frac": probed_frac,
        "modeled_speedup": brute_bytes / max(total_stream, 1.0),
        "gather_overread": total_gather / max(total_stream, 1.0),
        "quantized_gather_ratio": (fine_gather_bytes
                                   / max(fine_gather_f32, 1.0)),
    }
