"""IVF traffic model, the fine-scan and PQ-scan crossovers, and the
sharded KNN's merge model.

Counterpart of the functions of ``raft_tpu/observability/costmodel.py``
that the IVF choosers read: ``ivf_traffic_model`` (``:436``, with its
IVF-PQ keys), ``choose_fine_scan`` (``:425``) for ``fine_scan="auto"``,
``choose_pq_scan`` (``:395``) for ``pq_scan="auto"``, ``pq_bytes_ratio``
(``:346``) and ``pq_index_bytes`` (``:360``), with ``FINE_SCAN_MARGIN``,
``PQ_SCAN_MARGIN`` and ``DB_DTYPE_BYTES``; and the merge half
(``:599-683``): ``MERGE_STRATEGIES``, ``ici_traffic_model``,
``ici_time_model`` and ``choose_merge_strategy``, priced on a
:class:`~raft_tpu_torch.utils.arch.ChipSpec`. Pure arithmetic on shapes.
"""

from __future__ import annotations

from typing import Dict, Optional

#: bytes per stored element of each index dtype
DB_DTYPE_BYTES = {"f32": 4, "bf16": 2, "int8": 1}

#: list-major wins the crossover only past this modeled gather/stream
#: ratio: margin for the schedule build, the pool rescore and the work
#: the bytes model does not price
FINE_SCAN_MARGIN = 1.25

#: the ADC scan wins the PQ crossover only past this modeled flat/pq bytes
#: ratio: margin for the table build, the gather work and the mandatory
#: pool rescore the bytes model prices only approximately
PQ_SCAN_MARGIN = 1.25

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


def pq_bytes_ratio(d: int, pq_dim: int, pq_bits: int) -> float:
    """Streamed slab bytes of the PQ codes over the f32 slab for the same
    rows, sidecars excluded on both sides (reference ``:346``): 1/16 at
    8-bit codes with ``pq_dim = d/4``, 1/32 at 4-bit."""
    d_eff = d + (-d) % 128
    return pq_dim * pq_bits / 8.0 / max(d_eff * 4.0, 1.0)


def pq_index_bytes(m: int, d: int, n_lists: int, pq_dim: int,
                   pq_bits: int, pad_frac: float = 0.05) -> Dict:
    """Resident bytes of the compressed IVF-PQ tier for an ``m × d``
    database (reference ``:360``): packed codes, the per-row norm and id
    sidecar, the coarse centroids and the codebooks; ``pad_frac`` models
    the row-quantum padding. The f32 rescore slab is reported beside."""
    K = 1 << pq_bits
    dsub = max(1, d // max(pq_dim, 1))
    R = float(m) * (1.0 + max(0.0, pad_frac))
    codes = R * pq_dim * pq_bits / 8.0
    sidecar = R * (4 + 4)                      # ‖ŷ‖² + global id
    coarse = float(n_lists) * d * 4
    books = float(pq_dim) * K * dsub * 4
    geometry = float(n_lists + 1) * 4 * 3
    return {
        "rows": int(m), "d": int(d), "pq_dim": int(pq_dim),
        "pq_bits": int(pq_bits), "codes_bytes": codes,
        "sidecar_bytes": sidecar, "coarse_bytes": coarse,
        "codebook_bytes": books,
        "total_bytes": codes + sidecar + coarse + books + geometry,
        "f32_slab_bytes": R * d * 4.0,
        "compression": (R * d * 4.0) / max(codes + sidecar, 1.0),
    }


def choose_pq_scan(model: Dict, rerun_frac: Optional[float] = None) -> str:
    """``"pq"`` when the best flat schedule's modeled fine-scan bytes beat
    the EXPECTED ADC bytes by :data:`PQ_SCAN_MARGIN`, else ``"flat"``
    (reference ``:395``). The expected bytes price the certificate reruns:
    ``pq_stream + rerun_frac · flat``, ``rerun_frac`` defaulting to the
    model's own ``pq_rerun_frac``. Takes an :func:`ivf_traffic_model`
    result with the pq keys."""
    pq = model.get("pq_stream_bytes")
    if not isinstance(pq, (int, float)) or pq <= 0:
        return "flat"
    flat = min(model.get("fine_stream_bytes", float("inf")),
               model.get("fine_gather_bytes", float("inf")))
    frac = model.get("pq_rerun_frac", 0.0) if rerun_frac is None \
        else rerun_frac
    frac = min(1.0, max(0.0, float(frac)))
    return "pq" if flat > PQ_SCAN_MARGIN * max(pq + frac * flat, 1.0) \
        else "flat"


def ivf_traffic_model(nq: int, m: int, d: int, k: int, n_lists: int,
                      n_probes: int, probe_window: int, slab_rows: int,
                      db_dtype: str = "f32", list_sizes=None,
                      padded_sizes=None, pq_dim: Optional[int] = None,
                      pq_bits: Optional[int] = None,
                      pq_rerun_frac: float = 0.0) -> Dict:
    """Modeled memory traffic of one IVF-Flat search batch beside the
    brute-force bytes it displaces (reference ``:436``).

    ``fine_stream_bytes`` prices the list-major schedule (every probed
    list read once per query chunk, plus the per-query pool rescore);
    ``fine_gather_bytes`` the query-major gather (each query re-reads its
    own probe windows). With ``list_sizes`` / ``padded_sizes`` the
    streamed rows are the expected per-chunk union of probed lists under
    size-biased probe probabilities; without them a uniform mean window.
    ``brute_bytes`` is the fused pipeline's bf16 hi+lo stream.

    With ``pq_dim`` / ``pq_bits`` (IVF-PQ) it adds ``pq_stream_bytes``:
    the packed codes plus the 4-byte ``‖ŷ‖²``, ``Eq`` and id sidecars per
    streamed row, the per-chunk ADC table build and the pool rescore; and
    ``pq_expected_bytes``, which adds ``pq_rerun_frac`` of the flat stream
    for the queries whose certificate reruns."""
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
    pq_keys = {}
    if pq_dim is not None and pq_bits is not None:
        K = 1 << int(pq_bits)
        dsub = max(1, d // max(int(pq_dim), 1))
        per_row_pq = int(pq_dim) * int(pq_bits) / 8.0 + 4 + 4 + 4
        adc_table_bytes = (float(chunks) * pq_dim * K * dsub * 4
                           + float(nq) * pq_dim * K * 4 * 2)
        pq_stream = (float(chunks) * stream_rows * per_row_pq
                     + list_rescore_bytes + adc_table_bytes)
        frac = min(1.0, max(0.0, float(pq_rerun_frac)))
        pq_expected = pq_stream + frac * (float(chunks) * stream_rows
                                          * per_row + list_rescore_bytes)
        pq_total = coarse_bytes + pq_expected + out_bytes
        pq_keys = {
            "pq_dim": int(pq_dim), "pq_bits": int(pq_bits),
            "pq_stream_bytes": pq_stream, "pq_rerun_frac": frac,
            "pq_expected_bytes": pq_expected, "pq_total_bytes": pq_total,
            "adc_table_bytes": adc_table_bytes,
            "pq_bytes_ratio": pq_bytes_ratio(d, int(pq_dim), int(pq_bits)),
            "modeled_speedup_pq": brute_bytes / max(pq_total, 1.0),
        }
    return {
        **pq_keys,
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


# ------------------------------------------------- merge traffic model
#: the sharded KNN's collective merges (reference ``:599``)
MERGE_STRATEGIES = ("allgather", "tournament")


def ici_traffic_model(p: int, nq: int, k: int, strategy: str,
                      cand_bytes: int = 8) -> Dict:
    """Bytes of one sharded-KNN merge over ``p`` shards for ``nq`` queries
    selecting ``k`` (reference ``:602``); a candidate is ``cand_bytes`` (an
    f32 value and an int32 id). Wire bytes are per-device egress:
    ``allgather`` forwards p−1 blocks of [nq, k] and selects once over
    p·k; ``tournament`` runs log₂(p) pair exchanges of one block, each
    followed by a select over 2k."""
    if strategy not in MERGE_STRATEGIES:
        raise ValueError(f"ici_traffic_model: strategy must be one of "
                         f"{MERGE_STRATEGIES}, got {strategy!r}")
    block = float(nq) * k * cand_bytes
    if strategy == "allgather":
        rounds, wire, width = 1, (p - 1) * block, p * k
    else:
        if p & (p - 1):
            raise ValueError(f"ici_traffic_model: tournament needs a "
                             f"power-of-two shard count, got p={p}")
        rounds = max(1, p.bit_length() - 1) if p > 1 else 0
        wire, width = rounds * block, 2 * k
    return {
        "strategy": strategy,
        "p": p,
        "rounds": rounds,
        "wire_bytes_per_device": wire,
        "bytes_per_round": block if strategy == "tournament"
        else (p - 1) * block,
        "select_width": width,
        "select_bytes": float(nq) * (width + k) * cand_bytes,
    }


def ici_time_model(p: int, nq: int, k: int, strategy: str, spec=None,
                   cand_bytes: int = 8) -> Dict:
    """Modelled merge seconds on ``spec`` (default
    :func:`raft_tpu_torch.utils.arch.chip_spec`; reference ``:650``): wire
    bytes over ``ici_bw``, plus a latency and a select over ``hbm_bw`` a
    round."""
    from raft_tpu_torch.utils.arch import chip_spec

    spec = spec if spec is not None else chip_spec()
    m = ici_traffic_model(p, nq, k, strategy, cand_bytes)
    ici_bw = spec.ici_bw or spec.hbm_bw
    wire_s = m["wire_bytes_per_device"] / ici_bw
    select_s = m["rounds"] * (m["select_bytes"] / spec.hbm_bw)
    lat_s = m["rounds"] * spec.ici_latency
    m.update({"wire_seconds": wire_s, "select_seconds": select_s,
              "latency_seconds": lat_s,
              "merge_seconds": wire_s + select_s + lat_s})
    return m


def choose_merge_strategy(p: int, nq: int, k: int, spec=None) -> str:
    """``merge="auto"`` (reference ``:672``): the strategy of the smaller
    modelled time; a non-power-of-two ``p`` and p ≤ 2 take the
    allgather."""
    if p <= 2 or (p & (p - 1)):
        return "allgather"
    t_ag = ici_time_model(p, nq, k, "allgather", spec)["merge_seconds"]
    t_tr = ici_time_model(p, nq, k, "tournament", spec)["merge_seconds"]
    return "allgather" if t_ag <= t_tr else "tournament"
