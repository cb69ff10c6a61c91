"""Cost records and the roofline, the kernels' own cost records, the IVF
traffic model and crossovers, and the sharded KNN's merge model.

Counterpart of ``raft_tpu/observability/costmodel.py``, priced on a
:class:`~raft_tpu_torch.utils.arch.ChipSpec`; pure arithmetic on shapes.

- The roofline half (reference ``:39-345, 685-757``): :class:`CostRecord`,
  :func:`publish` (the ``raft_tpu_cost_*`` names), :func:`classify`,
  :class:`RooflineEstimate`, :func:`roofline`, :func:`roofline_report`,
  and the fused pipeline's traffic model (:func:`db_stream_bytes_per_el`,
  :func:`fused_traffic_model`, :func:`quantized_bytes_ratio`,
  :func:`fused_traffic_record`), computed as the reference computes them.
  The reference fills a record from XLA's cost analysis of a compiled
  executable; the port has none to ask, so :func:`kernel_cost` counts
  each hand-written kernel's work analytically: the operations it must
  do and the bytes it must move (each input read once, each output
  written once). A record's ``rate`` names the peak its operations run
  at: ``""`` the bf16 tensor-core peak (or the f32 one under
  ``roofline(..., f32=True)``, as in the reference), ``"f32"``,
  ``"fp32_issue"`` (FP32 instructions) or ``"sfu"`` (reciprocals).
- The IVF choosers' half: ``ivf_traffic_model`` (``:436``, with its
  IVF-PQ keys), ``choose_fine_scan`` (``:425``), ``choose_pq_scan``
  (``:395``), ``pq_bytes_ratio`` (``:346``) and ``pq_index_bytes``
  (``:360``), with ``FINE_SCAN_MARGIN``, ``PQ_SCAN_MARGIN`` and
  ``DB_DTYPE_BYTES``.
- The merge half (``:599-683``): ``MERGE_STRATEGIES``,
  ``ici_traffic_model``, ``ici_time_model`` and
  ``choose_merge_strategy``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

from raft_tpu_torch.observability.metrics import MetricsRegistry, get_registry
from raft_tpu_torch.utils.arch import ChipSpec, chip_spec

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
#: the fused pipeline's widest single-shot feature width and the wide
#: kernel's d-chunk (the reference's knn_fused._D_SINGLE_SHOT and _DC)
_D_SINGLE_SHOT = 512
_DC = 256

COST_FLOPS = "raft_tpu_cost_flops"
COST_BYTES = "raft_tpu_cost_bytes_accessed"
COST_PEAK_HBM = "raft_tpu_cost_peak_hbm_bytes"
COST_TEMP_BYTES = "raft_tpu_cost_temp_bytes"
COST_CAPTURES = "raft_tpu_cost_captures_total"


@dataclasses.dataclass
class CostRecord:
    """Cost of one entry at one shape signature (reference ``:39``).

    ``flops`` / ``bytes_accessed`` are the work counted for the entry:
    a kernel's analytic count (:func:`kernel_cost`) or, for a plain
    callable, ``torch.utils.flop_counter``'s operations and the bytes of
    its inputs and outputs. ``peak_hbm_bytes`` is the allocator's
    high-water mark during one run above what was allocated before it
    (0 on the CPU). ``rate`` names the
    peak the operations are priced at (see the module doc)."""

    entry: str
    key: str = ""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_hbm_bytes: int = 0
    generated_code_bytes: int = 0
    platform: str = ""
    rate: str = ""

    @property
    def arithmetic_intensity(self) -> float:
        """Operations per device-memory byte; inf for byte-free work."""
        if self.bytes_accessed <= 0:
            return math.inf if self.flops > 0 else 0.0
        return self.flops / self.bytes_accessed

    def to_event(self) -> Dict:
        ev = dataclasses.asdict(self)
        ev["type"] = "cost"
        ev["arithmetic_intensity"] = self.arithmetic_intensity
        return ev


def publish(rec: CostRecord,
            registry: Optional[MetricsRegistry] = None) -> None:
    """Cost record → registry (reference ``:120``): gauges a entry (the
    latest capture wins) and a ``cost`` event carrying the whole
    record."""
    reg = registry if registry is not None else get_registry()
    if not reg.enabled:
        return
    labels = {"entry": rec.entry}
    reg.counter(COST_CAPTURES, labels,
                help="XLA cost/memory analyses captured").inc()
    reg.gauge(COST_FLOPS, labels,
              help="XLA cost_analysis FLOPs of the latest compiled "
                   "executable").set(rec.flops)
    reg.gauge(COST_BYTES, labels,
              help="XLA cost_analysis bytes accessed (HBM traffic)"
              ).set(rec.bytes_accessed)
    reg.gauge(COST_PEAK_HBM, labels,
              help="args+outputs+temps of the compiled executable"
              ).set(rec.peak_hbm_bytes)
    reg.gauge(COST_TEMP_BYTES, labels,
              help="XLA temp (scratch) bytes of the compiled executable"
              ).set(rec.temp_bytes)
    reg.emit(rec.to_event())


# ---------------------------------------------------------------- roofline
COMPUTE_BOUND = "compute-bound"
MEMORY_BOUND = "memory-bound"


def classify(arithmetic_intensity: float, spec: Optional[ChipSpec] = None,
             f32: bool = False) -> str:
    """Compute- vs memory-bound at the chip's ridge point
    (peak FLOP/s ÷ HBM bytes/s)."""
    spec = spec if spec is not None else chip_spec()
    ridge = spec.ridge_f32 if f32 else spec.ridge
    return COMPUTE_BOUND if arithmetic_intensity >= ridge else MEMORY_BOUND


@dataclasses.dataclass
class RooflineEstimate:
    """One entry placed on the roofline (reference ``:166``).

    ``roof_flops`` is the attainable rate at this arithmetic intensity,
    ``min(peak, AI · hbm_bw)``; ``roof_seconds`` the time a
    roofline-perfect run would take. With a measured ``seconds``,
    ``utilization`` = roof_seconds / seconds, clamped at 1.0 as the
    reference clamps it (a caller checking its count reads the raw
    ratio, ``roof_seconds / seconds``)."""

    entry: str
    flops: float
    bytes_accessed: float
    arithmetic_intensity: float
    bound: str
    roof_flops: float
    roof_seconds: float
    seconds: Optional[float] = None
    achieved_flops: Optional[float] = None
    achieved_bw: Optional[float] = None
    utilization: Optional[float] = None
    spec_name: str = ""


def _peak(rec: CostRecord, spec: ChipSpec, f32: bool) -> float:
    """The operations rate ``rec`` is priced at on ``spec``."""
    rate = rec.rate or ("f32" if f32 else "")
    if rate == "":
        return spec.peak_flops
    if rate == "f32":
        return spec.peak_flops_f32
    if rate == "fp32_issue":
        return spec.issue_f32 or spec.peak_flops_f32
    if rate == "sfu":
        return spec.sfu or spec.peak_flops_f32
    raise ValueError(f"roofline: unknown rate {rec.rate!r}")


def roofline(rec: CostRecord, spec: Optional[ChipSpec] = None,
             seconds: Optional[float] = None,
             f32: bool = False) -> RooflineEstimate:
    """Place one cost record on the roofline, optionally with a measured
    time (``benchmark.Fixture.run`` seconds). For a record with no
    ``rate`` this is the reference's computation."""
    spec = spec if spec is not None else chip_spec()
    ai = rec.arithmetic_intensity
    peak = _peak(rec, spec, f32)
    if rec.rate:
        bound = (COMPUTE_BOUND if ai >= peak / spec.hbm_bw
                 else MEMORY_BOUND)
    else:
        bound = classify(ai, spec, f32=f32)
    roof_flops = peak if bound == COMPUTE_BOUND else ai * spec.hbm_bw
    roof_seconds = max(rec.flops / peak if peak else 0.0,
                       rec.bytes_accessed / spec.hbm_bw if spec.hbm_bw
                       else 0.0)
    est = RooflineEstimate(
        entry=rec.entry, flops=rec.flops,
        bytes_accessed=rec.bytes_accessed, arithmetic_intensity=ai,
        bound=bound, roof_flops=roof_flops, roof_seconds=roof_seconds,
        seconds=seconds, spec_name=spec.name)
    if seconds and seconds > 0:
        est.achieved_flops = rec.flops / seconds
        est.achieved_bw = rec.bytes_accessed / seconds
        est.utilization = min(roof_seconds / seconds, 1.0) \
            if roof_seconds else None
    return est


# ------------------------------------------------- fused traffic model
def db_stream_bytes_per_el(db_dtype: str, passes: int) -> int:
    """Streamed bytes per database element of the fused pipeline
    (reference ``:225``): bf16 streams the hi (and, at passes=3, lo)
    split; int8 streams one byte whatever the passes."""
    if db_dtype == "int8":
        return 1
    return DB_DTYPE_BYTES["bf16"] * (2 if passes == 3 else 1)


def fused_traffic_model(Q: int, m: int, d: int, k: int,
                        T: int, Qb: int, g: int, passes: int,
                        grid_order: str = "query",
                        db_dtype: str = "bf16") -> Dict:
    """The reference's analytic HBM traffic of its packed fused L2 top-k
    pipeline for one query batch (``:235``): feature padding, row
    padding to tiles (or whole groups for the db orders), query chunks
    of ``_Q_CHUNK`` (y re-streams a chunk), the database bytes at each
    pass count, and the three packed [Q, G·128] outputs. The grid orders
    are the TPU kernel's; the port's kernels pick their own schedule, and
    their own work is :func:`kernel_cost`'s."""
    lanes = 128
    d_eff = d + (-d) % (_DC if d > _D_SINGLE_SHOT else lanes)
    row_mult = g * T if grid_order in ("db", "dbuf") else T
    M = -(-max(m, 1) // row_mult) * row_mult
    n_tiles = M // T
    G = -(-n_tiles // g)
    bpe = db_stream_bytes_per_el(db_dtype, passes)
    y_stream = M * d_eff * bpe
    yy_stream = 8 * M * 4
    if db_dtype == "int8":
        yy_stream += G * 8 * lanes * 4      # per-group scale tiles
    y_streams = 0.0
    x_bytes = 0.0
    out_bytes = 0.0
    q_left = Q
    while q_left > 0:
        qc = min(q_left, _Q_CHUNK)
        q_left -= qc
        qb_eff = min(Qb, -(-qc // 8) * 8)
        qp = -(-qc // qb_eff) * qb_eff
        nq = qp // qb_eff
        if grid_order == "query":
            y_streams += nq                 # y re-fetched per query block
            x_bytes += qp * d_eff * 4       # x fetched once per block
        elif grid_order == "db":
            y_streams += 1                  # super-block resident
            x_bytes += (M // (g * T)) * qp * d_eff * 4   # x per group
        else:                               # dbuf: both single-stream
            y_streams += 1
            x_bytes += qp * d_eff * 4
        out_bytes += 3 * qp * G * lanes * 4
    return {
        "grid_order": grid_order,
        "db_dtype": db_dtype,
        "y_bytes_per_el": bpe,
        "y_bytes": y_streams * y_stream,
        "y_stream_bytes": float(y_stream),
        "y_stream_factor": y_streams,
        "x_bytes": x_bytes,
        "yy_bytes": y_streams * yy_stream,
        "out_bytes": out_bytes,
        "total_bytes": (y_streams * (y_stream + yy_stream)
                        + x_bytes + out_bytes),
    }


def quantized_bytes_ratio(Q: int, m: int, d: int, k: int,
                          T: int, Qb: int, g: int, passes: int,
                          grid_order: str = "db") -> float:
    """Streamed database bytes of the int8 path over the bf16 one for the
    same geometry (reference ``:315``): 1/2 at passes=1, 1/4 at
    passes=3, before the scale tiles."""
    q8 = fused_traffic_model(Q, m, d, k, T, Qb, g, passes, grid_order,
                             "int8")
    bf = fused_traffic_model(Q, m, d, k, T, Qb, g, passes, grid_order,
                             "bf16")
    return q8["y_bytes"] / max(bf["y_bytes"], 1.0)


def fused_traffic_record(Q: int, m: int, d: int, k: int,
                         T: int, Qb: int, g: int, passes: int,
                         grid_order: str = "query",
                         db_dtype: str = "bf16") -> CostRecord:
    """The traffic model as a :class:`CostRecord` (entry
    ``fused_traffic_model``; reference ``:330``)."""
    model = fused_traffic_model(Q, m, d, k, T, Qb, g, passes,
                                grid_order, db_dtype)
    lanes = 128
    d_eff = d + (-d) % lanes if d <= 512 else d + (-d) % 256
    # int8 folds at most two passes (x hi + lo); bf16x3 runs three
    n_mm = ((2 if passes == 3 else 1) if db_dtype == "int8"
            else (3 if passes == 3 else 1))
    flops = 2.0 * Q * (-(-m // T) * T) * d_eff * n_mm
    return CostRecord(
        entry="fused_traffic_model",
        key=f"{grid_order};T={T};Qb={Qb};g={g};p={passes};"
            f"{db_dtype};{Q}x{m}x{d}",
        flops=flops,
        bytes_accessed=model["total_bytes"])


# ------------------------------------------------ the kernels' own work
def _k1(Q: int, M: int, d: int, S: int, passes: int):
    """K1 packed (and its d-chunked form): the bf16 products (three at
    passes=3), x, the rows (hi, and lo at passes=3), their norms and
    the query norms read once, the three [Q, S] pools written once."""
    ops = 2.0 * Q * M * d * (3 if passes == 3 else 1)
    nbytes = (Q * d * 4 + M * d * 2 * (2 if passes == 3 else 1) + M * 4
              + Q * 4 + 3 * Q * S * 4)
    return ops, nbytes, ""


def _k1_unpacked(Q: int, M: int, d: int, S: int, passes: int):
    """K1's unpacked group forms: K1's products and inputs (no query
    norms), five [Q, S] outputs (a1, a2, a3 and two ids)."""
    ops = 2.0 * Q * M * d * (3 if passes == 3 else 1)
    nbytes = (Q * d * 4 + M * d * 2 * (2 if passes == 3 else 1) + M * 4
              + 5 * Q * S * 4)
    return ops, nbytes, ""


def _k1_slot(Q: int, M: int, d: int, T: int, passes: int):
    """K1's slot forms: K1's products and inputs, m1 and i1 (8 bytes a
    slot, M / T · 128 slots a query) and m2min ([Q, 128]) written once."""
    S = M // T * 128
    ops = 2.0 * Q * M * d * (3 if passes == 3 else 1)
    nbytes = (Q * d * 4 + M * d * 2 * (2 if passes == 3 else 1) + M * 4
              + Q * 4 + 2 * Q * S * 4 + Q * 128 * 4)
    return ops, nbytes, ""


def _k2(Q: int, M: int, d: int, S: int, passes: int):
    """K2: x hi (and lo at passes=3) against exact codes on the tensor
    cores; the queries, the int8 rows, their norms, the group scales and
    the query norms read once, the three pools written once."""
    ops = 2.0 * Q * M * d * (2 if passes == 3 else 1)
    nbytes = (Q * d * 4 + M * d + M * 4 + S // 128 * 4 + Q * 4
              + 3 * Q * S * 4)
    return ops, nbytes, ""


def _k3(B: int, L: int, T: int, tpg: int):
    """K3: the rows read once and the three pools written once (its ~10
    operations a value are some 30× below that)."""
    G = -(-(-(-L // T)) // tpg)
    return 0.0, B * L * 4 + 3 * B * G * 128 * 4, ""


def _k4(nq: int, d: int, P: int, stream_rows: int, pair_rows: int,
        q8: bool = False):
    """K4 on one batch: each probed list read once (its padded rows at 4,
    or for int8 1, bytes a feature), the queries, their norms and probe
    table read once, the five [nq, 128] pools written once; passes × 2 ×
    d bf16 operations a scored (query, row) pair (3 for f32, 2 for
    int8)."""
    nbytes = (stream_rows * d * (1 if q8 else 4) + nq * d * 4 + nq * 4
              + nq * P * 4 + 5 * nq * 128 * 4)
    ops = (2 if q8 else 3) * 2.0 * d * pair_rows
    return ops, nbytes, ""


def _k4_q8(nq: int, d: int, P: int, stream_rows: int, pair_rows: int):
    return _k4(nq, d, P, stream_rows, pair_rows, q8=True)


def _k5(nq: int, S: int, bits: int, P: int, depth: int, stream_rows: int,
        pair_rows: int):
    """K5 on one batch: each probed list's codes and two 4-byte sidecars
    read once, the query norms, probe table, centroid dots (nq·P) and
    tables (nq·S·2^bits f32) read once, (2·depth + 1) [nq, 128] pools
    written once; S + 10 f32 operations a scored pair."""
    cb = S if bits == 8 else S // 2
    nbytes = (stream_rows * (cb + 8) + nq * 4 + 2 * nq * P * 4
              + nq * S * (1 << bits) * 4 + (2 * depth + 1) * nq * 128 * 4)
    return float(S + 10) * pair_rows, nbytes, "f32"


def _spmv(nnz: int, n_rows: int, n_cols: int, V: int = 1):
    """K6a/b/c, Y = A·B with B [n_cols, V]: the CSR form read once
    (nnz·8 + (n_rows + 1)·4 bytes), B read and Y written once, 2·nnz·V
    f32 operations."""
    nbytes = nnz * 8 + (n_rows + 1) * 4 + V * (n_cols + n_rows) * 4
    return 2.0 * nnz * V, nbytes, "f32"


def _k7(nnz: int, m: int, n: int, d: int):
    """K7: the structure in CSR form read and the values written once, A
    and B read once; 2·nnz·d f32 operations."""
    nbytes = nnz * 8 + (m + 1) * 4 + (m + n) * d * 4
    return 2.0 * nnz * d, nbytes, "f32"


def _k8(metric: str, n: int, m: int, d: int):
    """K8's [n, m] matrix: x and y read and the output written once; the
    FP32 instructions each of the n·m·d terms needs at the least (two:
    l1's FSUB and |·|-FADD, linf's FSUB and max, hamming's compare and
    predicated add) or, for canberra, its one SFU reciprocal."""
    terms = float(n) * m * d
    nbytes = (n + m) * d * 4 + n * m * 4
    if metric == "canberra":
        return terms, nbytes, "sfu"
    return 2.0 * terms, nbytes, "fp32_issue"


def _k9(n: int, batch: int, n_bins: int):
    """K9: the bins read and the counts written once."""
    return 0.0, (n * batch + n_bins * batch) * 4, ""


def _jv(batch: int, n: int, steps: int):
    """The LAP's JV tail: the cost matrices read and the outputs written
    once; four f32 operations a column a step."""
    return 4.0 * n * steps, batch * (4.0 * n * n + 8.0 * n), "f32"


#: kernel → its work counter; each returns (operations, bytes, rate)
KERNELS: Dict[str, Callable] = {
    "K1": _k1, "K1_dchunk": _k1, "K1_unpacked": _k1_unpacked,
    "K1_slot": _k1_slot, "K2": _k2, "K3": _k3, "K4": _k4, "K4_q8": _k4_q8,
    "K5": _k5, "K6a": _spmv, "K6b": _spmv, "K6c": _spmv, "K7": _k7,
    "K8": _k8, "K9": _k9, "JV": _jv,
}


def kernel_cost(name: str, entry: Optional[str] = None,
                **shape) -> CostRecord:
    """The :class:`CostRecord` of one launch of kernel ``name`` (a key of
    :data:`KERNELS`) at ``shape``: the least work it must do. Its
    ``roofline(rec, H100_SPEC).roof_seconds`` is the kernel's bound, the
    ``bound_ms`` that ``chip_smoke.py`` prints. ``entry`` names the
    record (default ``name``), so an entry point can carry its kernel's
    work."""
    if name not in KERNELS:
        raise ValueError(f"kernel_cost: unknown kernel {name!r}; one of "
                         f"{sorted(KERNELS)}")
    ops, nbytes, rate = KERNELS[name](**shape)
    key = ";".join(f"{k}={v}" for k, v in sorted(shape.items()))
    return CostRecord(entry=entry or name, key=f"{name};{key}",
                      flops=float(ops), bytes_accessed=float(nbytes),
                      platform="cuda", rate=rate)


def bound_ms(rec: CostRecord, spec: Optional[ChipSpec] = None):
    """(ms, "operations" or "bytes"): a record's least time on ``spec``
    (default the H100's) and what sets it."""
    if spec is None:
        from raft_tpu_torch.utils.arch import H100_SPEC

        spec = H100_SPEC
    est = roofline(rec, spec)
    return 1e3 * est.roof_seconds, ("operations" if est.bound
                                    == COMPUTE_BOUND else "bytes")


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


def _fmt_count(v: float) -> str:
    for unit, scale in (("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if abs(v) >= scale:
            return f"{v / scale:.3g}{unit}"
    return f"{v:.3g}"


def _cost_records_from_registry(reg: MetricsRegistry) -> List[CostRecord]:
    """Latest ``cost`` event per entry → CostRecords."""
    latest: Dict[str, CostRecord] = {}
    for ev in reg.events:
        if ev.get("type") != "cost":
            continue
        fields = {f.name: ev[f.name] for f in dataclasses.fields(CostRecord)
                  if f.name in ev}
        latest[ev.get("entry", "?")] = CostRecord(**fields)
    return list(latest.values())


def roofline_report(registry: Optional[MetricsRegistry] = None,
                    spec: Optional[ChipSpec] = None,
                    records: Optional[List[CostRecord]] = None,
                    timings: Optional[Dict[str, float]] = None) -> str:
    """An entry-by-entry roofline table, worst utilization first
    (reference ``:685``). Rows come from ``records`` (e.g.
    ``res.profiler.records()``) or the latest ``cost`` event an entry in
    the registry; times from ``timings`` (entry → seconds) or the
    matching benchmark events. An entry with no time still ranks and
    shows ``-`` in the measured columns."""
    from raft_tpu_torch.observability.exporters import bench_results

    reg = registry if registry is not None else get_registry()
    spec = spec if spec is not None else chip_spec()
    if records is None:
        records = _cost_records_from_registry(reg)
    if timings is None:
        timings = {name: r["seconds"]
                   for name, r in bench_results(reg).items()
                   if isinstance(r.get("seconds"), (int, float))}
    ests = [roofline(r, spec, seconds=timings.get(r.entry))
            for r in records]
    ests.sort(key=lambda e: (e.utilization is None,
                             e.utilization if e.utilization is not None
                             else 0.0))
    header = (f"roofline: {spec.name} — peak {spec.peak_flops / 1e12:.3g} "
              f"TFLOP/s, HBM {spec.hbm_bw / 1e9:.4g} GB/s, ridge "
              f"{spec.ridge:.3g} FLOP/B")
    cols = ("entry", "flops", "bytes", "AI", "bound", "time", "GB/s",
            "%roof")
    rows = []
    for e in ests:
        rows.append((
            e.entry, _fmt_count(e.flops), _fmt_count(e.bytes_accessed),
            f"{e.arithmetic_intensity:.3g}", e.bound,
            f"{e.seconds * 1e3:.3g}ms" if e.seconds else "-",
            f"{e.achieved_bw / 1e9:.3g}" if e.achieved_bw else "-",
            f"{e.utilization * 100:.1f}" if e.utilization is not None
            else "-"))
    if not rows:
        return header + "\n(no cost records captured)\n"
    widths = [max(len(c), *(len(r[i]) for r in rows))
              for i, c in enumerate(cols)]
    lines = [header,
             "  ".join(c.ljust(w) for c, w in zip(cols, widths)),
             "  ".join("-" * w for w in widths)]
    for r in rows:
        lines.append("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    return "\n".join(lines) + "\n"
