"""The roofline half of the port's cost model against the reference's
(``raft_tpu.observability.costmodel``), and the kernels' own cost records
against the bounds PERF.md §6 prints.

Exact equality (tolerance 0) where both packages compute the same
arithmetic: ``classify``, ``roofline``, ``fused_traffic_model``,
``quantized_bytes_ratio``, ``fused_traffic_record`` and
``roofline_report``'s text, over a seeded grid of shapes, geometries,
pass counts, grid orders and dtypes, both priced on one ``ChipSpec`` of
equal peaks. ``kernel_cost`` has no reference counterpart (the reference
asks XLA): each record's least time on the H100 spec must give the bound
PERF.md §6 prints at that kernel's shapes to 0.5% relative (the table
rounds to three or four digits).
"""

import dataclasses
import math

import numpy as np
import pytest

from raft_tpu.observability import costmodel as jcm
from raft_tpu.observability.metrics import MetricsRegistry as JRegistry
from raft_tpu.utils.arch import ChipSpec as JChipSpec
from raft_tpu_torch.observability import costmodel as cm
from raft_tpu_torch.observability.metrics import MetricsRegistry
from raft_tpu_torch.utils.arch import H100_SPEC, ChipSpec

PEAKS = dict(name="equal peaks", peak_flops=123e12, peak_flops_f32=17e12,
             hbm_bw=1.7e12, hbm_bytes=16e9, ici_bw=1e11, ici_latency=3e-6)
J_SPEC, P_SPEC = JChipSpec(**PEAKS), ChipSpec(**PEAKS)


def _grid(n=60, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        yield dict(Q=int(rng.integers(1, 5000)),
                   m=int(rng.integers(1, 3_000_000)),
                   d=int(rng.choice([3, 64, 100, 128, 257, 512, 640, 960])),
                   k=int(rng.choice([1, 10, 64, 100])),
                   T=int(rng.choice([256, 512, 1024, 2048])),
                   Qb=int(rng.choice([8, 64, 128, 256])),
                   g=int(rng.choice([1, 4, 16])),
                   passes=int(rng.choice([1, 3])),
                   grid_order=str(rng.choice(["query", "db", "dbuf"])))


@pytest.mark.parametrize("db_dtype", ["bf16", "int8"])
def test_fused_traffic_model_and_record_equal_reference(db_dtype):
    for kw in _grid():
        assert cm.fused_traffic_model(**kw, db_dtype=db_dtype) == \
            jcm.fused_traffic_model(**kw, db_dtype=db_dtype)
        rp = cm.fused_traffic_record(**kw, db_dtype=db_dtype)
        rj = jcm.fused_traffic_record(**kw, db_dtype=db_dtype)
        assert (rp.entry, rp.key, rp.flops, rp.bytes_accessed) == \
            (rj.entry, rj.key, rj.flops, rj.bytes_accessed)
        assert cm.db_stream_bytes_per_el(db_dtype, kw["passes"]) == \
            jcm.db_stream_bytes_per_el(db_dtype, kw["passes"])


def test_quantized_bytes_ratio_equals_reference():
    for kw in _grid(seed=1):
        kw = {k: v for k, v in kw.items()}
        assert cm.quantized_bytes_ratio(**kw) == jcm.quantized_bytes_ratio(
            **kw)


def _record_pairs(seed=2, n=80):
    rng = np.random.default_rng(seed)
    for i in range(n):
        fields = dict(entry=f"e{i % 7}", key=f"k{i}",
                      flops=float(rng.choice([0.0, rng.uniform(0, 1e13)])),
                      bytes_accessed=float(rng.choice(
                          [0.0, rng.uniform(0, 1e10)])),
                      peak_hbm_bytes=int(rng.integers(0, 1 << 30)))
        yield cm.CostRecord(**fields), jcm.CostRecord(**fields)


@pytest.mark.parametrize("f32", [False, True])
def test_classify_and_roofline_equal_reference(f32):
    for rp, rj in _record_pairs():
        assert rp.arithmetic_intensity == rj.arithmetic_intensity or (
            math.isnan(rp.arithmetic_intensity)
            and math.isnan(rj.arithmetic_intensity))
        assert cm.classify(rp.arithmetic_intensity, P_SPEC, f32) == \
            jcm.classify(rj.arithmetic_intensity, J_SPEC, f32)
        for seconds in (None, 0.0, 1e-6, 3e-3, 2.5):
            ep = cm.roofline(rp, P_SPEC, seconds=seconds, f32=f32)
            ej = jcm.roofline(rj, J_SPEC, seconds=seconds, f32=f32)
            assert dataclasses.asdict(ep) == dataclasses.asdict(ej)


def test_roofline_report_renders_the_reference_text():
    pairs = list(_record_pairs(seed=3, n=12))
    recs_p, recs_j = [p for p, _ in pairs], [j for _, j in pairs]
    timings = {"e1": 2e-3, "e3": 5e-6, "e4": 0.7}
    assert cm.roofline_report(MetricsRegistry(), P_SPEC, recs_p, timings) \
        == jcm.roofline_report(JRegistry(), J_SPEC, recs_j, timings)
    # from the registry's cost events (publish) and benchmark events
    rp, rj = MetricsRegistry(), JRegistry()
    for p, j in pairs:
        cm.publish(p, rp)
        jcm.publish(j, rj)
    for reg in (rp, rj):
        reg.emit({"type": "benchmark", "bench": "e2", "seconds": 1e-3})
    assert cm.roofline_report(rp, P_SPEC) == jcm.roofline_report(rj, J_SPEC)
    assert cm.roofline_report(MetricsRegistry(), P_SPEC) == \
        jcm.roofline_report(JRegistry(), J_SPEC)


#: PERF.md §6's bound column: (kernel, shape, bound ms, bound by), at the
#: shapes the card run of chip_smoke.py printed: the main path's prepared
#: rows (T = 2048, g = 16; M = 1,001,472 bf16, 1,015,808 int8), the
#: data-dependent counts of K4/K5's batch (streamed rows, scored pairs)
#: and the scale-22 R-MAT Laplacian's nnz (K6a) and structure (K7).
PERF_BOUNDS = [
    ("K1", dict(Q=2048, M=1_001_472, d=128, S=31 * 128, passes=1), 0.531,
     "operations"),
    ("K1", dict(Q=2048, M=1_001_472, d=128, S=31 * 128, passes=3), 1.593,
     "operations"),
    ("K2", dict(Q=2048, M=1_015_808, d=128, S=31 * 128, passes=1), 0.538,
     "operations"),
    ("K2", dict(Q=2048, M=1_015_808, d=128, S=31 * 128, passes=3), 1.077,
     "operations"),
    ("K3", dict(B=256, L=1 << 20, T=8192, tpg=4), 0.324, "bytes"),
    ("K4", dict(nq=2048, d=128, P=32, stream_rows=1_004_696,
                pair_rows=69_655_724), 0.156, "bytes"),
    ("K5", dict(nq=2048, S=32, bits=8, P=32, depth=2,
                stream_rows=1_004_696, pair_rows=69_655_724), 0.0437,
     "operations"),
    ("K6a", dict(nnz=138_412_032, n_rows=1 << 22, n_cols=1 << 22), 0.346,
     "bytes"),
    ("K7", dict(nnz=134_217_728, m=1 << 22, n=1 << 22, d=64), 0.967,
     "bytes"),
    ("K8", dict(metric="l1", n=2048, m=1_000_000, d=128), 15.672,
     "operations"),
    ("K8", dict(metric="canberra", n=2048, m=1_000_000, d=128), 62.687,
     "operations"),
    ("K9", dict(n=1_000_000, batch=128, n_bins=64), 0.1528, "bytes"),
]


@pytest.mark.parametrize("kernel,shape,want,by", PERF_BOUNDS)
def test_kernel_cost_gives_perf_bound(kernel, shape, want, by):
    rec = cm.kernel_cost(kernel, **shape)
    ms, got_by = cm.bound_ms(rec, H100_SPEC)
    assert abs(ms - want) <= 0.005 * want, (ms, want)
    assert got_by == by
    est = cm.roofline(rec, H100_SPEC)
    assert est.roof_seconds * 1e3 == ms


def test_kernel_cost_rates_and_entries():
    rec = cm.kernel_cost("K8", entry="distance.pairwise_distance",
                         metric="canberra", n=8, m=9, d=10)
    assert rec.entry == "distance.pairwise_distance"
    assert rec.rate == "sfu" and rec.flops == 8 * 9 * 10
    assert cm.kernel_cost("K8", metric="l1", n=8, m=9, d=10).rate == \
        "fp32_issue"
    for kernel in ("K5", "K6a", "K6b", "K6c", "K7", "JV"):
        assert cm.KERNELS[kernel] is not None
    with pytest.raises(ValueError):
        cm.kernel_cost("K10", n=1)
    # a rate the spec does not carry falls back to its f32 peak
    rec = cm.kernel_cost("K8", metric="l1", n=64, m=64, d=64)
    assert cm.roofline(rec, P_SPEC).roof_flops <= P_SPEC.peak_flops_f32
