#!/usr/bin/env python3
"""A short first check of K1's d-chunked wgmma kernel and the redesigned
K5 on one CUDA card, before a full ``chip_smoke.py`` run: builds
``fused_l2_packed_sm90.cu``, ``fused_l2_topk.cu`` and ``pq_scan.cu``,
prints every packed instance's ``ptxas`` registers and spills, holds the
d-chunked kernel against its twin in each shipped geometry
(``chip_smoke.DCHUNK_TWINS``), K1/K2 resident and the unpacked and
slot forms against theirs, runs ``chip_smoke.pq_phase`` at a reduced size
(K5 bit for bit against its twin at every rung), then times the d-chunked
kernel's geometries at wide_knn's shape (``sweep_dchunk_geometry``)
and K1/K2 resident at the main path's beside ``chip_smoke.GUARD_MS``.

    python3 port_scripts/first_wide_pq_check.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from port_scripts.sweep_dchunk_geometry import (  # noqa: E402
    build_sweep, sweep)


def unpacked_twins(gen):
    """The unpacked forms (resident at d = 128, streamed at d = 640)
    against their twins, one and several segments."""
    from raft_tpu_torch.ops import fused_l2_topk as k1

    for d, kern, twin in ((128, k1.fused_l2_group_topk,
                           k1.fused_l2_group_topk_ref),
                          (640, k1.fused_l2_group_topk_dchunk,
                           k1.fused_l2_group_topk_dchunk_ref)):
        x = torch.randn(200, d, device="cuda", generator=gen)
        y = torch.randn(16 * 512, d, device="cuda", generator=gen)
        y_hi, y_lo = k1.split_hi_lo(y)
        yyh = 0.5 * (y * y).sum(1)
        yyh[-50:] = float("inf")
        for passes in (1, 3):
            for segs in (1, 4):
                kw = dict(T=512, g=64, passes=passes)
                out = kern(x, y_hi, y_lo, yyh, segments=segs, **kw)
                ref = twin(x, y_hi, y_lo, yyh, **kw)
                err, n = cs.compare_unpacked(out, ref, x, y_hi, y_lo, yyh,
                                             passes)
                print(f"unpacked d={d} p{passes} S={segs}: max_abs_err="
                      f"{err} id_diffs={n}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("first_wide_pq_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_l2_topk as k1

    card = cs.gpu_name_power()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk", "pq_scan"])
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        cs.ptxas_report(name, log)
    regs = cs.ptxas_packed(_build.BUILD_LOG["fused_l2_packed_sm90"])
    print(json.dumps({"packed_ptxas": regs}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    cs.dchunk_twins_all(gen)
    cs.k1_k2_twins(gen, d=128)
    cs.nonfinite_k1_k2(gen)
    cs.nonfinite_slot(gen)
    unpacked_twins(gen)
    res = DeviceResources(device="cuda", seed=0)
    data = cs.ann_data(res, 200_000, 512)
    t0 = time.time()
    _, entries = cs.pq_phase(res, data, 256)
    print(f"pq_phase: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"k5_entries": entries}), flush=True)
    del data
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "dchunk_sweep": sweep(
        res, build_sweep())}), flush=True)

    Q, M, d, T, g, pbits = 2048, 1001472, 128, 2048, 16, 8
    x = torch.randn(Q, d, device="cuda", generator=gen)
    y = torch.randn(M, d, device="cuda", generator=gen)
    y_hi, y_lo = k1.split_hi_lo(y)
    yyh = 0.5 * (y * y).sum(1)
    xxh = 0.5 * (x * x).sum(1)
    rows = {}
    for passes, pair in ((1, True), (3, False)):
        kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits, xxh=xxh)
        rows[f"K1_p{passes}"] = cs.cuda_ms(
            lambda: k1.fused_l2_group_topk_packed(x, y_hi, y_lo, yyh, **kw),
            10)
    print(json.dumps({"card": card, "resident_ms": rows,
                      "guard_ms": {k: cs.GUARD_MS[k] for k in rows}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
