#!/usr/bin/env python3
"""A short first check of the packed Hopper kernel (K1 packed and K2,
``raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu``) on one CUDA card,
before a full ``chip_smoke.py`` run: builds it, prints each instance's
``ptxas`` registers and spills and its SASS fold count
(``chip_smoke.sass_fold_ops``), holds K1 and K2 against their twins at d =
128 and 512 (``chip_smoke.k1_k2_twins``: a ragged query count, a partial
last group, a padded tail) and with ±inf/NaN planted
(``chip_smoke.nonfinite_k1_k2``), then times both at the main path's
shape (2048 × 1M × 128 N(0, 1), T = 2048, g = 16; CUDA events, mean of
10) beside their bounds and ``torch.matmul`` in bf16 (~1 min of command
time).

    python3 port_scripts/first_packed_check.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("first_packed_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.distance.knn_fused import _prepare_ops_q8
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_l2_topk as k1

    card = cs.gpu_name_power()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_packed_sm90"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        cs.ptxas_report(name, log)
        print(log, flush=True)
    print(json.dumps({"sass_fold_ops": cs.sass_fold_ops()}), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for d in (128, 512):
        cs.k1_k2_twins(gen, d=d)
    cs.nonfinite_k1_k2(gen)

    Q, M, d, T, g, pbits = 2048, 1001472, 128, 2048, 16, 8
    x = torch.randn(Q, d, device="cuda", generator=gen)
    y = torch.randn(M, d, device="cuda", generator=gen)
    y_hi, y_lo = k1.split_hi_lo(y)
    yyh = 0.5 * (y * y).sum(1)
    xxh = 0.5 * (x * x).sum(1)
    rows = {}
    for passes, pair in ((1, True), (3, False)):
        kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits, xxh=xxh)
        args = (x, y_hi, y_lo, yyh)
        if passes == 1:
            out = k1.fused_l2_group_topk_packed(*args, **kw)
            ref = k1.fused_l2_group_topk_packed_ref(*args, **kw)
            err = cs.compare_k1(out, ref, x, y_hi, pbits, pair)
            print(f"K1 main shape p1 vs twin: max_abs_err={err}", flush=True)
            del out, ref
        ms = cs.cuda_ms(lambda: k1.fused_l2_group_topk_packed(*args, **kw),
                        10)
        S = -(-(M // T) // g) * 128
        bound, _ = cs.k1_bound_ms(Q, M, d, S, passes)
        rows[f"K1_p{passes}"] = {"ms": ms, "bound_ms": bound}
    M8 = 31 * g * T
    y8 = torch.randn(M8, d, device="cuda", generator=gen)
    _, y_q, scales, yyq, _, _ = _prepare_ops_q8(y8, T, g, "l2")
    del y8
    for passes, pair in ((1, True), (3, False)):
        kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits, xxh=xxh)
        args = (x, y_q, yyq, scales)
        ms = cs.cuda_ms(lambda: k1.fused_l2_group_topk_packed_q8(*args, **kw),
                        10)
        bound, _ = cs.k2_bound_ms(Q, M8, d, M8 // (g * T) * 128, passes)
        rows[f"K2_p{passes}"] = {"ms": ms, "bound_ms": bound}
    xb = x.to(torch.bfloat16)
    rows["matmul_bf16_ms"] = cs.cuda_ms(lambda: torch.matmul(xb, y_hi.T), 10)
    print(json.dumps({"card": card, "main_shape": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
