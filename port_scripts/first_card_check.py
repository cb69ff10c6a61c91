#!/usr/bin/env python3
"""A short first check of K1 and K2 on one CUDA card, before a full
``chip_smoke.py`` run: builds ``fused_l2_topk.cu``, holds K1 (Q=512 ×
M=131072 × 128) and K2 (Q=256 × 4 groups of 16 × 2048 rows × 128) against
their twins at passes 1/3 × pair off/on and times each (CUDA events, mean
of 5), runs int8 ``knn_fused`` at passes 1 and 3 over 262,144 × 128 blobs
(512 queries, k=64; ids held against the exact oracle), then the serving
phase of ``chip_smoke.py`` at 200,000 rows and 400 requests.

    python3 port_scripts/first_card_check.py
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
        print("first_card_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources, distance
    from raft_tpu_torch.distance.knn_fused import _prepare_ops_q8, knn_fused
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.random import make_blobs

    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_topk"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    Q, M, d, T, g, pbits = 512, 131072, 128, 2048, 16, 8
    x = torch.randn(Q, d, device="cuda", generator=gen)
    y = torch.randn(M, d, device="cuda", generator=gen)
    y_hi, y_lo = k1.split_hi_lo(y)
    yyh = 0.5 * (y * y).sum(1)
    yyh[-100:] = k1._PACK_PAD
    xxh = 0.5 * (x * x).sum(1)
    x2 = torch.randn(256, d, device="cuda", generator=gen)
    y2 = 2.0 * torch.randn(4 * g * T, d, device="cuda", generator=gen) + 0.5
    _, y_q, scales, yyq, _, _ = _prepare_ops_q8(y2, T, g, "l2")
    yyq[-100:] = k1._PACK_PAD
    xxh2 = 0.5 * (x2 * x2).sum(1)
    for passes in (1, 3):
        for pair in (False, True):
            kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits)
            a = (x, y_hi, y_lo, yyh)
            out = k1.fused_l2_group_topk_packed(*a, xxh=xxh, **kw)
            ref = k1.fused_l2_group_topk_packed_ref(*a, xxh=xxh, **kw)
            err = cs.compare_k1(out, ref, x, y_hi, pbits, pair)
            ms = cs.cuda_ms(lambda: k1.fused_l2_group_topk_packed(
                *a, xxh=xxh, **kw), 5)
            print(f"K1 p{passes} pair={pair}: err {err} ms {ms}", flush=True)
            b = (x2, y_q, yyq, scales)
            out = k1.fused_l2_group_topk_packed_q8(*b, xxh=xxh2, **kw)
            ref = k1.fused_l2_group_topk_packed_q8_ref(*b, xxh=xxh2, **kw)
            err = cs.compare_k2(out, ref, x2, y_q, scales, yyq, xxh2, T, g,
                                passes, pbits, pair)
            ms = cs.cuda_ms(lambda: k1.fused_l2_group_topk_packed_q8(
                *b, xxh=xxh2, **kw), 5)
            print(f"K2 p{passes} pair={pair}: (err, tie slots) {err} "
                  f"ms {ms}", flush=True)
    res = DeviceResources(device="cuda", seed=0)
    X, _ = make_blobs(res, 0, 262144, d, n_clusters=64, cluster_std=2.0)
    Qx = X[:512].clone()
    o_vals, o_ids = cs.exact_oracle(X, Qx, 64)
    for passes in (1, 3):
        idx = distance.prepare_knn_index(X, passes=passes, db_dtype="int8")
        _, ids, n_fail = knn_fused(Qx, idx, 64, with_stats=True)
        ties = cs.check_exact(ids, o_ids, o_vals, X, Qx, f"int8 p{passes}")
        print(f"int8 p{passes}: n_fail {n_fail} ties {ties}", flush=True)
    del X, Qx
    cs.SERVE_SHAPE = (200_000, d, 64, 400, 8)
    report, launches = cs.serving_phase(res)
    print(json.dumps({"serving": report, "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
