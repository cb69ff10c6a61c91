#!/usr/bin/env python3
"""A short first check of K1's slot forms on one CUDA card, before a full
``chip_smoke.py`` run: builds ``fused_l2_packed_sm90.cu`` (K1's packed,
d-chunked and slot forms, K2), ``fused_l2_topk.cu`` (K1's unpacked
forms: it must export no slot form) and ``fine_scan.cu`` (K4), prints
every slot instance's ``ptxas`` registers and spills (fails where one
spills or is missing) and any note of ptxas serialising a ``wgmma``,
holds K1/K2 and both slot forms against their twins with ±inf and NaN
planted (phase 2), runs ``chip_smoke.k1_ladder`` and
``chip_smoke.slot_dchunk_rows`` at a reduced size, and K4's planted-row
check on a small IVF-Flat index.

    python3 port_scripts/first_slot_check.py [ROWS QUERIES WIDE_ROWS]

(default 200000 512 100000: the ladder's make_blobs rows × 128 and
queries, and the wide data's rows × 960 with 256 queries).
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
        print("first_slot_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources, distance
    from raft_tpu_torch.ann import build_ivf_flat
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.random import make_blobs

    n, nq, n_wide = (int(a) for a in (sys.argv[1:4] or (200_000, 512,
                                                          100_000)))
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk", "fine_scan"])
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "wgmma" in line or "C75" in line:
                print(f"ptxas {name} note: {line.strip()}", flush=True)
    regs = cs.ptxas_packed(_build.BUILD_LOG.get("fused_l2_packed_sm90", ""))
    slot = {k: v for k, v in regs.items() if k.startswith("slot_")}
    print(json.dumps({"slot_ptxas": slot}), flush=True)
    cs.check(len(regs) == cs.PACKED_INSTANCES and all(
        r.get("spill_bytes") == 0 for r in regs.values()),
        f"wgmma instances spill or are missing: {regs}")
    cs.check(not hasattr(_build.load("fused_l2_topk"),
                         "fused_l2_slot_topk_launch"),
             "fused_l2_topk.cu still exports a slot form")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    cs.nonfinite_k1_k2(gen)
    cs.nonfinite_slot(gen)
    print(f"nonfinite K1/K2 and slot: {time.time() - t0:.1f} s", flush=True)
    res = DeviceResources(device="cuda", seed=0)
    X, _ = make_blobs(res, 0, n, 128, n_clusters=64, cluster_std=2.0)
    Qx = X[:nq].clone()
    idx1 = distance.prepare_knn_index(X, passes=1)
    idx3 = distance.prepare_knn_index(X, passes=3)
    t0 = time.time()
    ladder, entry = cs.k1_ladder(idx1, idx3, Qx)
    print(f"k1_ladder: {time.time() - t0:.1f} s "
          f"{json.dumps(ladder['split_p1_ms'])}", flush=True)
    del idx1, idx3
    index = build_ivf_flat(res, X, 256, max_iter=4, seed=3)
    inp = cs.k4_inputs(res, index, Qx[:256], 16)
    print(f"K4 with ±inf/NaN planted: max_abs_err="
          f"{cs.k4_nonfinite(inp)}", flush=True)
    del index, inp, X, Qx
    torch.cuda.empty_cache()
    W, _ = make_blobs(res, 13, n_wide, 960, n_clusters=64, cluster_std=2.0)
    Wq = W[:256].clone()
    w1 = distance.prepare_knn_index(W, passes=1)
    w3 = distance.prepare_knn_index(W, passes=3)
    t0 = time.time()
    _, entry_w = cs.slot_dchunk_rows((w1, w3), Wq)
    print(f"slot_dchunk_rows: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [entry, entry_w]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
