#!/usr/bin/env python3
"""K1's and K2's device time at the main path's shape for several
checkouts of the port, to compare two commits within one card call.

    python3 port_scripts/ab_k1.py TREE [TREE ...]

Each TREE (a directory holding ``raft_tpu_torch``, e.g. this checkout and
a ``git archive`` of its parent under the git-ignored ``build/``) runs in
its own process, in the order given (run parent, change, change, parent),
and builds its own kernels (``fused_l2_packed_sm90.cu`` for K1 and K2
where the tree has it, else ``fused_l2_topk.cu``): make_blobs 1,000,000 ×
128 (64 clusters, std 2.0), the first 2048 rows as queries, the bf16 and int8
indexes at passes 1 and 3, then the mean of 20 back-to-back launches of
K1 and K2 between two CUDA events (pair at passes=1, as knn_fused runs
them) and the host-clock median of 10 ``distance.knn`` calls at passes 1.
Prints one JSON line per tree.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import raft_tpu_torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.random import make_blobs

    def cuda_ms(fn, reps=20):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    X, _ = make_blobs(res, 0, 1_000_000, 128, n_clusters=64,
                      cluster_std=2.0)
    Qx = X[:2048].clone()
    xxh = 0.5 * (Qx * Qx).sum(1)
    out = {"tree": root}
    for p in (1, 3):
        for db in ("bf16", "int8"):
            idx = distance.prepare_knn_index(X, passes=p, db_dtype=db)
            kw = dict(T=idx.T, g=idx.g, passes=p, pair=p == 1,
                      pbits=idx.pbits, xxh=xxh)
            if db == "int8":
                out[f"K2_p{p}_ms"] = cuda_ms(
                    lambda: k1.fused_l2_group_topk_packed_q8(
                        Qx, idx.y_q, idx.yyh_k, idx.scales, **kw))
            else:
                out[f"K1_p{p}_ms"] = cuda_ms(
                    lambda: k1.fused_l2_group_topk_packed(
                        Qx, idx.y_hi, idx.y_lo, idx.yyh_k, **kw))
            if p == 1 and db == "bf16":
                times = []
                for _ in range(11):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    distance.knn(res, idx, Qx, k=64)
                    torch.cuda.synchronize()
                    times.append(1e3 * (time.perf_counter() - t0))
                out["knn_p1_ms"] = statistics.median(times[1:])
            del idx
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    for tree in sys.argv[1:]:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True, timeout=600)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
