#!/usr/bin/env python3
"""The serving phase and the IVF searches of several checkouts of the
port, run one after another within one card call, to compare two commits
on the paths that a change to the exact selections reaches outside the
main path.

    python3 port_scripts/ab_serving_ivf.py TREE [TREE ...]

Each TREE (a directory holding ``chip_smoke.py`` and ``raft_tpu_torch``,
e.g. this checkout and a ``git archive`` of its parent under the
git-ignored ``build/``) runs in its own process, in the order given (run
parent, change, change, parent), with that tree's own code:

- ``chip_smoke.serving_phase``: brute_bf16 and brute_int8, 2000 requests
  from 8 clients each (p50, p99, requests/s, fixups, device busy and idle
  share of a profiled burst);
- ``chip_smoke.ann_data`` (1,000,000 × 128, 2048 queries), one IVF-Flat
  f32 and one IVF-PQ 8-bit index of 1024 lists, then the host-clock
  median of 5 searches (after one warm-up) of ``search_ivf_flat`` at P =
  32 and 128 and ``search_ivf_pq`` at P = 32 and 128, k = 10;
- the coarse probe alone (``ivf_flat._coarse_probe``: the streamed
  ``distance.knn`` over the 1024 centroids) at P = 32 and 128, and the
  streamed ``distance.knn`` over 200,000 rows of the same data (k = 64,
  25 tiles of 8192 rows, two sweeps and a count), CUDA events, mean of 10.

Each run's output goes to ``chiprun_out/ab_serving_ivf_<i>.log``; after
the card's name and power limit, one JSON line a run. Exits 1 if a run
failed.
"""

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_median_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    t = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(t)


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    import raft_tpu_torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.ann import (build_ivf_flat, build_ivf_pq,
                                    search_ivf_flat, search_ivf_pq)
    from raft_tpu_torch.ann import ivf_flat
    from raft_tpu_torch.ops import _build

    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    csrc = os.listdir(_build.CSRC)
    _build.build_all([n for n in ("fused_l2_packed_sm90", "fused_l2_topk",
                                  "fine_scan", "pq_scan", "select_slotted")
                      if f"{n}.cu" in csrc])
    out = {"tree": root}
    serving, _ = cs.serving_phase(res)
    out["serving"] = {
        cell: {"p50_ms": r["p50_ms"], "p99_ms": r["p99_ms"],
               "throughput_rps": r["throughput_rps"], "batches": r["batches"],
               "fixups": r["fixups"],
               "device_busy_ms": r["profile"]["device_busy_ms"],
               "idle_share": r["profile"]["idle_share"]}
        for cell, r in serving.items()}
    torch.cuda.empty_cache()

    data = cs.ann_data(res, cs.N_INDEX, cs.N_QUERIES)
    X, Q = data["X"], data["Q"]
    flat = build_ivf_flat(res, X, cs.IVF_LISTS, max_iter=8, seed=3)
    pq = build_ivf_pq(res, X, cs.IVF_LISTS, max_iter=8, seed=3, pq_bits=8)
    for P in (32, 128):
        out[f"ivf_p{P}_ms"] = host_median_ms(lambda: search_ivf_flat(
            res, flat, Q, cs.IVF_K, n_probes=P, fine_scan="list"))
        out[f"pq8_p{P}_ms"] = host_median_ms(lambda: search_ivf_pq(
            res, pq, Q, cs.IVF_K, n_probes=P, pq_scan="pq"))
        out[f"coarse_p{P}_ms"] = cs.cuda_ms(
            lambda: ivf_flat._coarse_probe(res, flat.centroids, Q, P), 10)
    Y = X[:200_000].contiguous()
    out["streamed_knn_ms"] = cs.cuda_ms(
        lambda: distance.knn(res, Y, Q, 64, algo="streamed"), 10)
    return out


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(measure(args[1])), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from chip_smoke import gpu_name_power

    print(gpu_name_power(), flush=True)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    failed = False
    for i, tree in enumerate(args):
        log = os.path.join(out_dir, f"ab_serving_ivf_{i}.log")
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                 "--one", os.path.abspath(tree)],
                                cwd=os.path.abspath(tree), stdout=f,
                                stderr=subprocess.STDOUT).returncode
        with open(log) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        last = lines[-1] if lines else ""
        if rc or not last.startswith("{"):
            print(json.dumps({"tree": tree, "rc": rc, "last": last}),
                  flush=True)
            failed = True
            continue
        print(last, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
