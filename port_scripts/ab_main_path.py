#!/usr/bin/env python3
"""Host-clock time of the main path of one checkout of the port, to
compare two commits within one card call.

    python3 port_scripts/ab_main_path.py [--profile] [--wide] TREE [TREE ...]

Each TREE (a directory holding ``raft_tpu_torch``, e.g. this checkout and
a ``git archive`` of its parent) runs in its own process, in the order
given (run parent, change, change, parent): make_blobs 1,000,000 × 128
(64 clusters, std 2.0), the first 2048 rows as queries, ``distance.knn``
(k=64) at passes 1 and 3, at passes 1 with ``certify="f32"`` (the exact
fixup of every query) and over the int8 index at passes 1 and 3 (K2 and
its fixup), two warm-up calls each, then the median, min and max
of 10 host-clock calls, and the mean of 10 back-to-back calls between two
CUDA events. ``--wide`` adds ``chip_smoke.py``'s wide_knn cells on its
data (make_blobs 1,000,000 × 960, seed 13, the first 1000 rows as
queries, k=100; K1's d-chunked form): passes 3, passes 1 with
``certify="f32"`` and the int8 request (stored bf16) at passes 3.
Prints one JSON line per tree. ``--profile`` adds, per
run, one torch.profiler trace of a call: the number of aten calls, the
host time of the call and the ten ops with the most host time.
"""

import json
import os
import statistics
import subprocess
import sys
import time


def host_profile(fn) -> dict:
    """aten calls, host ms and the top host ops of one ``fn()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    ops = [e for e in prof.key_averages() if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:10]
    return {"wall_ms": wall, "aten_calls": sum(e.count for e in ops),
            "top_host": [(e.key, e.count, e.self_cpu_time_total / 1e3)
                         for e in top]}


#: (name, make_blobs seed, rows, width, queries, k, runs); a run is
#: (name, passes, db_dtype, certify)
MAIN = ("main", 0, 1_000_000, 128, 2048, 64,
        (("p1", 1, "bf16", "kernel"), ("p3", 3, "bf16", "kernel"),
         ("p1_f32", 1, "bf16", "f32"), ("int8_p1", 1, "int8", "kernel"),
         ("int8_p3", 3, "int8", "kernel")))
WIDE = ("wide", 13, 1_000_000, 960, 1000, 100,
        (("p3", 3, "bf16", "kernel"), ("p1_f32", 1, "bf16", "f32"),
         ("int8_p3", 3, "int8", "kernel")))


def measure(root: str, with_profile: bool = False,
            wide: bool = False) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import raft_tpu_torch

    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    out = {"tree": root}
    for cell in (MAIN, WIDE) if wide else (MAIN,):
        tag, cell_out = cell[0], measure_cell(res, cell, with_profile)
        out.update(cell_out if tag == "main"
                   else {f"{tag}_{k}": v for k, v in cell_out.items()})
        torch.cuda.empty_cache()
    return out


def measure_cell(res, cell, with_profile: bool) -> dict:
    import torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.random import make_blobs

    _, seed, n, d, nq, k, runs = cell
    X, _ = make_blobs(res, seed, n, d, n_clusters=64, cluster_std=2.0)
    Qx = X[:nq].clone()
    out = {}
    idx = None
    for name, p, db, certify in runs:
        if idx is None or (idx.passes, idx.db_dtype) != (p, db):
            idx = None          # free the previous index first
            idx = distance.prepare_knn_index(X, passes=p, db_dtype=db)

        def call():
            return distance.knn(res, idx, Qx, k=k, certify=certify)
        for _ in range(2):
            call()
        t = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            t.append(1e3 * (time.perf_counter() - t0))
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(10):
            call()
        stop.record()
        torch.cuda.synchronize()
        out[name] = {"median_ms": statistics.median(t), "min_ms": min(t),
                     "max_ms": max(t),
                     "events_ms": start.elapsed_time(stop) / 10}
        if with_profile:
            out[name]["profile"] = host_profile(call)
    return out


def main() -> int:
    args = sys.argv[1:]
    flags = [a for a in args if a in ("--profile", "--wide")]
    args = [a for a in args if a not in flags]
    if len(args) == 2 and args[0] == "--one":
        print(json.dumps(measure(args[1], "--profile" in flags,
                                 "--wide" in flags)), flush=True)
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    for tree in args:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                             "--one", tree] + flags).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
