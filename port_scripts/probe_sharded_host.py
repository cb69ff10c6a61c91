#!/usr/bin/env python3
"""Where the sharded KNN's host time goes on one CUDA card: on the main
path's data (make_blobs ROWS × 128, 2048 queries, k = 64, passes 3, 4
shards), host medians of 5 of the single-device ``distance.knn``, (a)
each shard's certified pipeline run one after another on the calling
thread (no merge), (c) a one-rank mesh over the whole index, (e)
``knn_fused_sharded`` with the allgather merge at 1 and 4 micro-batches;
then (a) once under torch.profiler with its top host operations by self
CPU time, and (e) at 4 micro-batches with its device busy time.

    python3 port_scripts/probe_sharded_host.py [ROWS]
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def host_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        return 2
    from torch.profiler import ProfilerActivity, profile

    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.distance import knn_sharded as ks
    from raft_tpu_torch.distance.knn_fused import _knn_fused_core
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.parallel import make_mesh
    from raft_tpu_torch.random import make_blobs

    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    print(cs.gpu_name_power(), flush=True)
    _build.build_all(["fused_l2_packed_sm90"])
    res = DeviceResources(device="cuda", seed=0)
    X, _ = make_blobs(res, 0, rows, cs.DIM, n_clusters=64, cluster_std=2.0)
    Qx = X[:cs.N_QUERIES].clone()
    mesh = make_mesh({"x": 4})
    sidx = ks.prepare_knn_index_sharded(X, mesh=mesh, passes=3)
    one = make_mesh({"x": 1})
    oidx = ks.prepare_knn_index_sharded(X, mesh=one, passes=3)
    K = cs.K
    out = {}
    nf = []

    def seq():
        nf.clear()
        for sh in sidx.shards:
            nf.append(_knn_fused_core(Qx, sh, K, True, "kernel")[2])

    from raft_tpu_torch import distance

    idx3 = distance.prepare_knn_index(X, passes=3)
    out["single_ms"] = host_ms(lambda: distance.knn(res, idx3, Qx, k=K))
    out["a_sequential_ms"] = host_ms(seq)
    out["a_n_fail"] = list(nf)
    out["c_one_rank_ms"] = host_ms(lambda: ks.knn_fused_sharded(
        Qx, oidx, K, mesh=one, merge="allgather", micro_batches=1))
    for nb in (1, 4):
        out[f"e_sharded_ms_nb{nb}"] = host_ms(lambda: ks.knn_fused_sharded(
            Qx, sidx, K, mesh=mesh, merge="allgather", micro_batches=nb))
    print(json.dumps(out), flush=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seq()
        torch.cuda.synchronize()
    rows_ = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(json.dumps({"top_host_ops": [
        {"op": e.key[:60], "self_ms": e.self_cpu_time_total / 1e3,
         "calls": e.count} for e in rows_[:20]]}), flush=True)
    print(json.dumps({"profile_sharded": cs.profile_run(
        lambda: ks.knn_fused_sharded(Qx, sidx, K, mesh=mesh,
                                     merge="allgather"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
