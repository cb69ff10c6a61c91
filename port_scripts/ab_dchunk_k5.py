#!/usr/bin/env python3
"""K1's d-chunked form, K5 and select_k's AUTO of several checkouts of the
port, run one after another within one card call, to compare two commits.

    python3 port_scripts/ab_dchunk_k5.py TREE [TREE ...]

Each TREE (a directory holding ``chip_smoke.py`` and ``raft_tpu_torch``,
e.g. this checkout and a ``git archive`` of its parent under the
git-ignored ``build/``) runs in its own process, in the order given (run
parent, change, change, parent), with that tree's own code and kernels:

- wide_knn's shape (make_blobs 1,000,000 × 960, 64 clusters, std 2.0,
  the first 1000 rows as queries): ``fused_l2_group_topk_packed_dchunk``
  at passes 1 and 3 on the prepared index's operands (CUDA events, mean
  of 10 launches) and ``distance.knn`` (k = 100, host-clock median of 5
  after one warm-up) at passes 1 and 3;
- IVF-PQ (``chip_smoke.ann_data``: 1,000,000 × 128 blobs, 2048 queries;
  8- and 4-bit indexes of 1024 lists): K5 on each batch's own operands
  (``chip_smoke.k5_inputs``) at P = 32 and 128, pool depth 2, 4 and 8:
  the wrapper's time between CUDA events (mean of 5, host work between
  launches included) and the kernel's own device time under
  torch.profiler (``chip_smoke.kernel_ms`` of this checkout:
  ``pq_scan_kernel``, mean of 5 launches, no host work),
  and ``search_ivf_pq`` at P = 32 (k = 10, host median of 5);
- ``select_k`` with AUTO on [256, 1,048,576] N(0, 1) f32 at k = 16, 64
  and 256 (host median of 5 after one warm-up);
- the resident packed K1 and K2, whose source the d-chunked kernel now
  shares, at the main path's shape (make_blobs 1,000,000 × 128, 2048
  queries; pair at passes=1, as knn_fused runs them; mean of 10).

Prints the card's name and power limit, then one JSON line a run; each
run's output also goes to ``chiprun_out/ab_dchunk_k5_<i>.log``. Exits 1
if a run failed.
"""

import importlib.util
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


def kernel_ms(fn, name: str):
    """``chip_smoke.kernel_ms`` of this checkout (the trees measured may
    predate it): the kernels named ``name`` alone, under torch.profiler."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    return here.kernel_ms(fn, name)


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    import raft_tpu_torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.ann import build_ivf_pq, search_ivf_pq
    from raft_tpu_torch.matrix import select_k
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.ops import pq_scan as k5
    from raft_tpu_torch.random import make_blobs

    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    out = {"tree": root}

    X, _ = make_blobs(res, 13, 1_000_000, 960, n_clusters=64,
                      cluster_std=2.0)
    Qx = X[:1000].clone()
    for passes in (1, 3):
        idx = distance.prepare_knn_index(X, passes=passes)
        x = cs.padded_queries(idx, Qx)
        kw = dict(T=idx.T, g=idx.g, passes=passes, pair=False,
                  pbits=idx.pbits, xxh=0.5 * (x * x).sum(1))
        args = (x, idx.y_hi, idx.y_lo, idx.yyh_k)
        out[f"dchunk_p{passes}_ms"] = cs.cuda_ms(
            lambda: k1.fused_l2_group_topk_packed_dchunk(*args, **kw), 10)
        out[f"wide_knn_p{passes}_ms"] = host_median_ms(
            lambda: distance.knn(res, idx, Qx, k=100))
        del idx, x, args
        torch.cuda.empty_cache()
    del X, Qx
    torch.cuda.empty_cache()

    data = cs.ann_data(res, 1_000_000, 2048)
    for bits in (8, 4):
        index = build_ivf_pq(res, data["X"], 1024, max_iter=8, seed=3,
                             pq_bits=bits)
        for P in (32, 128):
            inp = cs.k5_inputs(res, index, data["Q"], P)
            for depth in (2, 4, 8):
                def run():
                    return k5.pq_scan_list_major(
                        *inp["args"], pq_bits=bits, pool_depth=depth)
                out[f"k5_{bits}bit_p{P}_d{depth}_ms"] = cs.cuda_ms(run, 5)
                out[f"k5_{bits}bit_p{P}_d{depth}_kernel_ms"] = kernel_ms(
                    run, "pq_scan_kernel")
            del inp
        out[f"ivf_pq{bits}_p32_ms"] = host_median_ms(
            lambda: search_ivf_pq(res, index, data["Q"], 10, n_probes=32,
                                  pq_scan="pq"))
        del index
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    v = torch.randn(256, 1_048_576, device="cuda", generator=gen)
    for k in (16, 64, 256):
        out[f"select_k_auto_k{k}_ms"] = host_median_ms(
            lambda: select_k(res, v, k=k))
    del v

    X, _ = make_blobs(res, 0, 1_000_000, 128, n_clusters=64,
                      cluster_std=2.0)
    Qx = X[:2048].clone()
    xxh = 0.5 * (Qx * Qx).sum(1)
    for passes in (1, 3):
        for db in ("bf16", "int8"):
            idx = distance.prepare_knn_index(X, passes=passes, db_dtype=db)
            kw = dict(T=idx.T, g=idx.g, passes=passes, pair=passes == 1,
                      pbits=idx.pbits, xxh=xxh)
            if db == "int8":
                out[f"K2_p{passes}_ms"] = cs.cuda_ms(
                    lambda: k1.fused_l2_group_topk_packed_q8(
                        Qx, idx.y_q, idx.yyh_k, idx.scales, **kw), 10)
            else:
                out[f"K1_p{passes}_ms"] = cs.cuda_ms(
                    lambda: k1.fused_l2_group_topk_packed(
                        Qx, idx.y_hi, idx.y_lo, idx.yyh_k, **kw), 10)
            del idx
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(cs.gpu_name_power(), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    for i, tree in enumerate(sys.argv[1:]):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True, timeout=1200)
        with open(os.path.join(HERE, "chiprun_out",
                               f"ab_dchunk_k5_{i}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
