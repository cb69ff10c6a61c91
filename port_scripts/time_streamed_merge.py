#!/usr/bin/env python3
"""Time the streamed sweep's tile merge four ways on the card, within one
process, to choose how it keeps ``jax.lax.top_k``'s order of exact ties.

    python3 port_scripts/time_streamed_merge.py

make_blobs 200,000 × 128 (64 clusters, std 2.0), 2048 queries (rows plus
N(0, 0.1) noise), ``distance.knn(..., k=64, algo="streamed")``: 25 tiles
of 8192 rows, a sweep and a count. CUDA events, mean of 10, for the
shipped merge (``ranked_head`` keeping ``_MERGE_PAD`` entries past the k,
the unsure rows swept again once) and
with ``fused_l2nn._merge_topk`` replaced by: a plain ``torch.topk`` (the
order of ties left to it), the int64 (value, position) key on every row
(``lax_top_k``), and ``select_smallest`` on every tile (a host round trip
a tile). The ids of every exact variant are checked equal to the key's.
Then ``torch.topk`` alone at k = 64 and 65 on one merge's [2048, 8256]
values. Prints the card's name and power limit, then one JSON line.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_streamed_merge: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import raft_tpu_torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.core.kvp import select_smallest
    from raft_tpu_torch.distance import fused_l2nn
    from raft_tpu_torch.matrix.select_k_slotted import lax_top_k
    from raft_tpu_torch.random import make_blobs

    print(cs.gpu_name_power(), flush=True)
    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    Y, _ = make_blobs(res, 0, 200_000, 128, n_clusters=64, cluster_std=2.0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    Q = Y[:2048] + 0.1 * torch.randn(2048, 128, device="cuda",
                                     generator=gen)

    def plain(best_v, best_i, tv, ti, k, select_min, unsure=None):
        allv = torch.cat([best_v, tv], 1)
        alli = torch.cat([best_i, ti], 1)
        v, pos = torch.topk(allv, k, dim=1, largest=not select_min)
        return v, torch.gather(alli, 1, pos)

    def key(best_v, best_i, tv, ti, k, select_min, unsure=None):
        allv = torch.cat([best_v, tv], 1)
        alli = torch.cat([best_i, ti], 1)
        v, pos = lax_top_k(-allv if select_min else allv, k)
        return (-v if select_min else v), torch.gather(alli, 1, pos)

    def per_tile(best_v, best_i, tv, ti, k, select_min, unsure=None):
        allv = torch.cat([best_v, tv], 1)
        alli = torch.cat([best_i, ti], 1)
        v, pos = select_smallest(allv if select_min else -allv, k)
        return (v if select_min else -v), torch.gather(alli, 1, pos)

    shipped = fused_l2nn._merge_topk
    out, ids = {}, {}
    for name, fn in (("shipped", shipped), ("plain_topk", plain),
                     ("int64_key", key), ("select_smallest_per_tile",
                                          per_tile)):
        fused_l2nn._merge_topk = fn
        try:
            def call():
                return distance.knn(res, Y, Q, 64, algo="streamed")
            ids[name] = call()[1]
            out[name + "_ms"] = cs.cuda_ms(call, 10)
        finally:
            fused_l2nn._merge_topk = shipped
    for name in ("shipped", "select_smallest_per_tile"):
        out[name + "_ids_equal_key"] = bool(torch.equal(ids[name],
                                                        ids["int64_key"]))
    v = torch.randn(2048, 8256, device="cuda", generator=gen)
    for kk in (64, 65):
        out[f"topk_k{kk}_ms"] = cs.cuda_ms(
            lambda: torch.topk(v, kk, dim=1, largest=False), 20)
    print(json.dumps(out), flush=True)
    return 0 if all(out[n + "_ids_equal_key"] for n in (
        "shipped", "select_smallest_per_tile")) else 1


if __name__ == "__main__":
    sys.exit(main())
