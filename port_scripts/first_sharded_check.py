#!/usr/bin/env python3
"""A short check of phase 19 (the mesh, the comms layer and the sharded
KNN) on one CUDA card, before a full ``chip_smoke.py`` run: builds K1/K2
(``fused_l2_packed_sm90.cu``), makes the main path's data (make_blobs
ROWS × 128, 64 clusters, std 2.0, the first 2048 rows as queries), runs
``chip_smoke.sharded_phase`` on it (the database-sharded KNN at every
merge, the ladder, the mesh engine, NCCL at world size 1) and then
``chip_smoke.sharded_ivf_cell`` on an IVF-Flat index of IVF_ROWS rows and
IVF_LISTS lists built from phase 5's recipe, each check fatal as in the
whole script.

    python3 port_scripts/first_sharded_check.py [ROWS IVF_ROWS IVF_LISTS]

(defaults 1,000,000, 200,000 and 256; about 2 min of command time, 40 s
of it the build).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("first_sharded_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources, distance
    from raft_tpu_torch.ann import build_ivf_flat
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.random import make_blobs

    args = [int(a) for a in sys.argv[1:]]
    rows, ivf_rows, ivf_lists = (args + [1_000_000, 200_000, 256][len(args):])
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_packed_sm90"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    res = DeviceResources(device="cuda", seed=0)
    X, _ = make_blobs(res, 0, rows, cs.DIM, n_clusters=64, cluster_std=2.0)
    Qx = X[:cs.N_QUERIES].clone()
    idx1 = distance.prepare_knn_index(X, passes=1)
    idx3 = distance.prepare_knn_index(X, passes=3)
    t0 = time.time()
    report, launches = cs.sharded_phase(res, X, Qx, idx1, idx3)
    print(f"sharded_phase: {time.time() - t0:.1f} s, launches {launches}",
          flush=True)
    del X, Qx, idx1, idx3
    torch.cuda.empty_cache()
    data = cs.ann_data(res, ivf_rows, cs.N_QUERIES)
    index = build_ivf_flat(res, data["X"], ivf_lists, max_iter=8, seed=3)
    t0 = time.time()
    cs.sharded_ivf_cell(res, index, data)
    print(f"sharded_ivf_cell: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
