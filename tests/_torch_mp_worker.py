"""One rank of tests/test_torch_multiprocess.py (torch only, no JAX):
joins a gloo process group through the launcher environment, runs the
comms battery over it, then its part of a database-sharded KNN, and
prints what it found. Exits non-zero on any failure."""

import os
import sys

import numpy as np
import torch

from raft_tpu_torch import comms
from raft_tpu_torch.comms import test_battery
from raft_tpu_torch.distance import knn_fused_shard, prepare_knn_index_shard
from raft_tpu_torch.distance.knn_fused import knn_fused


def main() -> int:
    torch.set_num_threads(1)
    port = os.environ["RAFT_TPU_TEST_PORT"]
    rank, size = comms.initialize_mpi_comms(coordinator_port=int(port),
                                            backend="gloo")
    try:
        c = comms.process_comms(device="cpu")
        got = test_battery.run_battery(c)
        print(f"rank {rank} battery {sorted(k for k, v in got.items() if v)}")
        if not all(got.values()):
            print(f"FAIL battery {got}")
            return 1
        print("battery complete")
        rng = np.random.default_rng(7)
        y = rng.normal(size=(4100, 32)).astype(np.float32)
        x = rng.normal(size=(33, 32)).astype(np.float32)
        cfg = dict(T=256, Qb=32, g=2)
        shard, off = prepare_knn_index_shard(y, rank, size, device="cpu",
                                             **cfg)
        ov, oi = knn_fused(torch.from_numpy(x), torch.from_numpy(y), 7,
                           T=256, g=2)
        for merge in ("allgather", "tournament"):
            v, i = knn_fused_shard(c, x, shard, off, 7, merge=merge,
                                   micro_batches=2)
            same = (torch.equal(i, oi) and torch.equal(
                v.view(torch.int32), ov.view(torch.int32)))
            print(f"rank {rank} sharded knn {merge} "
                  f"{'ok' if same else 'FAIL'}")
            if not same:
                return 1
    finally:
        comms.shutdown_distributed()
    return 0


if __name__ == "__main__":
    sys.exit(main())
