"""Subprocess driver of the port's crash-recovery matrix.

Usage: ``python tests/_torch_crash_worker.py <durable_dir> <site> <nth>
<side_dir>``: builds a durable ``raft_tpu_torch`` ``MutableIndex`` on the
CPU, applies a scripted mutation sequence, and SIGKILLs itself on the
``nth`` call to fault site ``site`` (it wraps
``raft_tpu_torch.resilience.faults.fault_point``, the seam the durability
plane calls, and takes it all the way to process death).

Evidence (the parent test reads both):

- ``side_dir/submitted.jsonl``: one fsynced line per op, written before
  the op is applied;
- ``side_dir/acked.jsonl``: one fsynced line per op, written after the
  apply returned, past the index's fsync horizon (the op is acked).

Every op changes the live state, so the recovered state matches exactly
one prefix of the submitted stream. Rows derive from :func:`row_for`, so
the parent rebuilds the oracle without IPC. Imports nothing of jax or of
the JAX package.
"""

from __future__ import annotations

import json
import os
import signal
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

D = 8
BASE_ROWS = 64
SEED = 0
GEOM = dict(T=256, g=2, passes=3)


def row_for(ext: int, d: int = D):
    """Deterministic row content per external id (the parent mirrors
    it)."""
    import numpy as np

    return (((ext * 37 + np.arange(d)) % 101).astype(np.float32)
            / 10.0 - 5.0)


def base_matrix():
    import numpy as np

    rng = np.random.default_rng(SEED)
    return rng.normal(size=(BASE_ROWS, D)).astype(np.float32)


def scripted_ops():
    """(kind, ids) per op; every op changes the live state."""
    return [
        ("upsert", [100, 101]),
        ("delete", [0, 3]),
        ("upsert", [102]),
        ("upsert", [103, 104, 105]),
        ("delete", [100, 5]),
        ("upsert", [106]),
    ]


def main() -> int:
    durable_dir, site, nth, side = (sys.argv[1], sys.argv[2],
                                    int(sys.argv[3]), sys.argv[4])

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from raft_tpu_torch.resilience import faults

    real_fault_point = faults.fault_point
    calls = {"n": 0}

    def killing_fault_point(name):
        if name == site:
            calls["n"] += 1
            if calls["n"] == nth:
                os.kill(os.getpid(), signal.SIGKILL)
        return real_fault_point(name)

    # the durability modules bound the name at import: patch theirs too
    import raft_tpu_torch.mutable.checkpoint as ckpt_mod
    import raft_tpu_torch.mutable.wal as wal_mod

    faults.fault_point = killing_fault_point
    wal_mod.fault_point = killing_fault_point
    ckpt_mod.fault_point = killing_fault_point

    from raft_tpu_torch.mutable import MutableIndex, apply_delete, apply_upsert

    def log_line(path, obj):
        with open(path, "a") as f:
            f.write(json.dumps(obj) + "\n")
            f.flush()
            os.fsync(f.fileno())

    sub_path = os.path.join(side, "submitted.jsonl")
    ack_path = os.path.join(side, "acked.jsonl")

    # sync="always": the per-record fsync seam (wal_fsync) is on the path
    # of every mutation, not only the commit horizon
    idx = MutableIndex(base_matrix(), device="cpu", auto_compact=False,
                       compact_threshold=10_000, durable_dir=durable_dir,
                       wal_sync="always", **GEOM)
    for i, (kind, ids) in enumerate(scripted_ops()):
        log_line(sub_path, {"kind": kind, "ids": ids})
        if kind == "upsert":
            apply_upsert(idx, ids, np.stack([row_for(e) for e in ids]))
        else:
            apply_delete(idx, ids)
        log_line(ack_path, {"kind": kind, "ids": ids})
        if i == 2:
            idx.checkpoint()       # the mid-run checkpoint: site call 2
    idx.close()
    print("COMPLETED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
