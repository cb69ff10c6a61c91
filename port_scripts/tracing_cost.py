#!/usr/bin/env python3
"""What the spans cost on the main path: ``distance.knn`` at
``bench.py:236``'s 2048 × 1M × 128 blobs (k = 64, passes 1 and 3), timed
by the host clock (the median of REPS calls, each ended by a
synchronize) in child processes that alternate tracing on (the defaults)
and off (``RAFT_TPU_DISABLE_TRACING=1``, read at import, hence a process
each), ROUNDS rounds of on, off. Prints one JSON line a child and the
medians of each mode.

    python3 port_scripts/tracing_cost.py [ROUNDS REPS]

(defaults 2 and 200; about 2 min of command time.)
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, statistics, sys, time
sys.path.insert(0, %(root)r)
import torch
from raft_tpu_torch import DeviceResources, distance
from raft_tpu_torch.observability import tracing_enabled
from raft_tpu_torch.random import make_blobs

reps = %(reps)d
res = DeviceResources(device="cuda", seed=0)
X, _ = make_blobs(res, 0, 1_000_000, 128, n_clusters=64, cluster_std=2.0)
Qx = X[:2048].clone()
out = {"tracing": tracing_enabled()}
for p in (1, 3):
    idx = distance.prepare_knn_index(X, passes=p)
    for _ in range(5):
        distance.knn(res, idx, Qx, k=64)
    torch.cuda.synchronize()
    t = []
    for _ in range(reps):
        t0 = time.perf_counter()
        distance.knn(res, idx, Qx, k=64)
        torch.cuda.synchronize()
        t.append(time.perf_counter() - t0)
    out[f"p{p}_ms"] = 1e3 * statistics.median(t)
    del idx
print(json.dumps(out), flush=True)
"""


def main() -> int:
    args = [int(a) for a in sys.argv[1:]]
    rounds, reps = (args + [2, 200][len(args):])
    code = CHILD % {"root": ROOT, "reps": reps}
    got = {"on": [], "off": []}
    for _ in range(rounds):
        for mode in ("on", "off"):
            env = dict(os.environ)
            env.pop("RAFT_TPU_DISABLE_TRACING", None)
            if mode == "off":
                env["RAFT_TPU_DISABLE_TRACING"] = "1"
            t0 = time.time()
            out = subprocess.run([sys.executable, "-c", code], env=env,
                                 capture_output=True, text=True,
                                 timeout=600)
            if out.returncode != 0:
                print(out.stderr[-4000:], file=sys.stderr)
                return 1
            row = json.loads(out.stdout.strip().splitlines()[-1])
            row["mode"], row["wall_s"] = mode, time.time() - t0
            print(json.dumps(row), flush=True)
            got[mode].append(row)
    summary = {m: {f"p{p}_ms": statistics.median(r[f"p{p}_ms"] for r in rows)
                   for p in (1, 3)} for m, rows in got.items()}
    print(json.dumps({"tracing_cost": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
