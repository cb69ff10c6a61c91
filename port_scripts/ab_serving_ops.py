#!/usr/bin/env python3
"""Time the serving engine's closed loop (phase 10's brute_bf16 shape:
1M × 128 N(0, 1), k = 64, 2000 requests from 8 clients) in several
checkouts, one process a run, in the order given:

    python3 port_scripts/ab_serving_ops.py TREE[:MODE] [...]

Each TREE is the root of a checkout (``.`` for this one; unpack a parent
with ``git archive`` under the git-ignored ``build/``). Each run builds
its index, starts ``ServingEngine(idx, k=64)``, runs
``chip_smoke.closed_loop`` of that tree three times and prints one JSON
line: p50, p99, requests/s of each loop, batches. The suffix picks the
engine's planes, for a tree that has them: ``:off`` (registry and flight
recorder disabled), ``:shadow`` (``shadow_frac=0.05``), ``:explain``
(``explain_frac=0.02``), ``:forensics`` (a blackbox and
``watchdog_s=0.5``), ``:debugz`` (``debug_port=0``, not scraped) or
``:planes`` (all of them, phase 18's loop (c) without its scraper); no
suffix is the defaults. The trees' kernel sources must match this
checkout's (the built libraries are copied to each tree's
``build/kernels`` first, so no run compiles). First it times a child
process's CUDA start-up while this process holds a context
(``child_cuda_init_s``).
"""

import glob
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = r"""
import json, os, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from raft_tpu_torch.distance import prepare_knn_index
from raft_tpu_torch.serving import ServingEngine
m, d, k, n, clients = cs.SERVE_SHAPE
gen = torch.Generator(device="cuda"); gen.manual_seed(0)
Y = torch.randn(m, d, device="cuda", generator=gen)
rng = np.random.default_rng(0)
sizes = np.clip(rng.poisson(16, n), 1, 256)
blocks = rng.normal(size=(64, 256, d)).astype(np.float32)
def request(i):
    return blocks[i % 64, :int(sizes[i % n])]
planes = dict(shadow=dict(shadow_frac=0.05),
              explain=dict(explain_frac=0.02),
              forensics=dict(blackbox_path=os.path.join(
                  tempfile.mkdtemp(), "bb.bin"), watchdog_s=0.5),
              debugz=dict(debug_port=0))
planes["planes"] = {k_: v for p in planes.values() for k_, v in p.items()}
kw = planes.get(sys.argv[2], {})
if sys.argv[2] == "off":
    from raft_tpu_torch import observability as obs
    obs.disable()
    obs.disable_flight()
eng = ServingEngine(prepare_knn_index(Y), k=k, **kw).start()
try:
    rows = []
    for rep in range(3):
        lat, errors, wall, _ = cs.closed_loop(eng, request, n, clients,
                                              cs.SERVE_THINK_S, rep)
        ms = np.asarray(lat) * 1e3
        rows.append({"p50_ms": float(np.percentile(ms, 50)),
                     "p99_ms": float(np.percentile(ms, 99)),
                     "rps": n / wall, "errors": len(errors)})
    st = eng.stats()
finally:
    eng.stop()
print("RESULT " + json.dumps({"tree": sys.argv[1], "mode": sys.argv[2],
                              "runs": rows, "batches": st["batches"]}),
      flush=True)
"""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ab_serving_ops: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from raft_tpu_torch.ops import _build

    print(cs.gpu_name_power(), flush=True)
    args = sys.argv[1:]
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk"])
    torch.zeros(1, device="cuda")
    t0 = time.perf_counter()
    try:
        out = subprocess.run(
            [sys.executable, "-c", "import torch; torch.zeros(1, "
             "device='cuda'); torch.cuda.synchronize()"],
            capture_output=True, text=True, timeout=120)
        probe = {"rc": out.returncode, "stderr": out.stderr[-300:]}
    except subprocess.TimeoutExpired:
        probe = {"rc": None, "timeout_s": 120}
    print(json.dumps({"child_cuda_init_s": time.perf_counter() - t0,
                      **probe}), flush=True)
    if probe["rc"] != 0:
        return 1
    libs = glob.glob(os.path.join(_build.BUILD_DIR, "*.so"))
    for arg in args:
        tree, _, mode = arg.partition(":")
        mode = mode or "defaults"
        dest = os.path.join(os.path.abspath(tree), "build", "kernels")
        os.makedirs(dest, exist_ok=True)
        for lib in libs:
            if not os.path.exists(os.path.join(dest,
                                               os.path.basename(lib))):
                shutil.copy(lib, dest)
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-c", RUN, os.path.abspath(tree), mode],
            capture_output=True, text=True, timeout=900)
        line = [ln for ln in out.stdout.splitlines()
                if ln.startswith("RESULT ")]
        print(json.dumps({"tree": arg, "rc": out.returncode,
                          "wall_s": time.perf_counter() - t0,
                          "result": json.loads(line[0][7:]) if line
                          else None, "stderr": out.stderr[-600:]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
