#!/usr/bin/env python3
"""A short first check of the pairwise and stats path on one CUDA card,
before a full ``chip_smoke.py`` run: builds ``unexpanded.cu`` (K8) and
``histogram.cu`` (K9), prints their ``ptxas`` register and spill
reports, then runs ``chip_smoke.pairwise_stats_phase`` (phase 11: K8
against its twin on all ten metrics, K8 timed, BASELINE config 1, K9
against its twin and ``torch.bincount``, the stats path) at a reduced
size.

    python3 port_scripts/first_pairwise_check.py [FULL_ROWS Y_ROWS STATS_ROWS]

(default 512 200000 20000).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("first_pairwise_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build

    n, m, n_stats = (int(a) for a in (sys.argv[1:4] or
                                      (512, 200_000, 20_000)))
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["unexpanded", "histogram"])
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    res = DeviceResources(device="cuda", seed=0)
    t0 = time.time()
    _, entries = cs.pairwise_stats_phase(
        res, full=(n, m, 128), check_rows=64, stats_shape=(n_stats, 128, 16),
        hist_rows=m, trust_n=2000)
    print(f"pairwise_stats_phase: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
