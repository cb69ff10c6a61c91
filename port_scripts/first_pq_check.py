#!/usr/bin/env python3
"""A short first check of the IVF-PQ path on one CUDA card, before a full
``chip_smoke.py`` run: builds ``pq_scan.cu`` (K5) and ``fused_l2_topk.cu``,
prints their ``ptxas`` register and spill reports, then runs
``chip_smoke.pq_phase`` (phase 6: K5 against its twin, the pq cells, the
served burst and the diffuse worst case) on ``chip_smoke.ann_data`` at a
reduced size.

    python3 port_scripts/first_pq_check.py [ROWS QUERIES LISTS]

(default 200000 512 256; about 90 s of command time at that size).
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
        print("first_pq_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build

    n_rows, nq, n_lists = (int(a) for a in (sys.argv[1:4] or
                                            (200_000, 512, 256)))
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["pq_scan", "fused_l2_topk"])
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    res = DeviceResources(device="cuda", seed=0)
    data = cs.ann_data(res, n_rows, nq)
    t0 = time.time()
    _, entries = cs.pq_phase(res, data, n_lists)
    print(f"pq_phase: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
