#!/usr/bin/env python3
"""A short check of the mutable index and its durability plane on one CUDA
card, before a full ``chip_smoke.py`` run: builds the kernels the mutable
path runs (K1/K2 ``fused_l2_packed_sm90.cu``, ``fused_l2_topk.cu``, K5
``pq_scan.cu``, K4 ``fine_scan.cu``), builds the IVF-Flat and 8-bit IVF-PQ
indexes on ``chip_smoke.ann_data`` at ``IVF_ROWS`` rows, then runs
``chip_smoke.mutable_phase`` (3a-3e at their full 1M-row size; 3c on the
indexes of this size) and prints its report.

    python3 port_scripts/first_mutable_check.py [IVF_ROWS IVF_LISTS]

(default 200000 256; about 110 s of command time, 37 s of it the build).
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
        print("first_mutable_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ann import build_ivf_flat, build_ivf_pq
    from raft_tpu_torch.ops import _build

    n_rows, n_lists = (int(a) for a in (sys.argv[1:3] or (200_000, 256)))
    card = cs.gpu_name_power()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk", "pq_scan",
                      "fine_scan"])
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    res = DeviceResources(device="cuda", seed=0)
    t0 = time.time()
    data = cs.ann_data(res, n_rows, 512)
    flat = build_ivf_flat(res, data["X"], n_lists, max_iter=8, seed=3)
    pq = build_ivf_pq(res, data["X"], n_lists, max_iter=8, seed=3,
                      pq_bits=8)
    torch.cuda.synchronize()
    print(f"ivf data + builds: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    report, launches = cs.mutable_phase(res, flat, pq, data)
    print(json.dumps({"mutable": report, "launches": launches,
                      "phase_s": time.time() - t0}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
