#!/usr/bin/env python3
"""A short check of phase 17 of ``chip_smoke.py`` (the rest of ROADMAP
item 13: primitives, RNG, the LAP and its JV kernel, NearestNeighbors,
the pylibraft surface) on one CUDA card, before a full run: builds the
kernels the phase launches (K1's packed and unpacked sources, K3, K4, K5
and the JV tail), prints the JV kernel's ``ptxas`` report, then runs the
phase's parts, each with its checks fatal as in the whole script.

    python3 port_scripts/first_prims_check.py [PART ...]

PART is any of prims, rng, lap, nn, compat (default: all), in the given
order; ``lap:N,N`` sets the auction's sizes (e.g. ``lap:1024``).
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
        print("first_prims_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build

    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["lap_jv", "fused_l2_packed_sm90", "fused_l2_topk",
                      "select_slotted", "fine_scan", "pq_scan"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    cs.ptxas_report("lap_jv", _build.BUILD_LOG.get("lap_jv", ""))
    res = DeviceResources(device="cuda", seed=0)
    parts = sys.argv[1:] or ["prims", "rng", "lap", "nn", "compat"]
    for part in parts:
        name, _, arg = part.partition(":")
        t0 = time.time()
        if name == "prims":
            cs.prims_cells(res)
        elif name == "rng":
            cs.rng_checks(res)
        elif name == "lap":
            sizes = tuple(int(v) for v in arg.split(",")) if arg \
                else cs.LAP_SIZES
            _, entry = cs.lap_phase(res, sizes=sizes)
            print(json.dumps({"lap_jv_entry": entry}), flush=True)
        elif name == "nn":
            cs.nn_phase(res)
        elif name == "compat":
            cs.compat_checks(res)
        else:
            print(f"first_prims_check: unknown part {part!r}",
                  file=sys.stderr)
            return 2
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
