#!/usr/bin/env python3
"""A short check of phase 18 of ``chip_smoke.py`` (the serving engine's
operations planes) on one CUDA card, before a full run: builds K1's
packed and unpacked sources, then runs ``serving_ops_phase`` at 200k rows
and 1000 requests, then at phase 10's full shape (1M × 128, 2000
requests, 8 clients), its checks fatal as in the whole script. Prints a
JSON line per shape with the phase's report and K1's launches by loop.

    python3 port_scripts/first_ops_check.py [--small | --full]

``--small`` runs the reduced shape only, ``--full`` the full one only.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("first_ops_check: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import raft_tpu_torch
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_l2_topk as k1

    print(cs.gpu_name_power(), flush=True)
    t0 = time.perf_counter()
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk"])
    k1._launcher()
    k1._launcher_group()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    shapes = [(200_000, 128, 64, 1000, 8), cs.SERVE_SHAPE]
    if "--small" in sys.argv[1:]:
        shapes = shapes[:1]
    elif "--full" in sys.argv[1:]:
        shapes = shapes[1:]
    for shape in shapes:
        cs.SERVE_SHAPE = shape
        t0 = time.perf_counter()
        report, launches = cs.serving_ops_phase(res)
        print(json.dumps({"shape": shape,
                          "wall_s": time.perf_counter() - t0,
                          "launches": launches, "serving_ops": report}),
              flush=True)
    print("OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
