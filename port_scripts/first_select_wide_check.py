#!/usr/bin/env python3
"""A short first check of select_k (K3) and the wide and unpacked KNN on
one CUDA card, before a full ``chip_smoke.py`` run: builds
``fused_l2_topk.cu`` (K1, K2 and K1's d-chunked and unpacked forms) and
``select_slotted.cu`` (K3), prints their ``ptxas`` register and spill
reports, holds K1 and K2 against their twins with ±inf and NaN planted
(phase 2's second half), then runs ``chip_smoke.select_k_phase`` and
``chip_smoke.wide_knn_phase`` (phases 12 and 13) at a reduced size.

    python3 port_scripts/first_select_wide_check.py [ROWS D QUERIES]

(default 200000 960 256: the wide data's rows, width and queries; the
unpacked main cell runs at ROWS × 128 with 512 queries, select_k at
[64, 1,048,576] and [256, 1,048,576] with k = 64 and 256).
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
        print("first_select_wide_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build

    n, d, nq = (int(a) for a in (sys.argv[1:4] or (200_000, 960, 256)))
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_topk", "select_slotted"])
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    cs.nonfinite_k1_k2(gen)
    print(f"nonfinite_k1_k2: {time.time() - t0:.1f} s", flush=True)
    res = DeviceResources(device="cuda", seed=0)
    t0 = time.time()
    _, k3_entry = cs.select_k_phase(
        res, cells=((64, 1_048_576, 64), (256, 1_048_576, 256)),
        k3_shape=(64, 1_048_576))
    print(f"select_k_phase: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    _, entries = cs.wide_knn_phase(res, shape=(n, d, nq, 100),
                                      main=(n, 128, 512, 64))
    print(f"wide_knn_phase: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"kernels": [k3_entry, *entries]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
