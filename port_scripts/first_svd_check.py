#!/usr/bin/env python3
"""A short check of phase 16 (the SVD family, BASELINE config 3 whole) and
of phase 2's ±inf end-to-end check on one CUDA card, before a full
``chip_smoke.py`` run: builds K1/K2 (``fused_l2_packed_sm90.cu``), then
runs ``chip_smoke.inf_row_knn`` and ``chip_smoke.svd_phase`` at full
size, each with its checks fatal as in the whole script.

    python3 port_scripts/first_svd_check.py

(about 2 min of command time, 40 s of it the build).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("first_svd_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build

    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_packed_sm90"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t0 = time.time()
    cs.inf_row_knn(gen)
    print(f"inf_row_knn: {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    cs.svd_phase(DeviceResources(device="cuda", seed=0))
    print(f"svd_phase: {time.time() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
