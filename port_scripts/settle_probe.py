#!/usr/bin/env python3
"""How long the card holds its clock down after a stretch at its power
limit, and what that does to a timed kernel.

    python3 port_scripts/settle_probe.py

On IVF-PQ's operands (``chip_smoke.ann_data``: make_blobs 1,000,000 ×
128, 2048 queries; an 8-bit index of 1024 lists) it drives the card at
its power limit for 3 s (bf16 8192² products), idles for ``s`` seconds,
then times K5 alone at P = 32 (``chip_smoke.kernel_ms``: mean of 5
launches under torch.profiler); and again for ``torch.matmul`` in bf16 of
1000 × 960 by 960 × 1,000,000 (``chip_smoke.cuda_ms``: CUDA events, mean
of 5). Three turns at each ``s`` in ``IDLE_S``, the timers' own settling
off, with the card's SM clock, temperature, power draw and throttle
reasons (``nvidia-smi``) after each ``s``. Then three IVF-PQ cells
(``chip_smoke.pq_cell``, 8-bit, P = 32) with the timers' settling on, as
``chip_smoke.py`` runs them. Prints the card's name and power limit, a
JSON line for each ``s`` and one JSON line at the end (~4 min of command
time).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

IDLE_S = (0.0, 0.03, 0.1, 0.2, 0.3, 1.0)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30).stdout.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("settle_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ann import build_ivf_pq
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import pq_scan as k5

    print(smi("name,power.limit"), flush=True)
    _build.build_all(["pq_scan", "fused_l2_topk", "fused_l2_packed_sm90",
                      "fine_scan"])
    res = DeviceResources(device="cuda", seed=0)
    data = cs.ann_data(res, 1_000_000, 2048)
    index = build_ivf_pq(res, data["X"], 1024, max_iter=8, seed=3, pq_bits=8)
    inp = cs.k5_inputs(res, index, data["Q"], 32)
    sq = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    xb = torch.randn(1000, 960, device="cuda", dtype=torch.bfloat16)
    yb = torch.randn(1_000_000, 960, device="cuda", dtype=torch.bfloat16)

    def hot(seconds: float = 3.0) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                sq @ sq
            torch.cuda.synchronize()

    settle_s, cs.SETTLE_S = cs.SETTLE_S, 0.0
    report = {"k5_kernel_ms": {}, "matmul_ms": {}, "smi": {}}
    for s in IDLE_S:
        k, m = [], []
        for _ in range(3):
            hot()
            time.sleep(s)
            k.append(cs.kernel_ms(lambda: k5.pq_scan_list_major(
                *inp["args"], pq_bits=8), "pq_scan_kernel"))
            hot()
            time.sleep(s)
            m.append(cs.cuda_ms(lambda: torch.matmul(xb, yb.T), 5))
        report["k5_kernel_ms"][s], report["matmul_ms"][s] = k, m
        report["smi"][s] = smi("clocks.sm,temperature.gpu,power.draw,"
                               "clocks_throttle_reasons.active")
        print(json.dumps({"idle_s": s, "k5_kernel_ms": k, "matmul_ms": m,
                          "smi": report["smi"][s]}), flush=True)
    del sq, xb, yb
    torch.cuda.empty_cache()
    cs.SETTLE_S = settle_s
    report["settle_s"] = settle_s
    report["pq_cell_kernel_ms"] = [
        cs.pq_cell(res, "pq8_p32", index, data["Q"], 32, data["X"],
                   data["o_ids"], data["floor"], plain=False)["k5"][
                       "kernel_ms"] for _ in range(3)]
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
