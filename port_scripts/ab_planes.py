#!/usr/bin/env python3
"""Time the serving engine with chosen operations planes, several engines
in one process over one index, each driven in turn for a segment of 500
closed-loop requests (``chip_smoke.serving_ops_loop``; the order reverses
every round), so that the host's drift falls on all of them alike:

    python3 port_scripts/ab_planes.py ROUNDS SPEC [SPEC ...]

Each SPEC names one engine: ``off`` (the defaults with the registry and
the flight recorder disabled during its segments), ``defaults``,
``shadow`` (``shadow_frac=0.05``), ``explain`` (``explain_frac=0.02``),
``forensics`` (a blackbox and ``watchdog_s=0.5``), ``debugz``
(``debug_port=0``, every route scraped during its segments) or
``planes`` (all of these, phase 18's loop (c)); ``@hi`` after a SPEC
dispatches that engine on a stream at the card's highest priority.
Prints one JSON line per engine: requests/s, p50, p99 and K1 launches
over its ROUNDS segments.
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_planes: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from raft_tpu_torch.core import DeviceResources
    from raft_tpu_torch.distance import prepare_knn_index
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.serving import ServingEngine

    print(cs.gpu_name_power(), flush=True)
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk"])
    rounds, specs = int(sys.argv[1]), sys.argv[2:]
    m, d, k, n, clients = cs.SERVE_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    idx = prepare_knn_index(torch.randn(m, d, device="cuda", generator=gen))
    rng = np.random.default_rng(0)
    sizes = np.clip(rng.poisson(16, n), 1, 256)
    blocks = rng.normal(size=(64, 256, d)).astype(np.float32)

    def request(i):
        return blocks[i % 64, :int(sizes[i % n])]

    tmp = tempfile.mkdtemp()
    options = dict(
        shadow=dict(shadow_frac=0.05), explain=dict(explain_frac=0.02),
        forensics=dict(blackbox_path=os.path.join(tmp, "bb.bin"),
                       watchdog_s=0.5),
        debugz=dict(debug_port=0))
    options["planes"] = {key: v for o in options.values()
                         for key, v in o.items()}
    engines = {}
    for spec in specs:
        plane, _, prio = spec.partition("@")
        res = DeviceResources(device="cuda")
        if prio == "hi":
            res.stream = torch.cuda.Stream(
                device=res.device,
                priority=torch.cuda.Stream.priority_range()[1])
        engines[spec] = ServingEngine(idx, k=k, res=res,
                                      **options.get(plane, {})).start()
    acc = {}
    try:
        first = engines[specs[0]]
        cs.serving_ops_loop("warm-up", first, request, 200, clients, 7,
                            off=specs[0].startswith("off"))
        for r in range(rounds):
            for spec in (specs if r % 2 == 0 else specs[::-1]):
                eng = engines[spec]
                acc[spec] = cs.serving_ops_loop(
                    spec, eng, request, 500, clients, r, acc.get(spec),
                    scrape=eng.debugz is not None,
                    off=spec.startswith("off"))
    finally:
        for eng in engines.values():
            eng.stop()
    for spec, rec in acc.items():
        lat = np.asarray(rec["lat"]) * 1e3
        print(json.dumps({"engine": spec, "rps": len(lat) / rec["wall"],
                          "p50_ms": float(np.percentile(lat, 50)),
                          "p99_ms": float(np.percentile(lat, 99)),
                          "K1": rec["launches"],
                          "priority": engines[spec].res.stream.priority}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
