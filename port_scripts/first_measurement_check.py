#!/usr/bin/env python3
"""A short check of phase 20 (the measurement plane: the Fixture, the
profiler and its roofline, spans, the drift ledger, a profiler trace,
memory tracking, the mutable plane's metrics and the fault sites of the
hot paths) on one CUDA card, before a full ``chip_smoke.py`` run: builds
the kernels the phase launches, builds IVF-Flat and IVF-PQ (8-bit)
indexes of IVF_ROWS rows and IVF_LISTS lists from phase 5's recipe,
takes the main path's K1/K2 bounds from ``chip_smoke.k1_bound_ms`` /
``k2_bound_ms`` as phase 3 does, and runs
``chip_smoke.measurement_phase``, each check fatal as in the whole
script.

    python3 port_scripts/first_measurement_check.py [IVF_ROWS IVF_LISTS]

(defaults 200,000 and 256; about 2.5 min of command time, ~45 s of it
the build).
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
        print("first_measurement_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources, distance
    from raft_tpu_torch.ann import build_ivf_flat, build_ivf_pq
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.random import make_blobs

    args = [int(a) for a in sys.argv[1:]]
    ivf_rows, ivf_lists = (args + [200_000, 256][len(args):])
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["fused_l2_packed_sm90", "fine_scan", "pq_scan",
                      "select_slotted", "unexpanded", "spmv", "lap_jv"])
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    res = DeviceResources(device="cuda", seed=0)
    X, _ = make_blobs(res, 0, cs.N_INDEX, cs.DIM, n_clusters=64,
                      cluster_std=2.0)
    bounds = {}
    for key, kw in (("p1", dict(passes=1)), ("p3", dict(passes=3)),
                    ("int8_p1", dict(passes=1, db_dtype="int8"))):
        ix = distance.prepare_knn_index(X, **kw)
        M = ix.prepared_rows
        if ix.db_dtype == "int8":
            bounds[key] = cs.k2_bound_ms(cs.N_QUERIES, M, ix.stream_width,
                                         M // (ix.g * ix.T) * 128, 1)[0]
        else:
            bounds[key] = cs.k1_bound_ms(
                cs.N_QUERIES, M, ix.stream_width,
                -(-(M // ix.T) // ix.g) * 128, ix.passes)[0]
        del ix
    del X
    torch.cuda.empty_cache()
    data = cs.ann_data(res, ivf_rows, cs.N_QUERIES)
    kept = {"ivf_flat": build_ivf_flat(res, data["X"], ivf_lists,
                                       max_iter=8, seed=3),
            "ivf_pq": build_ivf_pq(res, data["X"], ivf_lists, max_iter=8,
                                   seed=3, pq_bits=8)}
    t0 = time.time()
    report = cs.measurement_phase(res, kept, data, bounds)
    print(f"measurement_phase: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps({"measurement": report}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
