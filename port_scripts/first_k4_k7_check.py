#!/usr/bin/env python3
"""A short first check of K4 (the list-major IVF fine scan, f32 and int8,
``ops/csrc/fine_scan.cu``) and K7 (SDDMM, ``ops/csrc/sddmm.cu``) on one
CUDA card, before a full ``chip_smoke.py`` run.

Builds both sources and ``select_slotted.cu``, prints every instance's
``ptxas`` registers and spills (fatal where one spills:
``chip_smoke.ptxas_fatal``), then:

- IVF-Flat on ``chip_smoke.ann_data`` (``ROWS`` × 128 blobs, 2048
  queries, ``LISTS`` lists, f32 and int8): K4 against its twin on 256
  queries at P = 32, with ±inf/NaN planted (``k4_nonfinite``) and on the
  work plan's edges (``k4_edge_case``); then on the whole batch at P = 32,
  128 (f32) and 64 (int8): held against the twin, timed (wrapper between
  CUDA events, the scan and merge kernels alone under torch.profiler),
  and ``search_ivf_flat``'s list-major ids against its query-major scan;
- K7: ``chip_smoke.k7_checks`` (empty rows, a row of 5000, d = 64, 3, 200,
  512), then spectral_g22's structure (R-MAT at ``SCALE``) at d = 64 in
  CSR form against its twin and timed;
- ``chip_smoke.signed_select_checks`` (phase 12e).

    python3 port_scripts/first_k4_k7_check.py [ROWS LISTS SCALE]

(defaults 1,000,000, 1024 and 22: ~2 min of command time).
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
        print("first_k4_k7_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ann import build_ivf_flat, search_ivf_flat
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import sddmm as k7
    from raft_tpu_torch.sparse import convert

    rows = int(sys.argv[1]) if len(sys.argv) > 1 else 1_000_000
    lists = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    scale = int(sys.argv[3]) if len(sys.argv) > 3 else 22
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["fine_scan", "sddmm", "select_slotted"])
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        cs.ptxas_report(name, log)
    print(json.dumps({"k4_k7_ptxas": cs.ptxas_fatal(_build.BUILD_LOG)}),
          flush=True)
    res = DeviceResources(device="cuda", seed=0)

    data = cs.ann_data(res, rows, 2048)
    Q = data["Q"]
    for dt, P in (("f32", (32, 128)), ("int8", (64,))):
        ix = build_ivf_flat(res, data["X"], lists, max_iter=8, seed=3,
                            db_dtype=dt)
        inp = cs.k4_inputs(res, ix, Q[:256], 32)
        out = inp["kern"](*inp["args"])
        ref = inp["twin"](*inp["args"])
        print(f"K4 {dt} 256 queries P=32: max_abs_err "
              f"{cs.compare_k4(out, ref, inp['x'], inp['ymax'], inp['q8'])}"
              f"; planted ±inf/NaN: {cs.k4_nonfinite(inp)}; edges: "
              f"{cs.k4_edge_case(ix, Q)}", flush=True)
        del out, ref
        for p in P:
            inp = cs.k4_inputs(res, ix, Q, p)
            run = (lambda: inp["kern"](*inp["args"]))
            out = run()
            ref = inp["twin"](*inp["args"])
            err = cs.compare_k4(out, ref, inp["x"], inp["ymax"], inp["q8"])
            del out, ref
            row = {"max_abs_err": err, "ms": cs.cuda_ms(run, 5),
                   "scan_ms": cs.kernel_ms(run, "fine_scan_kernel"),
                   "merge_ms": cs.kernel_ms(run, "merge_kernel"),
                   "bound_ms": cs.k4_bound_ms(2048, 128, p,
                                              inp["stream_rows"],
                                              inp["pair_rows"],
                                              inp["q8"])[0],
                   "lists": inp["lists"], "pair_rows": inp["pair_rows"]}
            _, ids, reruns = search_ivf_flat(res, ix, Q, 10, n_probes=p,
                                             fine_scan="list",
                                             with_stats=True)
            ref_v, ref_i = search_ivf_flat(res, ix, Q, 10, n_probes=p,
                                           fine_scan="query")
            row["reruns"] = reruns
            row["tie_queries"] = cs.check_exact(
                ids, ref_i, ref_v, data["X"], Q, f"ivf {dt} P={p}",
                data["floor"])
            print(f"K4 {dt} P={p}: {json.dumps(row)}", flush=True)
            del inp
        del ix
        torch.cuda.empty_cache()
    del data
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    cs.k7_checks(gen)
    S = convert.coo_to_csr(cs.rmat_adjacency(res, 3, scale))
    n, d = S.shape[0], 64
    A = torch.randn((n, d), generator=gen, device="cuda")
    B = torch.randn((n, d), generator=gen, device="cuda").T
    r, c, ip = S.row_ids(), S.indices, S.indptr
    twin = k7.sddmm_entries_ref(A, B, r, c)
    bound = (d + 2) * 2.0 ** -24 * k7.sddmm_entries_ref(A.abs(), B.abs(),
                                                        r, c)
    err = cs.check_bound("K7 CSR spectral_g22", k7.sddmm_csr(A, B, ip, c),
                         twin, bound)
    del twin, bound
    row = {"nnz": S.nnz, "max_abs_err": err,
           "csr_ms": cs.cuda_ms(lambda: k7.sddmm_csr(A, B, ip, c), 5),
           "entries_ms": cs.cuda_ms(lambda: k7.sddmm_entries(A, B, r, c), 5),
           "kernel_ms": cs.kernel_ms(lambda: k7.sddmm_csr(A, B, ip, c),
                                     "sddmm_kernel"),
           "bound_ms": cs.sddmm_bound_ms(S.nnz, n, n, d)[0],
           "gather_floor_ms": cs.k7_gather_floor_ms(S.nnz, d)}
    print(f"K7 spectral_g22 d=64: {json.dumps(row)}", flush=True)
    del A, B, S, r, c, ip
    torch.cuda.empty_cache()
    cs.signed_select_checks(res)
    print("first_k4_k7_check: ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
