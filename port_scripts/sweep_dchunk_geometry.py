#!/usr/bin/env python3
"""The sweep that chose K1's d-chunked geometry
(``fused_l2_group_topk_packed_dchunk``,
``raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu``): the query block
resident or streamed × clusters of 1, 2 and 4 query blocks sharing y,
each with as many ring stages as fit, and at clusters of 2 with 4 and 6
stages too (the ring's depth). The shipped source picks the
geometry itself (``pick_wide_geo``); this script compiles a copy of it
(into ``build/sweep/``, one ``nvcc``) whose ``pick_wide_geo`` returns a
geometry set by one extra entry point, which then launches. It times
each geometry at wide_knn's shape (make_blobs 1M × 960, padded to 1024,
1000 queries, passes 1 and 3, on the path's own prepared operands; CUDA
events, mean of 10) beside the shipped launch, the bound, the L2 →
shared-memory bytes each geometry moves by ``chip_smoke.dchunk_l2_bytes``
(a model, not a measurement) and ``torch.matmul`` in bf16, and checks
every geometry's outputs bit for bit against the shipped kernel's. Prints
one JSON line; exits 1 if any geometry differs.

    python3 port_scripts/sweep_dchunk_geometry.py [ROWS QUERIES]
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: the copy's pick_wide_geo returns the geometry dchunk_geo_launch sets
PICK = """bool pick_wide_geo(int Q, int d, int passes, int limit, WideGeo* g,
                   bool slot = false) {"""
FORCED = """WideGeo g_sweep_geo{0, 0, 0, 0};
bool pick_wide_geo(int Q, int d, int passes, int limit, WideGeo* g,
                   bool slot = false) {
  if (g_sweep_geo.NS) {
    *g = g_sweep_geo;
    const uint32_t total = WideLayout(g->NS, d, passes, g->xres, slot).total;
    g->smem = smem_bytes(total, limit);
    return total + kSlack <= static_cast<uint32_t>(limit);
  }"""
EXTRA = r'''
extern "C" int dchunk_geo_launch(
    const void* x_hi, const void* x_lo, const void* y_hi, const void* y_lo,
    const void* yyh, const void* xxh, void* a1, void* a2, void* a3, int Q,
    int M, int d, int T, int g, int passes, int pair, int pbits, int xres,
    int NS, int ncta, void* stream) {
  const Args a = make_args(nullptr, nullptr, yyh, xxh, a1, a2, a3, Q, M, d,
                           T, g, pbits);
  g_sweep_geo = WideGeo{NS, ncta, xres, 0};
  const int rc = dispatch_wide(a, x_hi, x_lo, y_hi, y_lo, passes, pair,
                               stream);
  g_sweep_geo = WideGeo{0, 0, 0, 0};
  return rc;
}
'''
MAX_STAGES = 12


def build_sweep():
    from raft_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "fused_l2_packed_sm90.cu")).read()
    if src.count(PICK) != 1:
        print("sweep_dchunk_geometry: pick_wide_geo not found in the source",
              file=sys.stderr)
        raise SystemExit(1)
    src = src.replace(PICK, FORCED) + EXTRA
    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "fused_l2_dchunk_sweep.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, "fused_l2_dchunk_sweep.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr, file=sys.stderr)
        raise SystemExit(1)
    fn = ctypes.CDLL(so).dchunk_geo_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 11 + [p]
    fn.restype = ctypes.c_int
    return fn


def sweep(res, fn, n: int = 1_000_000, nq: int = 1000, d0: int = 960,
          reps: int = 10) -> dict:
    from raft_tpu_torch import distance
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.random import make_blobs

    X, _ = make_blobs(res, 13, n, d0, n_clusters=64, cluster_std=2.0)
    Qx = X[:nq].clone()
    stream = torch.cuda.current_stream().cuda_stream
    out, bad = {}, []
    for passes in (1, 3):
        index = distance.prepare_knn_index(X, passes=passes)
        x = cs.padded_queries(index, Qx)
        xxh = 0.5 * (x * x).sum(1)
        kw = dict(T=index.T, g=index.g, passes=passes, pair=False,
                  pbits=index.pbits, xxh=xxh)
        args = (x, index.y_hi, index.y_lo, index.yyh_k)
        M, d = index.y_hi.shape
        want = k1.fused_l2_group_topk_packed_dchunk(*args, **kw)
        x_hi, x_lo = k1._split_x(x, passes)
        outs = [torch.empty_like(a) for a in want]
        S = -(-(M // index.T) // index.g) * 128
        bound, by = cs.k1_bound_ms(nq, M, d, S, passes)
        rows = {}

        def launcher(xres, NS, ncta):
            return lambda: fn(
                x_hi.data_ptr(), x_lo.data_ptr(), index.y_hi.data_ptr(),
                index.y_lo.data_ptr(), index.yyh_k.data_ptr(),
                xxh.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                outs[2].data_ptr(), nq, M, d, index.T, index.g, passes, 0,
                index.pbits, int(xres), NS, ncta, stream)

        geos = []
        for xres in (True, False):
            for ncta in (1, 2, 4):
                # the most stages that fit (a launch that does not fit
                # returns an error and runs nothing)
                top = next((n for n in range(MAX_STAGES, 3, -1)
                            if launcher(xres, n, ncta)() == 0), 0)
                extra = {4, 6} if ncta == 2 else set()
                geos += [(xres, n, ncta) for n in
                         sorted({top} | extra, reverse=True) if 4 <= n <= top]
        for geo in geos:
            run = launcher(*geo)
            run()
            torch.cuda.synchronize()
            same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                       for a, b in zip(outs, want))
            if not same:
                bad.append((passes, geo))
            rows[str(list(geo))] = {
                "ms": cs.cuda_ms(run, reps), "same_bits": same,
                "l2_gb_modelled": cs.dchunk_l2_bytes(
                    nq, M, d, passes, index.T, index.g, geo) / 1e9}
            print(f"dchunk p{passes} geometry {geo}: "
                  f"{json.dumps(rows[str(list(geo))])}", flush=True)
        xb = x.to(torch.bfloat16)
        out[f"p{passes}"] = {
            "shape": [nq, M, d],
            "shipped": list(k1.dchunk_geometry(nq, d, passes)),
            "shipped_ms": cs.cuda_ms(
                lambda: k1.fused_l2_group_topk_packed_dchunk(*args, **kw),
                reps),
            "bound_ms": bound, "bound_by": by, "geometries": rows,
            "matmul_bf16_ms": cs.cuda_ms(lambda: torch.matmul(
                xb, index.y_hi.T), reps)}
        del index, want, outs, x, x_hi, x_lo
        torch.cuda.empty_cache()
    out["differ"] = bad
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_dchunk_geometry: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build

    n, nq = (int(a) for a in (sys.argv[1:3] or (1_000_000, 1000)))
    card = cs.gpu_name_power()
    print(card, flush=True)
    _build.build_all(["fused_l2_packed_sm90"])
    fn = build_sweep()
    res = DeviceResources(device="cuda", seed=0)
    table = sweep(res, fn, n, nq)
    print(json.dumps({"card": card, "dchunk_sweep": table}), flush=True)
    return 1 if table["differ"] else 0


if __name__ == "__main__":
    sys.exit(main())
