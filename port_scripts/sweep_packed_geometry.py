#!/usr/bin/env python3
"""The sweep that chose the packed Hopper kernel's geometry (K1 packed and
K2, ``raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu``): queries a block
(QB) and ring stages (NS), the k-slice being fixed at 64 features (one
128-byte swizzle row) and two of them of the next chunk in flight while a
chunk folds. The shipped source picks the geometry itself
(``pick_geo``); this script compiles a copy of it (into ``build/sweep/``,
one ``nvcc``) whose ``pick_geo`` returns a geometry set by one extra
entry point, which then launches; it times each geometry at the main
path's shape (2048 × 1M × 128 N(0, 1), T = 2048, g = 16; CUDA events,
mean of 10) for K1 p1 pair, K1 p3, K2 p1 pair and K2 p3, and checks
every geometry's outputs bit for bit against the shipped kernel's (the
fold and the k order do not depend on the geometry). Exits 1 if any
differs.

    python3 port_scripts/sweep_packed_geometry.py
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

#: the copy's pick_geo returns the geometry packed_geo_launch sets (the
#: shipped envelope check is skipped: the sweep runs at d = 128)
PICK = """bool pick_geo(int d, int passes, bool q8, int limit, Geo* g,
              bool slot = false) {"""
FORCED = """Geo g_sweep_geo{0, 0, 0};
bool pick_geo(int d, int passes, bool q8, int limit, Geo* g,
              bool slot = false) {
  if (g_sweep_geo.QB) {
    *g = g_sweep_geo;
    g->smem = smem_bytes(Layout(g->QB, g->NS, d, passes == 3 ? 2 : 1,
                                (passes == 3 && !q8) ? 2 : 1, q8,
                                slot).total, limit);
    return true;
  }"""
EXTRA = r'''
extern "C" int packed_geo_launch(
    const void* x, const void* y_hi, const void* y_lo, const void* scale,
    const void* yyh, const void* xxh, void* a1, void* a2, void* a3, int Q,
    int M, int d, int T, int g, int passes, int pair, int q8, int pbits,
    int QB, int NS, void* stream) {
  const Args a = make_args(x, scale, yyh, xxh, a1, a2, a3, Q, M, d, T, g,
                           pbits);
  g_sweep_geo = Geo{QB, NS, 0};
  const int rc = q8 ? dispatch<true>(a, y_hi, y_lo, passes, pair, stream)
                    : dispatch<false>(a, y_hi, y_lo, passes, pair, stream);
  g_sweep_geo = Geo{0, 0, 0};
  return rc;
}
'''
# (QB, NS): a consumer holds at most 3 stages (the held one and the two
# k-slices issued ahead), so NS >= 4 keeps the producer a stage ahead
GEOMETRIES = [(128, 4), (128, 6), (128, 8), (128, 12), (64, 6), (64, 12)]


def build_sweep():
    from raft_tpu_torch.ops import _build

    src = open(os.path.join(_build.CSRC, "fused_l2_packed_sm90.cu")).read()
    if src.count(PICK) != 1:
        print("sweep_packed_geometry: pick_geo not found in the source",
              file=sys.stderr)
        raise SystemExit(1)
    src = src.replace(PICK, FORCED) + EXTRA
    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "fused_l2_packed_sweep.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = os.path.join(out_dir, "fused_l2_packed_sweep.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                          capture_output=True, text=True)
    if proc.returncode:
        print(proc.stderr, file=sys.stderr)
        raise SystemExit(1)
    fn = ctypes.CDLL(so).packed_geo_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 9 + [i] * 11 + [p]
    fn.restype = ctypes.c_int
    return fn


def digest(outs):
    h = hashlib.sha256()
    for a in outs:
        h.update(a.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_packed_geometry: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch.distance.knn_fused import _prepare_ops_q8
    from raft_tpu_torch.ops import fused_l2_topk as k1

    card = cs.gpu_name_power()
    fn = build_sweep()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    Q, M, d, T, g, pbits = 2048, 1001472, 128, 2048, 16, 8
    M8 = 31 * g * T
    x = torch.randn(Q, d, device="cuda", generator=gen)
    y = torch.randn(M, d, device="cuda", generator=gen)
    y_hi, y_lo = k1.split_hi_lo(y)
    yyh = 0.5 * (y * y).sum(1)
    xxh = 0.5 * (x * x).sum(1)
    y8 = torch.randn(M8, d, device="cuda", generator=gen)
    _, y_q, scales, yyq, _, _ = _prepare_ops_q8(y8, T, g, "l2")
    del y, y8
    stream = torch.cuda.current_stream().cuda_stream
    forms = {"K1_p1": (1, True, False), "K1_p3": (3, False, False),
             "K2_p1": (1, True, True), "K2_p3": (3, False, True)}
    table, bad = {}, []
    for form, (passes, pair, q8) in forms.items():
        kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits, xxh=xxh)
        if q8:
            ship = k1.fused_l2_group_topk_packed_q8(x, y_q, yyq, scales, **kw)
            ops = (y_q, y_q, scales, yyq)
            Mf = M8
        else:
            ship = k1.fused_l2_group_topk_packed(x, y_hi, y_lo, yyh, **kw)
            ops = (y_hi, y_lo, scales, yyh)
            Mf = M
        want = digest(ship)
        outs = [torch.empty_like(a) for a in ship]
        row = {}
        for QB, NS in GEOMETRIES:
            def run():
                return fn(x.data_ptr(), ops[0].data_ptr(), ops[1].data_ptr(),
                          ops[2].data_ptr(), ops[3].data_ptr(),
                          xxh.data_ptr(), outs[0].data_ptr(),
                          outs[1].data_ptr(), outs[2].data_ptr(), Q, Mf, d,
                          T, g, passes, int(pair), int(q8), pbits, QB, NS,
                          stream)
            if run():                  # the ring does not fit beside x
                row[f"QB{QB}_NS{NS}"] = "does not fit"
                continue
            torch.cuda.synchronize()
            same = digest(outs) == want
            if not same:
                bad.append((form, QB, NS))
            row[f"QB{QB}_NS{NS}"] = {"ms": cs.cuda_ms(run, 10),
                                              "same_bits": same}
        row["shipped_ms"] = cs.cuda_ms(
            (lambda: k1.fused_l2_group_topk_packed_q8(x, y_q, yyq, scales,
                                                      **kw)) if q8 else
            (lambda: k1.fused_l2_group_topk_packed(x, y_hi, y_lo, yyh,
                                                   **kw)), 10)
        table[form] = row
        print(json.dumps({form: row}), flush=True)
    print(json.dumps({"card": card, "sweep": table, "differ": bad}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
