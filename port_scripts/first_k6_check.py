#!/usr/bin/env python3
"""A short first check of K6c (SpMM) and K6b (pair SpMV) on one CUDA card,
before a full ``chip_smoke.py`` run: builds ``spmv.cu``, prints each
kernel's ``ptxas`` registers and spills, then holds K6c against its twin
at V = 16 and 128 on the layout of spectral_g22's normalized Laplacian
(an R-MAT graph at ``SCALE``), K6b on the band matrix of half-width 16,
and runs ``chip_smoke.k6_checks`` (V = 33 and 512, the split hub tile and
the unvisited tile, K6b's half-width-1 band and R-MAT pairs), each case
timed beside its twin and cuSPARSE.

    python3 port_scripts/first_k6_check.py [SCALE]

(default 22).
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
        print("first_k6_check: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.sparse import linalg as sl

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 22
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["spmv"])
    _build.load("spmv")
    print(f"build: {time.time() - t0:.1f} s {_build.BUILD_SECONDS}",
          flush=True)
    for name, log in _build.BUILD_LOG.items():
        cs.ptxas_report(name, log)
    res = DeviceResources(device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    t0 = time.time()
    adj = cs.rmat_adjacency(res, 3, scale)
    L, _ = sl.laplacian_normalized(res, adj)
    del adj
    T = sl.prepare_spmv(L)
    deg, Lt = cs.row_degrees(L), cs.csr_tensor(L)
    out = {"scale": scale, "items": T.n_items, "m_chunks": T.m_chunks,
           "split_items": int(T.item_split.sum().item()),
           "zero_tiles": T.zero_tiles.numel()}
    for V in (16, 128):
        B = torch.randn((L.shape[1], V), generator=gen, device="cuda")
        _, out[f"K6c_V{V}"] = cs.k6c_case(f"rmat{scale} V={V}", T, deg, B,
                                          5, Lt, res)
        del B
    del T, L, Lt, deg
    torch.cuda.empty_cache()
    n = 1 << 20
    x = torch.randn(n, generator=gen, device="cuda")
    _, out["K6b_band16"] = cs.k6b_case("band half-width 16",
                                       cs.band_matrix(n, 16, gen), x, 20)
    out["checks"] = cs.k6_checks(res, gen)
    print(f"first_k6_check: {time.time() - t0:.1f} s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
