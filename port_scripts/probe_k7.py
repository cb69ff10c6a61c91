#!/usr/bin/env python3
"""What bounds K7 (SDDMM, ``ops/csrc/sddmm.cu``) on the card: times the
shipped kernel on inputs chosen to separate the effects, at spectral_g22's
structure (the symmetrized R-MAT adjacency at ``SCALE``, CSR order).

- ``base``: the structure as it is, d = 64.
- ``cols_l2``: every column id folded into the first ``FOLD`` columns
  (``FOLD · d · 4`` bytes of B rows, 16 MiB at d = 64, stay in the 50 MB
  L2): the same entries and row order, B gathers hit L2 instead of HBM.
- ``rows_l2``: the row ids folded likewise (A reads from L2).
- ``both_l2``: both folded: everything is read from L2, so what is left
  is L2 → SM traffic and issue.
- ``rows_repeated``: each row id repeated: entry i takes row i // 32 (a run
  of 32 entries a row, the mean degree), so A is one row a run and the
  entries' B rows are unchanged.
- ``d16`` / ``d256``: the base structure at d = 16 and 256.
- ``b_row_major``: the base case with B [d, n] in row-major order, the
  layout ``sparse.linalg.sddmm``'s callers usually hold (the wrapper then
  transposes it).

Every case runs the wrapper on B given column-major (``Bt.T`` of a
contiguous [n, d] Bt, so no copy is made) unless named otherwise, through
the entry form (rows, cols) and, where the module has one, the CSR form
(indptr, cols). Each time is the mean of CUDA events over 5 launches
after one, beside the modelled bytes of its B gathers
(nnz · d · 4) and its bound (chip_smoke.sddmm_bound_ms).

    python3 port_scripts/probe_k7.py [SCALE]

(default 22; ~1 min of command time, the build included).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

FOLD = 1 << 16


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_k7: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import sddmm as k7
    from raft_tpu_torch.sparse import convert

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 22
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    t0 = time.time()
    _build.build_all(["sddmm"])
    _build.load("sddmm")
    print(f"build: {time.time() - t0:.1f} s", flush=True)
    for name, log in _build.BUILD_LOG.items():
        cs.ptxas_report(name, log)
    res = DeviceResources(device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    S = convert.coo_to_csr(cs.rmat_adjacency(res, 3, scale))
    n = S.shape[0]
    indptr, cols = S.indptr.to(torch.int32), S.indices.to(torch.int32)
    rows = S.row_ids().to(torch.int32)
    nnz = int(cols.numel())
    has_csr = hasattr(k7, "sddmm_csr")
    out = {"scale": scale, "n": n, "nnz": nnz, "fold": FOLD,
           "csr_form": has_csr}
    print(json.dumps(out), flush=True)

    def operands(d):
        A = torch.randn((n, d), generator=gen, device="cuda")
        Bt = torch.randn((n, d), generator=gen, device="cuda")
        return A, Bt

    def case(tag, d, A, B, r, c, csr=True):
        row = {"d": d, "b_gather_gb": nnz * d * 4 / 1e9,
               "bound_ms": cs.sddmm_bound_ms(nnz, n, n, d)[0]}
        row["entries_ms"] = cs.cuda_ms(
            lambda: k7.sddmm_entries(A, B, r, c), 5)
        if has_csr and csr:
            row["csr_ms"] = cs.cuda_ms(
                lambda: k7.sddmm_csr(A, B, indptr, c), 5)
        out[tag] = row
        print(f"K7 probe {tag}: {json.dumps(row)}", flush=True)

    A, Bt = operands(64)
    B = Bt.T
    folded_c = (cols % FOLD).contiguous()
    folded_r = (rows % FOLD).contiguous()
    repeated = (torch.arange(nnz, device="cuda", dtype=torch.int32)
                // 32).contiguous()
    case("base", 64, A, B, rows, cols)
    case("cols_l2", 64, A, B, rows, folded_c)
    case("rows_l2", 64, A, B, folded_r, cols, csr=False)
    case("both_l2", 64, A, B, folded_r, folded_c, csr=False)
    case("rows_repeated", 64, A, B, repeated, cols, csr=False)
    Bc = B.contiguous()
    case("b_row_major", 64, A, Bc, rows, cols)
    del A, Bt, B, Bc, folded_c, folded_r, repeated
    torch.cuda.empty_cache()
    for d in (16, 256):
        A, Bt = operands(d)
        case(f"d{d}", d, A, Bt.T, rows, cols)
        del A, Bt
        torch.cuda.empty_cache()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "probe_k7.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"probe_k7": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
