#!/usr/bin/env python3
"""K7 (SDDMM) end to end from a CSR structure, by the form of its call:
is reading ``indptr`` in the kernel worth a second kernel form, against
expanding the rows on every call and running the entry form?

At spectral_g22's structure (the symmetrized R-MAT adjacency at
``SCALE``, CSR), d = 64, with B [d, n] column-major (a caller holding Bᵀ,
read in place) and row-major (transposed once a call), this times:

- ``path``: ``sparse.linalg.sddmm`` as a user calls it (whichever form the
  checkout runs on a CSR structure);
- ``expand_entries``: ``CSRMatrix.row_ids()`` then ``ops.sddmm.
  sddmm_entries``, the row expansion included in every call;
- ``csr``: ``ops.sddmm.sddmm_csr``, where the checkout has it;
- ``row_ids``: the row expansion alone.

Both forms get the int32 index arrays the path passes them. Each time is
the mean of CUDA events over 5 calls after one; the cases run in turn,
``ROUNDS`` times, so drift hits every case alike. Prints the card's name
and power limit, one line a round, and a JSON summary (the per-case
rounds); the summary also goes to ``chiprun_out/k7_forms.json``.

    python3 port_scripts/k7_forms.py [SCALE]

(default 22; ~1 min of command time, the build included).
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

ROUNDS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_forms: no CUDA device", file=sys.stderr)
        return 2
    from raft_tpu_torch import DeviceResources
    from raft_tpu_torch.ops import sddmm as k7
    from raft_tpu_torch.sparse import convert
    from raft_tpu_torch.sparse import linalg as sl

    scale = int(sys.argv[1]) if len(sys.argv) > 1 else 22
    print(cs.gpu_name_power(), torch.__version__, torch.version.cuda,
          flush=True)
    res = DeviceResources(device="cuda", seed=0)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    S = convert.coo_to_csr(cs.rmat_adjacency(res, 3, scale))
    n, d = S.shape[0], 64
    A = torch.randn((n, d), generator=gen, device="cuda")
    Bc = torch.randn((n, d), generator=gen, device="cuda").T
    Br = Bc.contiguous()

    def i32(t):
        return t.to(torch.int32).contiguous()

    cases = {}
    for tag, B in (("col_major", Bc), ("row_major", Br)):
        cases[f"path_{tag}"] = (lambda B=B: sl.sddmm(res, A, B, S))
        cases[f"expand_entries_{tag}"] = (
            lambda B=B: k7.sddmm_entries(A, B, i32(S.row_ids()),
                                         i32(S.indices)))
        if hasattr(k7, "sddmm_csr"):
            cases[f"csr_{tag}"] = (
                lambda B=B: k7.sddmm_csr(A, B, i32(S.indptr),
                                         i32(S.indices)))
    cases["row_ids"] = lambda: S.row_ids()
    out = {"scale": scale, "n": n, "nnz": S.nnz, "d": d,
           "has_csr_form": hasattr(k7, "sddmm_csr"),
           "ms": {k: [] for k in cases}}
    for r in range(ROUNDS):
        row = {}
        for k, fn in cases.items():
            row[k] = cs.cuda_ms(fn, 5)
            out["ms"][k].append(row[k])
        print(f"round {r}: {json.dumps(row)}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "k7_forms.json"), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"k7_forms": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
