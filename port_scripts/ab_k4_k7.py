#!/usr/bin/env python3
"""K4 (the list-major IVF fine scan), the IVF-Flat walls and K7 (SDDMM) of
several checkouts of the port, run one after another within one card
call, to compare two commits.

    python3 port_scripts/ab_k4_k7.py TREE [TREE ...]

Each TREE (a directory holding ``chip_smoke.py`` and ``raft_tpu_torch``,
e.g. this checkout and a ``git archive`` of its parent under the
git-ignored ``build/``) runs in its own process, in the order given (run
parent, change, change, parent), with that tree's own code and kernels:

- IVF-Flat on ``chip_smoke.ann_data`` (1,000,000 × 128 blobs, 2048
  queries, 1024 lists, f32 and int8): K4 on each batch's own operands
  (``chip_smoke.k4_inputs``) at ivf_p32, ivf_p128 (f32) and ivf_q8_p64
  (int8): its wrapper between CUDA events (mean of 5) and the kernels
  alone under torch.profiler (this checkout's ``chip_smoke.kernel_ms``:
  ``fine_scan_kernel`` and ``merge_kernel``, means of 5 launches); then
  ``search_ivf_flat`` (k = 10, list-major; host median of 5 after one
  warm-up) at those three and at ivf_exact (P = 1024, the K1 plane);
- K7 at spectral_g22's structure (the symmetrized R-MAT adjacency at scale
  22, CSR) at d = 64: ``sparse.linalg.sddmm`` as the path runs it (CUDA
  events, mean of 5) with B column-major (a caller holding Bᵀ) and
  row-major, the kernel alone (``sddmm_kernel``), the kernel's wrapper
  on index arrays made beforehand (``ops.sddmm.sddmm_csr`` where the tree
  has it, else ``sddmm_entries`` over rows expanded once, as an older
  ``chip_smoke`` timed it) with B column-major and row-major, and
  ``torch.sparse.sampled_addmm`` on the same operands;
- this checkout's ``chip_smoke.signed_select_checks`` (select_min=False
  on ±0/±NaN tied rows, card against CPU) run on the tree's own code:
  ``"passed"`` or the failure it printed.

Prints the card's name and power limit, then one JSON line a run; each
run's output also goes to ``chiprun_out/ab_k4_k7_<i>.log``. Exits 1 if a
run failed.
"""

import importlib.util
import io
import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import redirect_stderr

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def here():
    """This checkout's ``chip_smoke`` (the trees measured may predate
    what it offers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def host_median_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    t = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(t)


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    import raft_tpu_torch
    from raft_tpu_torch.ann import build_ivf_flat, search_ivf_flat
    from raft_tpu_torch.sparse import convert
    from raft_tpu_torch.sparse import linalg as sl

    h = here()
    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    out = {"tree": root}
    data = cs.ann_data(res, 1_000_000, 2048)
    Q = data["Q"]
    for dt, runs in (("f32", (("ivf_p32", 32), ("ivf_p128", 128),
                              ("ivf_exact", 1024))),
                     ("int8", (("ivf_q8_p64", 64),))):
        ix = build_ivf_flat(res, data["X"], 1024, max_iter=8, seed=3,
                            db_dtype=dt)
        for name, P in runs:
            if name != "ivf_exact":
                inp = cs.k4_inputs(res, ix, Q, P)

                def run():
                    return inp["kern"](*inp["args"])
                out[f"{name}_k4_ms"] = cs.cuda_ms(run, 5)
                scan = h.kernel_ms(run, "fine_scan_kernel")
                merge = h.kernel_ms(run, "merge_kernel")
                out[f"{name}_k4_scan_ms"] = scan
                out[f"{name}_k4_merge_ms"] = merge
                out[f"{name}_k4_kernel_ms"] = (
                    None if scan is None or merge is None else scan + merge)
                del inp
            out[f"{name}_ms"] = host_median_ms(
                lambda: search_ivf_flat(res, ix, Q, 10, n_probes=P,
                                        fine_scan="list"))
        del ix
        torch.cuda.empty_cache()
    del data, Q
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    S = convert.coo_to_csr(cs.rmat_adjacency(res, 3, 22))
    n, d = S.shape[0], 64
    A = torch.randn((n, d), generator=gen, device="cuda")
    Bc = torch.randn((n, d), generator=gen, device="cuda").T
    Br = Bc.contiguous()
    out["k7_nnz"] = S.nnz
    out["k7_path_ms"] = h.cuda_ms(lambda: sl.sddmm(res, A, Bc, S), 5)
    out["k7_kernel_ms"] = h.kernel_ms(lambda: sl.sddmm(res, A, Bc, S),
                                      "sddmm_kernel")
    out["k7_path_b_row_major_ms"] = h.cuda_ms(
        lambda: sl.sddmm(res, A, Br, S), 5)
    from raft_tpu_torch.ops import sddmm as k7
    # the kernel's wrapper on int32 indices made beforehand, as chip_smoke
    # times it: the CSR form where the tree has one (the guard holds it),
    # else the entry form over rows expanded once (an older chip_smoke's)
    ip, c = S.indptr.to(torch.int32), S.indices.to(torch.int32)
    if hasattr(k7, "sddmm_csr"):
        def wrap(B):
            return k7.sddmm_csr(A, B, ip, c)
    else:
        r = S.row_ids().to(torch.int32)

        def wrap(B):
            return k7.sddmm_entries(A, B, r, c)
    out["k7_wrapper_ms"] = h.cuda_ms(lambda: wrap(Bc), 5)
    out["k7_wrapper_b_row_major_ms"] = h.cuda_ms(lambda: wrap(Br), 5)
    del ip, c, wrap
    St = cs.csr_tensor(S)
    out["sampled_addmm_ms"] = h.library_ms(
        lambda: torch.sparse.sampled_addmm(St, A, Bc, beta=0.0), 5)
    del A, Bc, Br, S, St
    torch.cuda.empty_cache()

    err = io.StringIO()
    try:
        with redirect_stderr(err):
            h.signed_select_checks(res)
        out["signed_select"] = "passed"
    except SystemExit:
        out["signed_select"] = err.getvalue().strip()[-600:]
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(measure(sys.argv[2])), flush=True)
        return 0
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    print(cs.gpu_name_power(), flush=True)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    for i, tree in enumerate(sys.argv[1:]):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", tree], capture_output=True,
                              text=True, timeout=1500)
        with open(os.path.join(HERE, "chiprun_out",
                               f"ab_k4_k7_{i}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
