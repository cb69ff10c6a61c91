#!/usr/bin/env python3
"""K1's stage ladder, K1's d-chunked slot form and K9 (the histogram) of
several checkouts of the port, run one after another within one card
call, to compare two commits.

    python3 port_scripts/ab_slot_k9.py TREE [TREE ...]

Each TREE (a directory holding ``chip_smoke.py`` and ``raft_tpu_torch``,
e.g. this checkout and a ``git archive`` of its parent under the
git-ignored ``build/``) runs in its own process, in the order given (run
parent, change, change, parent), with that tree's own code and kernels:

- the reference's K1 stage ladder (``chip_smoke.k1_ladder``'s rows) on
  the main path's operands (make_blobs 1,000,000 × 128, 64 clusters, std
  2.0; the first 2048 rows as queries): packed K1 at p1 (pair) and p3,
  the unpacked group form and the slot form at T = 2048 (p1, p3) and the
  slot form's min-only fold, each its wrapper between CUDA events (mean
  of 10 after one warm-up), and ``torch.matmul`` in bf16 of the product;
- K1's d-chunked slot form on wide_knn's operands (make_blobs 1,000,000 ×
  960, seed 13, the first 1000 rows as queries padded to the stream
  width) at p1 and p3, CUDA events, mean of 5;
- K9 at its four timed shapes (``chip_smoke.k9_inputs``: 100,000 × 8 and
  12.8 M × 1 values at 64 bins, 1,000,000 × 128 at 64 bins, the stats
  path's 100,000 labels at 16): its wrapper between CUDA events (``ms``)
  and the kernel alone under torch.profiler (``kernel_ms``, this
  checkout's ``chip_smoke.kernel_ms``), means of 20, each held bit for bit
  to ``torch.bincount`` first.

Prints the card's name and power limit, then one JSON line a run; each
run's output also goes to ``chiprun_out/ab_slot_k9_<i>.log``. Exits 1 if a
run failed.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def here():
    """This checkout's ``chip_smoke`` (the trees measured may predate
    what it offers)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import raft_tpu_torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.ops import histogram as k9
    from raft_tpu_torch.random import make_blobs

    h = here()
    t0 = time.perf_counter()
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk", "histogram"])
    out = {"tree": root, "build_s": time.perf_counter() - t0}
    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)

    # ---- the ladder at 2048 × 1M × 128 ----
    X, _ = make_blobs(res, 0, 1_000_000, 128, n_clusters=64, cluster_std=2.0)
    x = X[:2048].clone()
    idx1 = distance.prepare_knn_index(X, passes=1)
    idx3 = distance.prepare_knn_index(X, passes=3)
    del X
    xx = (x * x).sum(1)
    yy, M, m_real = idx1.yy_raw, idx1.y_hi.shape[0], idx1.n_rows
    y_hi, y_lo = idx3.y_hi, idx3.y_lo
    T = h.LADDER_T
    yyh_inf = torch.where(torch.arange(M, device="cuda") < m_real, 0.5 * yy,
                          float("inf"))
    pk = dict(g=idx1.g, pbits=idx1.pbits, xxh=0.5 * xx)
    rows = {
        "kernel_pck_p1": lambda: k1.fused_l2_group_topk_packed(
            x, y_hi, y_lo, idx1.yyh_k, T=idx1.T, passes=1, pair=True, **pk),
        "kernel_pck_p3": lambda: k1.fused_l2_group_topk_packed(
            x, y_hi, y_lo, idx1.yyh_k, T=idx1.T, passes=3, **pk)}
    for p in (1, 3):
        rows[f"kernel_grp_p{p}"] = (
            lambda p=p: k1.fused_l2_group_topk(x, y_hi, y_lo, yyh_inf, T=T,
                                               g=idx1.g, passes=p))
    for name, p, track in (("kernel_slot_p1", 1, True),
                           ("kernel_slot_p3", 3, True),
                           ("kernel_slot_minonly", 1, False)):
        rows[name] = (lambda p=p, track=track: k1.fused_l2_slot_topk(
            x, y_hi, y_lo, xx, yy, m_real, T=T, Qb=256, passes=p,
            track=track))
    ladder = {name: h.cuda_ms(fn, 10) for name, fn in rows.items()}
    xb = x.to(torch.bfloat16)
    ladder["matmul_bf16"] = h.cuda_ms(lambda: torch.matmul(xb, y_hi.T), 10)
    out["ladder"] = ladder
    out["split_p1_ms"] = {
        "contraction_and_min_fold": ladder["kernel_slot_minonly"],
        "argmin_and_2nd_min": ladder["kernel_slot_p1"]
        - ladder["kernel_slot_minonly"],
        "group_fold_vs_slot_p1": ladder["kernel_pck_p1"]
        - ladder["kernel_slot_p1"]}
    del idx1, idx3, x, xb, yy, y_hi, y_lo, yyh_inf, rows
    torch.cuda.empty_cache()

    # ---- the d-chunked slot form at wide_knn's shape ----
    n, d, nq, _ = h.WIDE_SHAPE
    W, _ = make_blobs(res, 13, n, d, n_clusters=64, cluster_std=2.0)
    Wq = W[:nq].clone()
    wide = {}
    for passes in (1, 3):
        index = distance.prepare_knn_index(W, passes=passes)
        xw = h.padded_queries(index, Wq)
        args = (xw, index.y_hi, index.y_lo, (xw * xw).sum(1), index.yy_raw,
                index.n_rows)
        kw = dict(T=index.T, Qb=256, passes=passes, dc=256)
        wide[f"p{passes}"] = h.cuda_ms(
            lambda: k1.fused_l2_slot_topk_dchunk(*args, **kw), 5)
        del index, xw, args
        torch.cuda.empty_cache()
    out["slot_dchunk"] = wide
    del W, Wq
    torch.cuda.empty_cache()

    # ---- K9 at its four timed shapes ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    Y = torch.randn(1_000_000, 128, device="cuda", generator=gen)
    n_s, d_s, k_s = h.STATS_SHAPE
    Xs, truth = make_blobs(res, 0, n_s, d_s, n_clusters=k_s)
    k9_rows = {}
    for tag, (bins, n_bins) in h.k9_inputs(gen, Y, Xs, truth, k_s).items():
        nb, batch = bins.shape
        flat = (torch.arange(batch, device="cuda")[None, :] * n_bins
                + bins).reshape(-1)
        want = torch.bincount(flat, minlength=batch * n_bins).reshape(
            batch, n_bins).T.to(torch.int32)
        h.check(torch.equal(k9.histogram_blocked(bins, n_bins), want),
                f"K9 {tag}: counts differ from torch.bincount")

        def run(bins=bins, n_bins=n_bins):
            return k9.histogram_blocked(bins, n_bins)
        k9_rows[tag] = {"shape": [nb, batch, n_bins],
                        "ms": h.cuda_ms(run, 20),
                        "kernel_ms": h.kernel_ms(run, "histogram", 20)}
    out["k9"] = k9_rows
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
                               f"ab_slot_k9_{i}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        if proc.returncode:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
