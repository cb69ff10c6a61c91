#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device and build: the card's name and power limit, then every CUDA
   kernel of the port built from the sources in this checkout.
2. K1 against its plain PyTorch twin on the card, at Q=512 × M=131072 ×
   d=128 for passes {1, 3} × pair {False, True}.
3. The main path at full size, as ``bench.py`` configures it: make_blobs
   1,000,000 × 128 (64 clusters, std 2.0), the first 2048 rows as queries,
   k=64; ``prepare_knn_index`` at passes 1 and 3, then ``distance.knn`` at
   passes=1, passes=3 and passes=1 with ``certify="f32"``. The kernel's
   launch count is zeroed before each run and read after it. Results are
   held against an exact f32 oracle (chunked matmul + topk): ids identical
   at passes=3 and certify="f32", recall ≥ 0.99 at passes=1. K1 is held
   against its twin once more on the main path's own inputs, and timed
   beside its twin, its bound and the library product of the same shape.
   Each run is traced once more under torch.profiler, and its device time
   by kernel, busy time and idle share (profiler on) are printed.
4. K4 (the list-major IVF fine scan, f32 and int8) against its plain twin
   on the card, on one real schedule: the first 256 queries of the IVF
   phase's batch at P=32, on the f32 and then the int8 index.
5. IVF-Flat at full width, as ``benchmarks/bench_ann.py:81,177-197``
   configures it: make_blobs 1,000,000 × 128 (64 centers, per-center std
   linspace(0.5, 2.0), proportions uniform(0.5, 2.0) from numpy seed 11),
   2048 queries drawn from the rows plus N(0, 0.1) noise, k=10;
   ``build_ivf_flat`` with 1024 lists, max_iter=8, seed=3, f32 and int8.
   Runs, each with the kernels' counts zeroed just before and read just
   after: ivf_p32 and ivf_p128 (list-major, f32; ids identical as sets to
   the port's query-major scan up to proven ties; at most half the queries
   may fail the certificate), ivf_q8_p64 (list-major, int8; id sets
   identical to the f32 index at P=64) and ivf_exact (P=1024, the K1
   plane; ids identical to the exact oracle up to proven ties). Each run
   prints recall@10, reruns, the host-clock median of 5 calls, launches
   per batch, and K4 timed on the run's own inputs beside its twin and
   its bound.
6. spectral_g22, the spectral path at a size users run: an R-MAT graph
   with Graph500's initiator (A=0.57, B=C=0.19, D=0.05), edge factor 16,
   at scale 22 (4,194,304 vertices, 67,108,864 edges, symmetrized with
   values 1.0 as ``benchmarks/bench_configs.py:114-117`` does), then
   ``SpectralEmbedding(n_components=4, max_iterations=400,
   tolerance=1e-5, seed=42, tiled=True).fit_transform`` with the counts
   zeroed just before and read just after (K6a once per matvec). The
   Laplacian, layout and Lanczos solve are then timed one by one (solve:
   host-clock median of 3 after a warm-up, one torch.profiler trace).
   Checks: each returned pair's f64 relative residual ‖L·v − λ·v‖/‖L‖₂ ≤
   1e-4 (the plain CSR SpMV; ‖L‖₂ by power iteration), ‖VᵀV − I‖ ≤ 1e-4,
   and the eigenvalues within 1e-5 of the same solve run through K6a's
   twin. K6a and K6c (``linalg.spmm`` at V = 16 and 128) are held against
   their twins on that layout, with the bound (nnz_i + 2)·2⁻²⁴·Σ|a||x|
   per row, and timed beside the twin, the bound and cuSPARSE's call
   (``torch.sparse_csr_tensor @``). K7 (``linalg.sddmm``, d = 64) runs on
   the scale-22 adjacency's CSR structure in entry order, is held to
   (d + 2)·2⁻²⁴·Σ|a·b| and timed beside ``torch.sparse.sampled_addmm``,
   and is timed again over the same entries in the (row tile × column
   tile) order of a TiledPairs layout (16384 × 16384 and 256 × 512). K6b
   runs a Lanczos solve over the pair layout of a band matrix (n = 2²⁰,
   |i − j| ≤ 16, 34.6 M nonzeros) and is held and timed the same way.
7. spectral_c4, BASELINE config 4 as ``bench_configs.py:105-129`` runs it
   (scale 17, 1,000,000 edges, ``jit_loop=True``): the fit timed on the
   CSR path and on the tiled path (host-clock median of 3).
8. lanczos_dense, config 3's Lanczos (``bench_configs.py:92-103``): the
   256 × 256 Gram operator of make_blobs 100,000 × 1,000 (16 clusters), 8
   components, ncv=32, tolerance 1e-6, 300 iterations; residuals ≤ 1e-3.
9. A JSON ``kernels`` line, ``main_path``, ``ivf`` and ``spectral`` lines,
   the card's name and power limit, and the result line
   ``{"ok": true, "device": {...}}``.

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak (SXM)
H100_BYTES_PER_S = 3.35e12      # HBM3
H100_F32_FLOPS = 67e12          # f32 off the tensor cores (SXM)

N_INDEX, DIM, N_QUERIES, K = 1_000_000, 128, 2048, 64
# the IVF phase: bench_ann.py's TPU shape and build
IVF_CENTERS, IVF_K, IVF_LISTS = 64, 10, 1024


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def unpack(a, pbits: int):
    """(codes, values with the code bits cleared) of a packed array."""
    import torch

    bits = a.view(torch.int32)
    mask = (1 << pbits) - 1
    return bits & mask, (bits & ~mask).view(torch.float32)


def compare_k1(kern, twin, x, y_hi, pbits: int, pair: bool):
    """Hold K1's outputs against its twin's. Both sum the same exact bf16
    products in f32, in other orders, so a value (code bits cleared) may
    differ by the f32 accumulation error, at most d·2⁻²⁴·‖x‖·max‖y‖
    (doubled: the tensor cores' accumulation need not round to nearest),
    plus two units of the packing truncation, 2·2^(pbits−23)·|v|, that a
    last-bit difference can cross. Codes of a1/a2 must agree on ≥ 99.9%
    of slots (a near-tie may flip one); a3's code is meaningless under
    ``pair``. Returns the max abs error."""
    import torch

    d = x.shape[1]
    ymax = y_hi.float().norm(dim=1).max()
    acc = (2.0 * d * 2.0 ** -24 * x.norm(dim=1) * ymax)[:, None]
    err = 0.0
    for n, (a, b) in enumerate(zip(kern, twin)):
        ca, va = unpack(a, pbits)
        cb, vb = unpack(b, pbits)
        if n < 2 or not pair:
            same = (ca == cb).float().mean().item()
            check(same >= 0.999, f"K1 codes of output {n} agree on only "
                  f"{same:.5f} of slots")
        diff = (va - vb).abs()
        tol = 2.0 * 2.0 ** (pbits - 23) * vb.abs() + acc
        check(bool((diff <= tol).all()),
              f"K1 values of output {n} differ by up to "
              f"{diff.max().item()}")
        err = max(err, diff.max().item())
    torch.cuda.synchronize()
    return err


def k1_bound_ms(Q: int, M: int, d: int, S: int, passes: int):
    """Least time for K1's work: bf16 products at the tensor-core peak, or
    each input read and each output written once at the HBM rate."""
    ops = 2.0 * Q * M * d * (3 if passes == 3 else 1)
    nbytes = (Q * d * 4 + M * d * 2 * (2 if passes == 3 else 1) + M * 4
              + Q * 4 + 3 * Q * S * 4)
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def unported_bounds_ms(Q: int, M: int, d: int, S: int, T: int):
    """Bounds, at the main path's shape, of the TPU kernels on this path's
    family that the port has not written yet (same rules as k1_bound_ms):
    K1's unpacked form (ids as two extra i32 outputs), its slot form (per
    tile and lane min, argmin, and a [Q, 128] 2nd-min), K2 (K1 over an
    int8 slab, still bf16 products) and K3 (the packed fold of the [Q, S]
    pool without a product)."""
    def bound(ops, nbytes):
        return 1e3 * max(ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S)

    ops = 2.0 * Q * M * d
    x_in, yy_in = Q * d * 4 + Q * 4, M * 4
    s_slot = M // T * 128
    return {
        "K1 fused_l2_group_topk p1 (unpacked)":
            bound(ops, x_in + M * d * 2 + yy_in + 5 * Q * S * 4),
        "K1 fused_l2_slot_topk p1":
            bound(ops, x_in + M * d * 2 + yy_in + 2 * Q * s_slot * 4
                  + Q * 128 * 4),
        "K2 fused_l2_group_topk_packed_db_q8 p1":
            bound(ops, x_in + M * d + yy_in + 3 * Q * S * 4),
        "K3 select_slot_topk_packed on the [Q, S] pool":
            bound(0.0, Q * S * 4 + 3 * Q * 128 * -(-S // 32768) * 4),
    }


def k4_bound_ms(nq: int, d: int, P: int, stream_rows: int, pair_rows: int,
                q8: bool):
    """Least time for K4's work on one batch: each probed list read once
    (its padded rows at 4 or 1 bytes a feature), the queries, their norms
    and probe table read once and the five [nq, 128] pools written once;
    or ``passes × 2 × d`` operations per scored (query, row) pair at the
    bf16 tensor-core peak (passes 3 for f32: hi·hi, hi·lo, lo·hi; 2 for
    int8: x hi and x lo against exact codes)."""
    nbytes = (stream_rows * d * (1 if q8 else 4) + nq * d * 4 + nq * 4
              + nq * P * 4 + 5 * nq * 128 * 4)
    ops = (2 if q8 else 3) * 2.0 * d * pair_rows
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def ivf_unported_bounds_ms(nq: int, d: int, stream_rows: int,
                           pair_rows: int):
    """Bounds of the unported K5, K8 and K9 at the shapes the JAX
    package's benchmarks fix (bytes at the HBM rate, operations at the f32
    rate off the tensor cores, the larger of the two). K5: bench_ann.py's
    1M × 128, L=1024, pq_dim = d/4 = 32 codes of 8 bits, on ivf_p32's own
    schedule (codes + the 4-byte norm and Eq sidecars per streamed row, the
    [nq, 32, 256] f32 table, the pools; one add per (pair, sub-space)).
    K8: BASELINE config 1, L1 over 5,000 × 50 (sub, abs, add per term).
    K9: bench_prims.py:44-46's X, a [100,000 × 128] int32 bin matrix,
    column-batched as ``stats.histogram`` takes it, 64 bins: the bins read
    once and the [64, 128] int32 counts written once (one add per bin
    value)."""
    def bound(ops, nbytes):
        return 1e3 * max(ops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S)

    m8, d8 = 5000, 50
    r9, c9, b9 = 100_000, 128, 64
    return {
        "K5 pq_scan_list_major (1M x 128, L=1024, pq_dim 32, 8-bit, P=32)":
            bound(32.0 * pair_rows, stream_rows * (32 + 8) + nq * d * 4
                  + nq * 32 * 256 * 4 + 5 * nq * 128 * 4),
        "K8 unexpanded_pairwise_tiled L1 (5000 x 50)":
            bound(3.0 * m8 * m8 * d8, 2 * m8 * d8 * 4 + m8 * m8 * 4),
        "K9 histogram_blocked (100000 x 128 int32, 64 bins)":
            bound(float(r9 * c9), r9 * c9 * 4 + b9 * c9 * 4),
    }


def compare_k4(kern, twin, x, ymax: float, q8: bool):
    """Hold K4's pools against its twin's. Both sum in f32 in other
    orders (the kernel an fma chain over d, the twin torch.matmul with
    TF32 off), so a value may differ by (4d + 8)·2⁻²⁴·(‖x‖ + max‖y‖)² per
    query; +inf must match +inf. i1/i2 (global slab rows) must agree on
    ≥ 99.9% of slots: a near-tie may flip. Returns the max abs error."""
    import torch

    d = x.shape[1]
    tol = ((4 * d + 8) * 2.0 ** -24 * (x.norm(dim=1) + ymax) ** 2)[:, None]
    err = 0.0
    tag = "K4_q8" if q8 else "K4"
    for n in (0, 2, 4):
        a, b = kern[n], twin[n]
        fin = torch.isfinite(b)
        check(bool((torch.isfinite(a) == fin).all()),
              f"{tag} output {n}: +inf slots differ from the twin's")
        diff = torch.where(fin, (a - b).abs(), 0.0)
        check(bool((diff <= tol).all()),
              f"{tag} values of output {n} differ by up to "
              f"{diff.max().item()}")
        err = max(err, diff.max().item())
    for n in (1, 3):
        same = (kern[n] == twin[n]).float().mean().item()
        check(same >= 0.999, f"{tag} ids of output {n} agree on only "
              f"{same:.5f} of slots")
    return err


def exact_oracle(X, Qx, k: int, chunk: int = 131072):
    """Exact f32 top-k (TF32 off): chunked matmul + topk, merged."""
    import torch

    xx = (Qx * Qx).sum(1)
    best_v = best_i = None
    for s in range(0, X.shape[0], chunk):
        y = X[s:s + chunk]
        d2 = (xx[:, None] + (y * y).sum(1)[None, :] - 2.0 * (Qx @ y.T)
              ).clamp_min(0.0)
        v, i = torch.topk(d2, k, dim=1, largest=False)
        i = i + s
        if best_v is not None:
            v, i = torch.cat([best_v, v], 1), torch.cat([best_i, i], 1)
            v, pos = torch.topk(v, k, dim=1, largest=False)
            i = torch.gather(i, 1, pos)
        best_v, best_i = v, i
    return best_v, best_i


def check_exact(ids, o_ids, o_vals, X, Qx, label: str, floor=None):
    """Ids identical to the oracle's as sets per query; a mismatch must be
    a tie at the k-th distance, proven by the oracle's own values. ``floor``
    ([Q], optional) widens the tie by the rounding of the expanded f32
    score both sides rank by, where the norms dwarf the distances."""
    import torch

    a = torch.sort(ids.long(), 1).values
    b = torch.sort(o_ids.long(), 1).values
    bad = (a != b).any(1).nonzero().squeeze(1)
    for q in bad.tolist():
        extra = sorted(set(a[q].tolist()) - set(b[q].tolist()))
        y = X[extra]
        d2 = ((Qx[q][None] - y) ** 2).sum(1)
        theta = o_vals[q, -1] + (0.0 if floor is None else floor[q])
        check(bool((d2 <= theta * (1 + 1e-5) + 1e-5).all()),
              f"{label}: query {q} returned ids {extra} that are not "
              f"within a tie of the oracle's k-th distance (their d2 "
              f"{d2.tolist()}, the bound {theta.item()})")
    return int(bad.numel())


def k4_inputs(res, index, Qx, P: int):
    """K4's operands for one batch at ``P`` probes, built as
    ``search_ivf_flat``'s list-major path builds them, with the batch's
    probed rows (each probed list once) and scored (query, row) pairs."""
    import torch
    from raft_tpu_torch.ann import ivf_flat as ivf
    from raft_tpu_torch.ops import fine_scan as k4

    probes = ivf._coarse_probe(res, index.centroids, Qx, P)
    sch = ivf.build_list_schedule(index, probes.cpu().numpy())
    sched = torch.from_numpy(sch.sched).cuda()
    xp, pp, _ = ivf._pad_kernel_operands(Qx, probes)
    xx = (xp * xp).sum(1)
    Wk = k4.pad_window(index.probe_window)
    q8 = index.db_dtype == "int8"
    if q8:
        args = (sched, torch.from_numpy(sch.scale_l).cuda(), xp, xx, pp,
                index.slab_q, Wk)
        kern, twin = k4.fine_scan_list_major_q8, k4.fine_scan_list_major_q8_ref
        yy = index.yy_q
    else:
        args = (sched, xp, xx, pp, index.slab, Wk)
        kern, twin = k4.fine_scan_list_major, k4.fine_scan_list_major_ref
        yy = index.yy_slab
    return {"args": args, "kern": kern, "twin": twin, "x": xp, "q8": q8,
            "ymax": float(yy.max().sqrt()), "stream_rows": sch.stream_rows,
            "lists": sch.n_lists_probed,
            "pair_rows": int(index.sizes[probes.long()].sum())}


def k4_counts():
    from raft_tpu_torch.ops import fine_scan as k4
    from raft_tpu_torch.ops import fused_l2_topk as k1

    return {"K1": k1.LAUNCHES, "K4": k4.LAUNCHES, "K4_q8": k4.LAUNCHES_Q8}


def set_counts(c):
    from raft_tpu_torch.ops import fine_scan as k4
    from raft_tpu_torch.ops import fused_l2_topk as k1

    k1.LAUNCHES, k4.LAUNCHES, k4.LAUNCHES_Q8 = c["K1"], c["K4"], c["K4_q8"]


def ivf_phase(res, n_rows: int, n_queries: int, n_lists: int,
              probes=(32, 128, 64)):
    """Phases 4 and 5 (see the module doc) at ``n_rows`` × 128 with
    ``n_lists`` lists; ``probes`` are the P of ivf_p32, ivf_p128 and
    ivf_q8_p64. Returns (the ``ivf`` report, K4's two ``kernels`` entries,
    ivf_p32's streamed rows and scored pairs)."""
    import numpy as np
    import torch
    from raft_tpu_torch.ann import build_ivf_flat, search_ivf_flat
    from raft_tpu_torch.random import make_blobs

    rng = np.random.default_rng(11)
    X, _ = make_blobs(
        res, 11, n_rows, DIM, n_clusters=IVF_CENTERS,
        cluster_std=np.linspace(0.5, 2.0, IVF_CENTERS).astype(np.float32),
        proportions=rng.uniform(0.5, 2.0, IVF_CENTERS))
    noise = rng.normal(0, 0.1, (n_queries, DIM)).astype(np.float32)
    Q = X[torch.from_numpy(rng.choice(n_rows, n_queries, replace=False))
          .cuda()] + torch.from_numpy(noise).cuda()
    o_vals, o_ids = exact_oracle(X, Q, IVF_K)
    # ids ranked by xx + yy − 2·x·y in f32 on both sides may swap where
    # two true distances lie within that form's rounding: 16·2⁻²⁴ of the
    # norms (here ‖x‖² ≈ 4·10³ against k-th distances of ≈ 10²)
    floor = 16 * 2.0 ** -24 * ((Q * Q).sum(1) + (X * X).sum(1).max())
    report = {"build": {}}
    index = {}
    for dt in ("f32", "int8"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index[dt] = build_ivf_flat(res, X, n_lists, max_iter=8, seed=3,
                                   db_dtype=dt)
        torch.cuda.synchronize()
        ix = index[dt]
        report["build"][dt] = {
            "seconds": time.perf_counter() - t0, "kmeans_iters":
            ix.kmeans_iters, "size_min": int(ix.sizes.min()),
            "size_max": int(ix.sizes.max()),
            "probe_window": ix.probe_window, "slab_rows": ix.slab_rows}
        print(f"ivf build {dt}: {json.dumps(report['build'][dt])}",
              flush=True)
    f32, q8 = index["f32"], index["int8"]
    check(torch.equal(f32.offsets, q8.offsets)
          and torch.equal(f32.ids, q8.ids),
          "the f32 and int8 builds from one seed laid out different lists")
    L = f32.n_lists

    # ---- phase 4: K4 against its twin on one real schedule ----
    for ix in (f32, q8):
        inp = k4_inputs(res, ix, Q[:256], probes[0])
        saved = k4_counts()
        out = inp["kern"](*inp["args"])
        torch.cuda.synchronize()
        check(k4_counts() != saved, "a K4 launch was not counted")
        set_counts(saved)
        ref = inp["twin"](*inp["args"])
        err = compare_k4(out, ref, inp["x"], inp["ymax"], inp["q8"])
        print(f"K4 vs twin ({ix.db_dtype}, 256 queries, P={probes[0]}, "
              f"{inp['lists']} lists): max_abs_err={err}", flush=True)
        del out, ref

    # ---- phase 5: the IVF path at full width ----
    runs = [("ivf_p32", f32, probes[0]), ("ivf_p128", f32, probes[1]),
            ("ivf_q8_p64", q8, probes[2]), ("ivf_exact", f32, L)]
    entries, k4_rows = {}, {}
    for name, ix, P in runs:
        set_counts({"K1": 0, "K4": 0, "K4_q8": 0})
        vals, ids, reruns = search_ivf_flat(res, ix, Q, IVF_K, n_probes=P,
                                            fine_scan="list",
                                            with_stats=True)
        torch.cuda.synchronize()
        launches = k4_counts()
        check(tuple(ids.shape) == (n_queries, IVF_K)
              and bool(torch.isfinite(vals).all()),
              f"{name}: results are not finite [nq, k]")
        recall = (ids.long()[:, :, None] == o_ids[:, None, :]).any(2) \
            .float().mean().item()
        if name == "ivf_exact":
            check(launches["K1"] > 0, f"{name}: K1 launched no time")
            n_tie = check_exact(ids, o_ids, o_vals, X, Q, name, floor)
        else:
            kname = "K4_q8" if ix.db_dtype == "int8" else "K4"
            check(launches[kname] > 0, f"{name}: {kname} launched no time")
            if ix.db_dtype == "int8":
                # the int8 contract: the f32 index's id sets at this P
                ref_v, ref_i = search_ivf_flat(res, f32, Q, IVF_K,
                                               n_probes=P, fine_scan="list")
            else:
                check(reruns <= n_queries // 2,
                      f"{name}: {reruns} of {n_queries} queries failed the "
                      f"certificate; K4 decides nothing")
                ref_v, ref_i = search_ivf_flat(res, ix, Q, IVF_K,
                                               n_probes=P,
                                               fine_scan="query")
            n_tie = check_exact(ids, ref_i, ref_v, X, Q, name, floor)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            search_ivf_flat(res, ix, Q, IVF_K, n_probes=P, fine_scan="list")
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        row = {"P": P, "recall": recall, "reruns": reruns,
               "tie_queries": n_tie, "ms": 1e3 * statistics.median(times),
               "launches": launches}
        if name != "ivf_exact":
            inp = k4_inputs(res, ix, Q, P)
            saved = k4_counts()
            out = inp["kern"](*inp["args"])
            hold = []
            plain_ms = cuda_ms(lambda: hold.append(inp["twin"](
                *inp["args"])), 1, warmup=0)
            err = compare_k4(out, hold[0], inp["x"], inp["ymax"], inp["q8"])
            del out, hold
            ms = cuda_ms(lambda: inp["kern"](*inp["args"]), 5)
            set_counts(saved)           # comparison launches do not count
            bound, bound_by = k4_bound_ms(n_queries, DIM, P,
                                          inp["stream_rows"],
                                          inp["pair_rows"], inp["q8"])
            k4_rows[name] = {
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": None,
                "max_abs_err": err, "lists": inp["lists"],
                "stream_rows": inp["stream_rows"],
                "pair_rows": inp["pair_rows"]}
            row["k4"] = k4_rows[name]
            if name == "ivf_p32":
                p32_work = (inp["stream_rows"], inp["pair_rows"])
                # K4 under the reference's list-major chunk, the query-major
                # gather's max(8, 2^26 // (P·W·d)) queries: each chunk
                # streams the union of its own probed lists
                qc = max(8, (1 << 26) // (P * ix.probe_window * DIM))
                parts = [k4_inputs(res, ix, Q[s:s + qc], P)
                         for s in range(0, n_queries, qc)]
                saved = k4_counts()
                chunk_ms = cuda_ms(lambda: [c["kern"](*c["args"])
                                            for c in parts], 1)
                set_counts(saved)
                row["k4_reference_chunk"] = {
                    "queries": qc, "launches": len(parts), "ms": chunk_ms,
                    "stream_rows": sum(c["stream_rows"] for c in parts)}
                del parts
        report[name] = row
        print(f"ivf {name}: {json.dumps(row)}", flush=True)
    for name in ("ivf_p32", "ivf_p128"):
        br = profile_run(lambda: search_ivf_flat(
            res, f32, Q, IVF_K, n_probes=report[name]["P"],
            fine_scan="list"))
        print(json.dumps({"profile": name, **br}), flush=True)
    # a reference point only: no single PyTorch call computes the masked
    # gather-and-fold, so library_ms stays null
    qb, sb = Q.to(torch.bfloat16), f32.slab.to(torch.bfloat16)
    report["matmul_whole_slab_bf16_ms"] = cuda_ms(
        lambda: torch.matmul(qb, sb.T), 3)
    del qb, sb
    print(f"K4 library_ms: null (no one PyTorch call computes the masked "
          f"gather-and-fold); bf16 torch.matmul of the queries against the "
          f"whole slab, a reference point only: "
          f"{report['matmul_whole_slab_bf16_ms']} ms", flush=True)
    common = {"route": "cuda", "source": "raft_tpu_torch/ops/csrc/"
              "fine_scan.cu"}
    k4_entry = {"name": "fine_scan_list_major", **common,
                "replaces": "raft_tpu/ops/fine_scan_pallas.py:280",
                "launches": report["ivf_p32"]["launches"]["K4"]
                + report["ivf_p128"]["launches"]["K4"],
                **{k: v for k, v in k4_rows["ivf_p32"].items()},
                "p128": k4_rows["ivf_p128"]}
    q8_entry = {"name": "fine_scan_list_major_q8", **common,
                "replaces": "raft_tpu/ops/fine_scan_pallas.py:329",
                "launches": report["ivf_q8_p64"]["launches"]["K4_q8"],
                **k4_rows["ivf_q8_p64"]}
    return report, [k4_entry, q8_entry], p32_work


def profile_run(fn, top: int = 8):
    """Device time by kernel of one ``fn()`` under torch.profiler: the top
    kernels, their sum (device busy, one stream) and the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_ms(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0)) / 1e3

    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    rows = sorted(((e.key[:80], dev_ms(e), e.count) for e in kernels),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if not rows:
        return {"wall_ms": wall * 1e3, "device_events": 0}
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / (wall * 1e3)),
            "top": [{"kernel": k, "ms": ms, "calls": n}
                    for k, ms, n in rows[:top]]}


# ---------------------------------------------------------------- spectral
def spmv_bound_ms(nnz: int, n_rows: int, n_cols: int, V: int = 1):
    """Least time for Y = A·B with B [n_cols, V]: the CSR form read once
    (nnz·8 + (n_rows + 1)·4 bytes), B read and Y written once
    (V·(n_cols + n_rows)·4 bytes), against 2·nnz·V f32 operations."""
    nbytes = nnz * 8 + (n_rows + 1) * 4 + V * (n_cols + n_rows) * 4
    t_ops, t_bytes = 2.0 * nnz * V / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sddmm_bound_ms(nnz: int, m: int, n: int, d: int):
    """Least time for SDDMM: the structure in CSR form read and the values
    written once (nnz·8 + (m + 1)·4 bytes), A and B read once
    ((m + n)·d·4 bytes), against 2·nnz·d f32 flops."""
    nbytes = nnz * 8 + (m + 1) * 4 + (m + n) * d * 4
    t_ops, t_bytes = 2.0 * nnz * d / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def sparse_counts():
    from raft_tpu_torch.ops import sddmm as k7
    from raft_tpu_torch.ops import spmv as k6

    return {"K6a": k6.LAUNCHES_SPMV, "K6b": k6.LAUNCHES_PAIR,
            "K6c": k6.LAUNCHES_SPMM, "K7": k7.LAUNCHES}


def set_sparse_counts(c):
    from raft_tpu_torch.ops import sddmm as k7
    from raft_tpu_torch.ops import spmv as k6

    (k6.LAUNCHES_SPMV, k6.LAUNCHES_PAIR, k6.LAUNCHES_SPMM,
     k7.LAUNCHES) = c["K6a"], c["K6b"], c["K6c"], c["K7"]


def check_bound(tag: str, got, ref, bound) -> float:
    """|got − ref| ≤ bound everywhere; returns the max error."""
    import torch

    diff = (got - ref).abs()
    ok = bool((diff <= bound).all())
    worst = float((diff / bound.clamp_min(1e-30)).max())
    check(ok, f"{tag}: kernel and twin differ beyond the stated bound "
          f"(max |diff| {diff.max().item()}, worst diff/bound {worst})")
    torch.cuda.synchronize()
    return diff.max().item()


def library_ms(fn, reps: int):
    """CUDA-event ms of one PyTorch library call (the yardstick only; the
    port never calls it), or None with the reason when it refuses."""
    try:
        return cuda_ms(fn, reps)
    except (RuntimeError, NotImplementedError) as e:
        print(f"library call refused: {e}", flush=True)
        return None


def f64_residuals(L, vals, vecs, norm=None):
    """Relative residuals ‖L·v − λ·v‖ / ‖L‖₂ of each pair in f64, with the
    plain CSR SpMV, ‖L‖₂ estimated from below by 30 power iterations
    unless given (so the check is no looser than with the true norm); the
    norm; and ‖VᵀV − I‖_max."""
    import torch
    from raft_tpu_torch.sparse import linalg as sl

    L64 = L.with_values(L.values.double())
    V = vecs.double()
    R = torch.stack([sl.spmv(None, L64, V[:, i]) - vals[i].double() * V[:, i]
                     for i in range(V.shape[1])], 1)
    if norm is None:
        gen = torch.Generator(device=V.device)
        gen.manual_seed(1)
        z = torch.randn(V.shape[0], generator=gen, device=V.device,
                        dtype=torch.float64)
        for _ in range(30):
            z = sl.spmv(None, L64, z / z.norm())
        norm = z.norm().item()
    gram = V.T @ V
    ortho = (gram - torch.eye(V.shape[1], dtype=torch.float64,
                              device=V.device)).abs().max().item()
    return (R.norm(dim=0) / norm).tolist(), norm, ortho


class _TwinOperator:
    """The normalized Laplacian's layout applied by the K6a twin: a Lanczos
    operand (``shape``, ``dtype``, ``device``, ``mv``) that runs the same
    solve without the kernel."""

    def __init__(self, tiled):
        import torch

        self.tiled, self.shape = tiled, tiled.shape
        self.dtype, self.device = torch.float32, tiled.device

    def mv(self, x):
        from raft_tpu_torch.ops import spmv as k6

        return k6.spmv_tiled_ref(self.tiled, x)


def band_matrix(n: int, half: int, gen):
    """Symmetric band matrix, entries (i, i+o) for |o| ≤ half, values
    1 + N(0, 1) from ``gen``, as COO on the card."""
    import torch
    from raft_tpu_torch.core.sparse_types import COOMatrix

    rows, cols, vals = [], [], []
    for o in range(half + 1):
        i = torch.arange(n - o, device="cuda", dtype=torch.int32)
        v = 1.0 + torch.randn(n - o, generator=gen, device="cuda")
        rows += [i, i + o] if o else [i]
        cols += [i + o, i] if o else [i]
        vals += [v, v] if o else [v]
    return COOMatrix(torch.cat(rows), torch.cat(cols), torch.cat(vals),
                     (n, n))


def csr_tensor(A):
    """``torch.sparse_csr_tensor`` view of a port CSR matrix (the
    library yardstick's operand)."""
    import torch

    return torch.sparse_csr_tensor(A.indptr, A.indices, A.values,
                                   size=A.shape)


def spectral_phase(res, scale: int = 22, band_n: int = 1 << 20,
                   c4=(17, 1_000_000), dense_rows: int = 100_000):
    """Phases 6–8 (see the module doc) at R-MAT ``scale``, a band matrix of
    ``band_n`` rows, config 4 at ``c4`` = (scale, edges) and config 3 at
    ``dense_rows`` × 1000. Returns (the ``spectral`` report, the K6/K7
    ``kernels`` entries)."""
    import dataclasses

    import torch
    from raft_tpu_torch.core.sparse_types import COOMatrix
    from raft_tpu_torch.models import SpectralEmbedding
    from raft_tpu_torch.ops import sddmm as k7
    from raft_tpu_torch.ops import spmv as k6
    from raft_tpu_torch.random import make_blobs, rmat_rectangular_gen
    from raft_tpu_torch.sparse import convert
    from raft_tpu_torch.sparse import linalg as sl
    from raft_tpu_torch.sparse.solver import (LanczosSolverConfig,
                                              lanczos_compute_eigenpairs)

    zero = {"K6a": 0, "K6b": 0, "K6c": 0, "K7": 0}
    report, rows_k = {}, {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)

    # ---- phase 6: spectral_g22, the headline ----
    n, n_edges = 1 << scale, 16 << scale
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src, dst = rmat_rectangular_gen(res, 3, n_edges, scale, scale)
    adj = COOMatrix(torch.cat([src, dst]), torch.cat([dst, src]),
                    torch.ones(2 * n_edges, device="cuda"), (n, n))
    del src, dst
    torch.cuda.synchronize()
    g22 = {"scale": scale, "n": n, "edges": n_edges, "entries": adj.nnz,
           "graph_s": time.perf_counter() - t0}
    model = SpectralEmbedding(n_components=4, normalized=True,
                              drop_first=True, max_iterations=400,
                              tolerance=1e-5, seed=42, tiled=True, res=res)
    set_sparse_counts(zero)
    t0 = time.perf_counter()
    emb = model.fit_transform(adj)
    torch.cuda.synchronize()
    g22["fit_s"] = time.perf_counter() - t0
    g22["launches"] = sparse_counts()
    check(g22["launches"]["K6a"] > 0, "spectral_g22: the fit launched K6a "
          "no time")
    evals = model.eigenvalues_
    check(tuple(emb.shape) == (n, 4) and bool(torch.isfinite(emb).all())
          and bool(torch.isfinite(evals).all()),
          "spectral_g22: the embedding is not finite [n, 4]")
    print(f"spectral_g22 fit: {g22['fit_s']:.3f} s, launches "
          f"{g22['launches']}, eigenvalues {evals.tolist()}", flush=True)

    # the fit's steps one by one
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L, _ = sl.laplacian_normalized(res, adj)
    torch.cuda.synchronize()
    g22["laplacian_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    T = sl.prepare_spmv(L)
    torch.cuda.synchronize()
    g22["layout_s"] = time.perf_counter() - t0
    g22.update(laplacian_nnz=L.nnz, scatter_slots=T.m_chunks * T.E,
               gather_slots=T.n_chunks * T.E,
               slots_per_nnz=T.m_chunks * T.E / L.nnz)
    cfg = LanczosSolverConfig(n_components=5, max_iterations=400,
                              tolerance=1e-5, seed=42)
    saved = sparse_counts()
    vals, _ = lanczos_compute_eigenpairs(res, T, cfg)        # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lanczos_compute_eigenpairs(res, T, cfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    g22["solve_ms"] = 1e3 * statistics.median(times)
    g22["solve_ms_all"] = [1e3 * t for t in times]
    g22["profile"] = profile_run(lambda: lanczos_compute_eigenpairs(
        res, T, cfg))
    set_sparse_counts(saved)

    # correctness on the card: the fit's pairs, and the twin's solve
    resid, norm_l, ortho = f64_residuals(L, evals, emb)
    g22.update(residuals=resid, norm_L=norm_l, orthonormality=ortho,
               eigenvalues=evals.tolist())
    check(max(resid) <= 1e-4, f"spectral_g22: relative residuals {resid} "
          f"exceed 1e-4 (10× the tolerance)")
    check(ortho <= 1e-4, f"spectral_g22: ‖VᵀV − I‖ = {ortho} > 1e-4")
    tvals, tvecs = lanczos_compute_eigenpairs(res, _TwinOperator(T), cfg)
    tres, _, _ = f64_residuals(L, tvals, tvecs, norm_l)
    g22.update(twin_eigenvalues=tvals.tolist(),
               kernel_eigenvalues=vals.tolist(), twin_residuals=tres)
    gap = (vals - tvals).abs().max().item()
    g22["eigenvalue_gap"] = gap
    check(gap <= 1e-5, f"spectral_g22: eigenvalues through K6a {vals.tolist()}"
          f" and through its twin {tvals.tolist()} differ by {gap} > 1e-5")

    # K6a against its twin, timed, on the run's own layout
    x = torch.randn(n, generator=gen, device="cuda")
    saved = sparse_counts()
    y = k6.spmv_tiled(T, x)
    hold = []
    plain = cuda_ms(lambda: hold.append(k6.spmv_tiled_ref(T, x)), 1,
                    warmup=0)
    deg = (L.indptr[1:] - L.indptr[:-1]).float()
    T_abs = dataclasses.replace(T, vals=T.vals.abs())
    bound = (deg + 2) * 2.0 ** -24 * k6.spmv_tiled_ref(T_abs, x.abs())
    err = check_bound("K6a", y, hold[0], bound)
    del hold, y
    ms = cuda_ms(lambda: k6.spmv_tiled(T, x), 20)
    set_sparse_counts(saved)
    Lt = csr_tensor(L)
    lib = library_ms(lambda: Lt @ x[:, None], 20)
    b_ms, b_by = spmv_bound_ms(L.nnz, n, n)
    rows_k["K6a"] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib,
                     "max_abs_err": err,
                     "launches": g22["launches"]["K6a"]}
    g22["matvecs_per_fit"] = g22["launches"]["K6a"]
    g22["k6a_ms"] = ms
    print(f"K6a at spectral_g22: {json.dumps(rows_k['K6a'])}", flush=True)

    # K6c (SpMM) on the same layout, V = 16 and 128, through linalg.spmm
    k6c = {}
    for V in (16, 128):
        B = torch.randn((n, V), generator=gen, device="cuda")
        set_sparse_counts(zero)
        Y = sl.spmm(res, T, B)
        torch.cuda.synchronize()
        launches = sparse_counts()["K6c"]
        check(launches > 0, f"spmm V={V}: K6c launched no time")
        hold = []
        plain = cuda_ms(lambda: hold.append(k6.spmm_tiled_ref(T, B)), 1,
                        warmup=0)
        bound = (deg + 2)[:, None] * 2.0 ** -24 * k6.spmm_tiled_ref(
            T_abs, B.abs())
        err = check_bound(f"K6c V={V}", Y, hold[0], bound)
        del hold, Y, bound
        ms = cuda_ms(lambda: k6.spmm_tiled(T, B), 5)
        lib = library_ms(lambda: Lt @ B, 5)
        b_ms, b_by = spmv_bound_ms(L.nnz, n, n, V)
        k6c[V] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                  "bound_by": b_by, "library_ms": lib, "max_abs_err": err,
                  "launches": launches, "V": V}
        print(f"K6c at V={V}: {json.dumps(k6c[V])}", flush=True)
        del B
    rows_k["K6c"] = {**k6c[16], "V128": k6c[128]}
    del T_abs, Lt, T, L, emb, model
    torch.cuda.empty_cache()

    # ---- K7 on the adjacency structure, d = 64, through linalg.sddmm ----
    d = 64
    S = convert.coo_to_csr(adj)
    del adj
    torch.cuda.empty_cache()
    A = torch.randn((n, d), generator=gen, device="cuda")
    Bm = torch.randn((d, n), generator=gen, device="cuda")
    set_sparse_counts(zero)
    out = sl.sddmm(res, A, Bm, S)
    torch.cuda.synchronize()
    launches = sparse_counts()["K7"]
    check(launches > 0, "sddmm: K7 launched no time")
    saved = sparse_counts()
    rows, cols = S.row_ids(), S.indices
    hold = []
    plain = cuda_ms(lambda: hold.append(k7.sddmm_entries_ref(A, Bm, rows,
                                                             cols)), 1,
                    warmup=0)
    bound = (d + 2) * 2.0 ** -24 * k7.sddmm_entries_ref(A.abs(), Bm.abs(),
                                                        rows, cols)
    twin = hold.pop()
    err = check_bound("K7", out.values, twin, bound)
    del out
    ms = cuda_ms(lambda: k7.sddmm_entries(A, Bm, rows, cols), 5)
    # the same entries in the (row tile × column tile) order of a TiledPairs
    # layout (each result still written to its entry): the TPU kernel's
    # blocks, timed against the entry order the path runs
    tile_ms = {}
    for R, C in ((16384, 16384), (256, 512)):
        key = (rows.long() // R) * (-(-n // C)) + cols.long() // C
        order = torch.argsort(key, stable=True)
        ro, co = rows[order].contiguous(), cols[order].contiguous()
        order = order.to(torch.int32)
        check_bound(f"K7 in {R}×{C} tile order",
                    k7.sddmm_entries(A, Bm, ro, co, dst=order), twin, bound)
        tile_ms[f"{R}x{C}"] = cuda_ms(
            lambda: k7.sddmm_entries(A, Bm, ro, co, dst=order), 5)
        del key, order, ro, co
    set_sparse_counts(saved)
    del bound, twin
    St = csr_tensor(S)
    lib = library_ms(lambda: torch.sparse.sampled_addmm(St, A, Bm, beta=0.0),
                     5)
    b_ms, b_by = sddmm_bound_ms(S.nnz, n, n, d)
    rows_k["K7"] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                    "bound_by": b_by, "library_ms": lib, "max_abs_err": err,
                    "launches": launches, "d": d,
                    "tile_order_ms": tile_ms}
    print(f"K7 at d={d}: {json.dumps(rows_k['K7'])}", flush=True)
    del A, Bm, St, S, rows, cols
    torch.cuda.empty_cache()
    report["spectral_g22"] = g22
    print(f"spectral_g22: {json.dumps(g22)}", flush=True)

    # ---- K6b on a block-clustered (band) matrix, through a Lanczos solve
    Bd = band_matrix(band_n, 16, gen)
    t0 = time.perf_counter()
    TP = sl.prepare_spmv(Bd, layout="pairs")
    torch.cuda.synchronize()
    band = {"n": band_n, "nnz": Bd.nnz, "layout_s": time.perf_counter() - t0,
            "slots_per_nnz": TP.pairs.m_chunks * TP.pairs.E / Bd.nnz}
    bcfg = LanczosSolverConfig(n_components=4, max_iterations=60,
                               tolerance=1e-5, seed=1)
    set_sparse_counts(zero)
    bvals, _ = lanczos_compute_eigenpairs(res, TP, bcfg)
    torch.cuda.synchronize()
    band["launches"] = sparse_counts()["K6b"]
    band["eigenvalues"] = bvals.tolist()
    check(band["launches"] > 0 and bool(torch.isfinite(bvals).all()),
          "band: the pair-tiled solve launched K6b no time")
    x = torch.randn(band_n, generator=gen, device="cuda")
    saved = sparse_counts()
    y = k6.spmv_pair_tiled(TP, x)
    hold = []
    plain = cuda_ms(lambda: hold.append(k6.spmv_pair_tiled_ref(TP, x)), 1,
                    warmup=0)
    Bcsr = convert.coo_to_csr(Bd)
    rnz = (Bcsr.indptr[1:] - Bcsr.indptr[:-1]).float()
    bound = (rnz + 2) * 2.0 ** -24 * sl.spmv(
        None, Bcsr.with_values(Bcsr.values.abs()), x.abs())
    err = check_bound("K6b", y, hold[0], bound)
    del hold, y
    ms = cuda_ms(lambda: k6.spmv_pair_tiled(TP, x), 20)
    set_sparse_counts(saved)
    Bt = csr_tensor(Bcsr)
    lib = library_ms(lambda: Bt @ x[:, None], 20)
    b_ms, b_by = spmv_bound_ms(Bd.nnz, band_n, band_n)
    rows_k["K6b"] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib, "max_abs_err": err,
                     "launches": band["launches"]}
    report["band_pairs"] = band
    print(f"K6b at the band matrix: {json.dumps(rows_k['K6b'])}; "
          f"{json.dumps(band)}", flush=True)
    del Bd, TP, Bcsr, Bt
    torch.cuda.empty_cache()

    # ---- phase 7: spectral_c4, BASELINE config 4 as bench_configs runs it
    s4, e4 = c4
    src, dst = rmat_rectangular_gen(res, 3, e4, s4, s4)
    adj4 = COOMatrix(torch.cat([src, dst]), torch.cat([dst, src]),
                     torch.ones(2 * e4, device="cuda"), (1 << s4, 1 << s4))
    c4r = {"scale": s4, "edges": e4}
    for name, tiled in (("ms_csr", False), ("ms_tiled", True)):
        def fit():
            return SpectralEmbedding(
                n_components=4, max_iterations=400, res=res, jit_loop=True,
                tiled=tiled).fit(adj4)
        m4 = fit()                                   # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fit()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        c4r[name] = 1e3 * statistics.median(times)
        c4r[name.replace("ms", "eigenvalues")] = m4.eigenvalues_.tolist()
        check(bool(torch.isfinite(m4.embedding_).all()),
              f"spectral_c4 {name}: the embedding is not finite")
    report["spectral_c4"] = c4r
    print(f"spectral_c4: {json.dumps(c4r)}", flush=True)
    del adj4, src, dst

    # ---- phase 8: lanczos_dense, config 3's Lanczos on a Gram operator
    X, _ = make_blobs(res, 2, dense_rows, 1000, n_clusters=16)
    Xs = X[:, :256]
    G = (Xs.T @ Xs) / dense_rows
    del X, Xs
    dcfg = LanczosSolverConfig(n_components=8, max_iterations=300, ncv=32,
                               tolerance=1e-6, seed=0, jit_loop=True)
    dv, dvec = lanczos_compute_eigenpairs(res, G, dcfg)     # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lanczos_compute_eigenpairs(res, G, dcfg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    G64 = G.double()
    w = torch.linalg.eigvalsh(G64)
    V = dvec.double()
    resid = ((G64 @ V - V * dv.double()).norm(dim=0) / w.abs().max()).tolist()
    report["lanczos_dense"] = {
        "rows": dense_rows, "ms": 1e3 * statistics.median(times),
        "residuals": resid, "eigenvalues": dv.tolist(),
        "eigvalsh": w[:8].tolist(),
        "max_eigenvalue_err": (dv.double() - w[:8]).abs().max().item()}
    check(bool(torch.isfinite(dv).all()) and max(resid) <= 1e-3,
          f"lanczos_dense: residuals {resid} exceed 1e-3")
    print(f"lanczos_dense: {json.dumps(report['lanczos_dense'])}",
          flush=True)

    replaces = {"K6a": "raft_tpu/ops/spmv_pallas.py:160",
                "K6b": "raft_tpu/ops/spmv_pallas.py:226",
                "K6c": "raft_tpu/ops/spmv_pallas.py:393",
                "K7": "raft_tpu/ops/sddmm_pallas.py:108"}
    names = {"K6a": "spmv_tiled", "K6b": "spmv_pair_tiled",
             "K6c": "spmm_tiled", "K7": "sddmm_tiled"}
    entries = []
    for key in ("K6a", "K6b", "K6c", "K7"):
        src_file = "sddmm.cu" if key == "K7" else "spmv.cu"
        entries.append({"name": names[key], "route": "cuda",
                        "source": f"raft_tpu_torch/ops/csrc/{src_file}",
                        "replaces": replaces[key], **rows_k[key]})
    return report, entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — nothing to drive",
              file=sys.stderr)
        return 2
    try:
        import raft_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the raft_tpu_torch package must sit beside "
              f"this script ({e})", file=sys.stderr)
        return 1
    from raft_tpu_torch import distance
    from raft_tpu_torch.distance.knn_fused import knn_fused
    from raft_tpu_torch.ops import _build
    from raft_tpu_torch.ops import fine_scan as k4
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.random import make_blobs

    # ---- phase 1: device and build ----
    card = gpu_name_power()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["fused_l2_topk", "fine_scan", "spmv", "sddmm"])
    k1._launcher()
    k4._launcher()
    _build.load("spmv")
    _build.load("sddmm")
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_SECONDS})", flush=True)
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    # ---- phase 2: K1 against its twin ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    Q, M, d, T, g, pbits = 512, 131072, 128, 2048, 16, 8
    x = torch.randn(Q, d, device="cuda", generator=gen)
    y = torch.randn(M, d, device="cuda", generator=gen)
    y_hi, y_lo = k1.split_hi_lo(y)
    yyh = 0.5 * (y * y).sum(1)
    yyh[-100:] = k1._PACK_PAD                      # a padded tail
    xxh = 0.5 * (x * x).sum(1)
    for passes in (1, 3):
        for pair in (False, True):
            n0 = k1.LAUNCHES
            kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits,
                      xxh=xxh)
            out = k1.fused_l2_group_topk_packed(x, y_hi, y_lo, yyh, **kw)
            torch.cuda.synchronize()
            check(k1.LAUNCHES == n0 + 1, "K1 launch was not counted")
            ref = k1.fused_l2_group_topk_packed_ref(x, y_hi, y_lo, yyh,
                                                    **kw)
            err = compare_k1(out, ref, x, y_hi, pbits, pair)
            print(f"K1 vs twin Q={Q} M={M} d={d} passes={passes} "
                  f"pair={pair}: max_abs_err={err}", flush=True)
    del x, y, y_hi, y_lo, yyh, xxh, out, ref

    # ---- phase 3: the main path at full size ----
    res = raft_tpu_torch.DeviceResources(device="cuda", seed=0)
    X, _ = make_blobs(res, 0, N_INDEX, DIM, n_clusters=64, cluster_std=2.0)
    Qx = X[:N_QUERIES].clone()
    t0 = time.perf_counter()
    idx1 = distance.prepare_knn_index(X, passes=1)
    idx3 = distance.prepare_knn_index(X, passes=3)
    res.sync()
    print(f"prepare (p1 + p3): {time.perf_counter() - t0:.3f} s; "
          f"T={idx1.T} g={idx1.g} pbits={idx1.pbits} "
          f"M={idx1.y_hi.shape[0]}", flush=True)
    o_vals, o_ids = exact_oracle(X, Qx, K)

    runs = {"p1": (idx1, "kernel"), "p3": (idx3, "kernel"),
            "p1_f32": (idx1, "f32")}
    main_path, launches = {}, {}
    for name, (index, certify) in runs.items():
        k1.LAUNCHES = 0
        vals, ids = distance.knn(res, index, Qx, k=K, certify=certify)
        torch.cuda.synchronize()
        launches[name] = k1.LAUNCHES
        check(launches[name] > 0, f"{name}: the main path launched K1 "
              f"no time")
        check(tuple(vals.shape) == (N_QUERIES, K)
              and bool(torch.isfinite(vals).all()),
              f"{name}: results are not finite [Q, k]")
        if name == "p1":
            got, want = ids.cpu().tolist(), o_ids.cpu().tolist()
            hit = [len(set(a) & set(b)) for a, b in zip(got, want)]
            recall = sum(hit) / (N_QUERIES * K)
            check(recall >= 0.99, f"p1 recall {recall} < 0.99")
            quality = {"recall": recall}
        else:
            n_tie = check_exact(ids, o_ids, o_vals, X, Qx, name)
            quality = {"ids_exact": True, "tie_queries": n_tie,
                       "max_abs_val_err":
                       (vals - o_vals).abs().max().item()}
        _, _, n_fail = knn_fused(Qx, index, K, certify=certify,
                                 with_stats=True)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            distance.knn(res, index, Qx, k=K, certify=certify)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = 1e3 * statistics.median(times[1:])
        main_path[name] = {"ms": ms, "gbps": N_QUERIES * N_INDEX * 4.0
                           / (ms * 1e-3) / 1e9, "n_fail": n_fail,
                           "launches": launches[name], **quality}
        print(f"main path {name}: {json.dumps(main_path[name])}",
              flush=True)

    # ---- K1 on the main path's own inputs: twin, times, bound ----
    xq = Qx
    xxh = 0.5 * (xq * xq).sum(1)
    entry = None
    for index, pair in ((idx1, True), (idx3, False)):
        kw = dict(T=index.T, g=index.g, passes=index.passes, pair=pair,
                  pbits=index.pbits, xxh=xxh)
        args = (xq, index.y_hi, index.y_lo, index.yyh_k)
        n0 = k1.LAUNCHES
        out = k1.fused_l2_group_topk_packed(*args, **kw)
        ref = k1.fused_l2_group_topk_packed_ref(*args, **kw)
        err = compare_k1(out, ref, xq, index.y_hi, index.pbits, pair)
        del out, ref
        ms = cuda_ms(lambda: k1.fused_l2_group_topk_packed(*args, **kw), 10)
        plain_ms = cuda_ms(
            lambda: k1.fused_l2_group_topk_packed_ref(*args, **kw), 3)
        k1.LAUNCHES = n0             # comparison launches do not count
        Mi = index.y_hi.shape[0]
        S = -(-(Mi // index.T) // index.g) * 128
        bound, bound_by = k1_bound_ms(N_QUERIES, Mi, index.stream_width,
                                      S, index.passes)
        xb, yb = xq.to(torch.bfloat16), index.y_hi
        library_ms = cuda_ms(lambda: torch.matmul(xb, yb.T), 10)
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by, "library_ms": library_ms,
               "max_abs_err": err}
        if index.passes == 1:
            entry = {"name": "fused_l2_group_topk_packed", "route": "cuda",
                     "source": "raft_tpu_torch/ops/csrc/fused_l2_topk.cu",
                     "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:1269",
                     "launches": sum(launches.values()), **row}
        else:
            entry["p3"] = row
        print(f"K1 at the main path, passes={index.passes} pair={pair}: "
              f"{json.dumps(row)}", flush=True)
    torch.cuda.synchronize()

    for name, (index, certify) in runs.items():
        br = profile_run(lambda: distance.knn(res, index, Qx, k=K,
                                              certify=certify))
        print(json.dumps({"profile": name, **br}), flush=True)
    bounds = unported_bounds_ms(N_QUERIES, Mi, index.stream_width, S,
                                index.T)
    del X, Qx, idx1, idx3, o_vals, o_ids
    torch.cuda.empty_cache()

    # ---- phases 4 and 5: K4 against its twin, then IVF-Flat ----
    ivf, k4_entries, (p32_rows, p32_pairs) = ivf_phase(
        res, N_INDEX, N_QUERIES, IVF_LISTS)
    bounds.update(ivf_unported_bounds_ms(N_QUERIES, DIM, p32_rows,
                                         p32_pairs))
    torch.cuda.empty_cache()

    # ---- phases 6–8: the spectral path ----
    spectral, sparse_entries = spectral_phase(res)
    print(json.dumps({"bounds_unported_ms": bounds}), flush=True)
    print(json.dumps({"main_path": main_path}), flush=True)
    print(json.dumps({"ivf": ivf}), flush=True)
    print(json.dumps({"spectral": spectral}), flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [entry, *k4_entries, *sparse_entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
