#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device and build: the card's name and power limit, then every CUDA
   kernel of the port built from the sources in this checkout.
2. K1 against its plain PyTorch twin on the card, at Q=512 × M=131072 ×
   d=128 for passes {1, 3} × pair {False, True}; then K2 (K1 over an int8
   database) against its twin at Q=256 × 4 groups of 16 × 2048 rows × 128,
   the same four modes: values (code bits cleared) within the f32
   summation bound (d + 2)·2⁻²⁴·Σ|x||ŷ| plus the norm terms' roundings and
   two units of the packing truncation; a slot's code may differ only
   where the two rows it names score within that bound (a tie, proven in
   f64).
3. The main path at full size, as ``bench.py`` configures it: make_blobs
   1,000,000 × 128 (64 clusters, std 2.0), the first 2048 rows as queries,
   k=64; ``prepare_knn_index`` at passes 1 and 3, bf16 and int8, then
   ``distance.knn`` at passes=1, passes=3, passes=1 with
   ``certify="f32"`` (K1), and int8 at passes 1 and 3 (K2). The kernels'
   launch counts are zeroed before each run and read after it. Results are
   held against an exact f32 oracle (chunked matmul + topk): ids identical
   at passes=3, certify="f32" and int8, recall ≥ 0.99 at passes=1. K1 and
   K2 are held against their twins once more on the main path's own
   inputs, and timed beside the twin, the bound and the library product of
   the same shape. Each run is traced once more under torch.profiler, and
   its device time by kernel, busy time and idle share (profiler on) are
   printed.
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
   its bound. serve_ivf_flat: an ``ivf_flat`` engine over the f32 index at
   P=32 under the fine-scan chooser, 300 requests with phase 6d's recipe,
   parity probes bit-identical to ``search_ivf_flat`` single-shot, 0
   builds after warm-up, p50/p99 and requests/s.
6. IVF-PQ on phase 5's data and lists: ``build_ivf_pq`` (max_iter=8,
   seed=3, pq_dim 32) at 8 and 4 bits, the build seconds split into
   coarse, codebooks and encode. (a) K5 against its twin on one real
   schedule (the first 64 queries at P=32) at depths 2, 4 and 8: pool
   values bit for bit, rows equal except at exact ties. (b) pq8_p32,
   pq8_p128, pq4_p32, pq4_p128: ``search_ivf_pq(pq_scan="pq")`` with the
   counts zeroed just before and read just after; recall@10, the
   certificate rungs (certified, widened, exact rerun), id sets identical
   to ``pq_scan="flat"`` over the same probes up to proven ties (a hard
   check), the host-clock median of 5, K5 on the run's own inputs (CUDA
   events, beside its bound and, at P=32, its twin), the chooser's pick
   under ``auto`` and one profiled call. (d) serve_ivf_pq: an ``ivf_pq``
   engine over the 8-bit index at P=32, 500 requests with
   ``bench_serving.py``'s recipe (8 clients, Exp(1 ms), Poisson(16) on
   (16, 64, 256)), parity probes bit-identical to ``search_ivf_pq``
   single-shot, 0 builds after warm-up, p50/p99 and requests/s. (c)
   pq_diffuse_opq_p32, ``bench_ann.py:360-380``'s worst case: 1,000,000 ×
   128 N(0, 1) rows and 2048 N(0, 1) queries (a seeded torch generator),
   ``pq_dim=64``, ``pq_mode="opq"``, P=32, the same line with
   ``cert_rerun_frac`` reported (not gated) and flat parity gated.
7. spectral_g22, the spectral path at a size users run: an R-MAT graph
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
8. spectral_c4, BASELINE config 4 as ``bench_configs.py:105-129`` runs it
   (scale 17, 1,000,000 edges, ``jit_loop=True``): the fit timed on the
   CSR path and on the tiled path (host-clock median of 3).
9. lanczos_dense, config 3's Lanczos (``bench_configs.py:92-103``): the
   256 × 256 Gram operator of make_blobs 100,000 × 1,000 (16 clusters), 8
   components, ncv=32, tolerance 1e-6, 300 iterations; residuals ≤ 1e-3.
10. Serving at ``benchmarks/bench_serving.py:54,198-226``'s chip shape:
   1,000,000 × 128 rows of N(0, 1) from a seeded generator, k=64, 2000
   requests from 8 closed-loop clients with Exp(1 ms) think time, request
   sizes Poisson(16) clipped to [1, 256] on the default ladder (16, 64,
   256), through ``ServingEngine``: brute_bf16 (``prepare_knn_index(Y)``,
   passes=3, K1) and brute_int8 (``db_dtype="int8"``, K2), counts zeroed
   before each load run and read after it. Each prints p50/p99 latency,
   throughput, batches, mean fill, fixups and kernel builds after warm-up
   (must be 0), with no request failing; every 250th request is re-solved
   single-shot through ``knn_fused`` on the same index and must be
   bit-identical. Then ``update_index`` to a second seeded Y while 8
   clients keep submitting: every response must equal the single-shot
   answer of exactly one generation.
11. Pairwise distances and stats (``pairwise_stats_phase``). (a) K8
   (``ops.unexpanded``) against its twin for all ten unexpanded metrics
   (Minkowski at p = 3; KL and JS on non-negative row-normalised inputs,
   Hamming on rounded ones) at 256 queries × 1,000,000 rows × 128 of
   N(0, 1) from a seeded generator (``bench_unexpanded.py:48-55``'s data,
   the first 256 rows as queries), at config 1's 5,000 × 1,000 × 50, at
   333 × 4,097 × 61 and there with inf, −inf and NaN planted: Linf and
   Hamming bit for bit, the others within ``ops.unexpanded.error_bound``
   ((d + 2 + U)·2⁻²⁴·Σ|term| carried through the finalize, U the ulp of
   logf/powf), non-finite entries equal in kind; the worst diff/bound is
   printed. (b) K8 at 2048 × 1,000,000 × 128 for l1, linf, canberra and
   hamming (CUDA events), held to its twin the same way, beside the twin
   (once), the bound (FP32 instructions a term at 132 × 128 × 1.98 GHz, the
   SFU reciprocal for canberra, or the bytes) and ``torch.cdist`` at p = 1
   and p = ∞, and ``torch.cdist(p=0) / d`` for hamming (held once to the
   twin within 2⁻²⁴ per entry); canberra's library time is null, since no
   PyTorch call computes it. (c) BASELINE config 1 (``bench_configs.py:65-72``):
   ``pairwise_distance(res, X, X[:1000])`` on make_blobs 5,000 × 50 (8
   clusters), euclidean (cuBLAS) and l1 (K8, one launch), host-clock
   median of 20 and GB/s of the [5,000, 1,000] f32 matrix, values within
   the f32 bound of an f64 ``torch.cdist``. (d) K9 (``ops.histogram``) bit
   for bit against its twin and ``torch.bincount`` at
   ``bench_prims.py:125-130``'s 100,000 × 8 bins (64), on the batch-1
   bins of ``value_histogram`` over make_blobs 100,000 × 128 (12.8 M
   values) and on per-column bins of the 1,000,000 × 128 matrix (64
   bins), each timed beside the twin, the bound and ``torch.bincount``;
   and, untimed, at 3 × 786,437 bins (1024 bins), whose 65,537 column
   slabs are more than a grid's 65,535 rows.
   (e) The stats path on make_blobs 100,000 × 128 (16 clusters,
   ``bench_prims.py:44-46``), the K8/K9 counts zeroed just before and read
   after (both must be > 0), and first, outside the counts, K8 held to its
   twin at the silhouette's chunks (the first 1,024 and the last 672 rows
   against all 100,000, l1, where d = 128 leaves a ragged 32-column
   tile): moments (relative 1e-4 of f64), ``KMeans(16)
   .fit``, ARI (equal to a numpy evaluation to 1e-12) and V-measure
   against the true labels, ``stats.histogram`` of the labels (K9, equal
   to ``torch.bincount``), ``silhouette_score_batched`` with sqeuclidean
   and l1 (K8, 98 chunks of 1024 × 100,000 × 128), each within 1e-4 of
   the same call in f64, and trustworthiness at n = 5,000 against a
   seeded 128 → 16 projection, within 1e-4 of f64.
12. A JSON ``kernels`` line, ``main_path``, ``serving``, ``ivf``,
   ``ivf_pq``, ``spectral`` and ``pairwise_stats`` lines, the total wall
   time, the card's name and power limit, and the result line ``{"ok":
   true, "device": {...}}``.

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

H100_BF16_FLOPS = 989e12        # dense bf16 tensor-core peak (SXM)
H100_BYTES_PER_S = 3.35e12      # HBM3
H100_F32_FLOPS = 67e12          # f32 off the tensor cores (SXM)

N_INDEX, DIM, N_QUERIES, K = 1_000_000, 128, 2048, 64
# the serving phase: bench_serving.py's chip shape (rows, d, k, requests,
# clients) and its mean think time
SERVE_SHAPE = (1_000_000, 128, 64, 2000, 8)
SERVE_THINK_S = 1e-3
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


def k2_bound_ms(Q: int, M: int, d: int, S: int, passes: int):
    """Least time for K2's work: the bf16 products (x hi, and x lo at
    passes=3, against exact codes) at the tensor-core peak, or the
    queries, the int8 rows, their norms, the group scales and the query
    norms read once and the three pools written once at the HBM rate."""
    ops = 2.0 * Q * M * d * (2 if passes == 3 else 1)
    nbytes = Q * d * 4 + M * d + M * 4 + S // 128 * 4 + Q * 4 + 3 * Q * S * 4
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare_k2(kern, twin, x, y_q, scales, yyh, xxh, T: int, g: int,
               passes: int, pbits: int, pair: bool):
    """Hold K2's outputs against its twin's. Both sum the same exact bf16
    products in f32 in other orders, then scale once: a value (code bits
    cleared) may differ by (d + 2)·2⁻²⁴·Σ|x||ŷ| (the query's largest such
    sum over the rows), 4·2⁻²⁴ of the norm terms, and two units of the
    packing truncation. Where codes differ, both rows they name are scored
    in f64 and must lie within twice that bound of each other: a tie.
    Returns (max abs value error, slots whose codes differ)."""
    import torch

    d = x.shape[1]
    grp = torch.arange(y_q.shape[0], device=x.device) // (g * T)
    y_hat = y_q.float() * scales[grp][:, None]
    xb = x.to(torch.bfloat16).float()
    xs = xb.double()
    if passes == 3:
        xs = xs + (x - xb).to(torch.bfloat16).double()
    xa = x.abs()
    sum_abs = torch.stack([(xa @ y_hat[s:s + 131072].abs().T).max(1).values
                           for s in range(0, y_hat.shape[0], 131072)]
                          ).max(0).values.double()
    live = yyh < 2.0 ** 123
    acc = ((d + 2) * 2.0 ** -24 * sum_abs
           + 4 * 2.0 ** -24 * (yyh[live].max().double() + xxh.double()))
    err, n_diff = 0.0, 0
    for n, (a, b) in enumerate(zip(kern, twin)):
        ca, va = unpack(a, pbits)
        cb, vb = unpack(b, pbits)
        tol = acc[:, None] + 2.0 * 2.0 ** (pbits - 23) * vb.abs().double()
        diff = (va - vb).abs().double()
        check(bool((diff <= tol).all()),
              f"K2 values of output {n} differ by up to "
              f"{diff.max().item()} (bound {tol.min().item()})")
        err = max(err, diff.max().item())
        if n == 2 and pair:
            continue                       # a3's code means nothing here
        q_idx, s_idx = (ca != cb).nonzero(as_tuple=True)
        n_diff += int(q_idx.numel())
        if q_idx.numel():
            def row(code):
                return ((s_idx // 128) * g * T + code.long() * 128
                        + s_idx % 128)
            ra, rb = row(ca[q_idx, s_idx]), row(cb[q_idx, s_idx])

            def score(r):
                return (yyh[r].double()
                        - (y_hat[r].double() * xs[q_idx]).sum(1)
                        + xxh[q_idx].double())
            gap = (score(ra) - score(rb)).abs()
            check(bool((gap <= 2 * tol[q_idx, s_idx]).all()),
                  f"K2 output {n}: {int(q_idx.numel())} slots name other "
                  f"rows than the twin's, up to {gap.max().item()} apart")
    torch.cuda.synchronize()
    return err, n_diff


def unported_bounds_ms(Q: int, M: int, d: int, S: int, T: int):
    """Bounds, at the main path's shape, of the TPU kernels on this path's
    family that the port has not written yet (same rules as k1_bound_ms):
    K1's unpacked form (ids as two extra i32 outputs), its slot form (per
    tile and lane min, argmin, and a [Q, 128] 2nd-min) and K3 (the packed
    fold of the [Q, S] pool without a product)."""
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


def ann_data(res, n_rows: int, n_queries: int):
    """``bench_ann.py``'s data (see phase 5), its exact top-k oracle and
    the tie floor of the expanded f32 score: {X, Q, o_vals, o_ids,
    floor}."""
    import numpy as np
    import torch
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
    return {"X": X, "Q": Q, "o_vals": o_vals, "o_ids": o_ids,
            "floor": floor}


def ivf_phase(res, n_rows: int, n_queries: int, n_lists: int,
              probes=(32, 128, 64), data=None):
    """Phases 4 and 5 (see the module doc) at ``n_rows`` × 128 with
    ``n_lists`` lists; ``probes`` are the P of ivf_p32, ivf_p128 and
    ivf_q8_p64; ``data`` is :func:`ann_data`'s (made here when None).
    Returns (the ``ivf`` report, K4's two ``kernels`` entries)."""
    import torch
    from raft_tpu_torch.ann import build_ivf_flat, search_ivf_flat

    if data is None:
        data = ann_data(res, n_rows, n_queries)
    X, Q, o_vals, o_ids, floor = (data[n] for n in (
        "X", "Q", "o_vals", "o_ids", "floor"))
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
    # ---- phase 5b: a short served burst on the f32 index ----
    report["serve_ivf_flat"], _ = ivf_serving(res, f32, data, probes[0],
                                              "ivf_flat", n_requests=300)
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
    return report, [k4_entry, q8_entry]


# ------------------------------------------------------------------ IVF-PQ
PQ_SITE = "ann.search_ivf_pq"


def k5_bound_ms(nq: int, S: int, bits: int, P: int, depth: int,
                stream_rows: int, pair_rows: int):
    """Least time for K5's work on one batch: each probed list's codes and
    its two 4-byte sidecars (‖ŷ‖², Eq) read once, the queries' norms,
    probe table, needed centroid dots (nq·P) and tables (nq·S·2^bits f32)
    read once and the (2·depth + 1) [nq, 128] pools written once; or S +
    10 f32 operations per scored (query, row) pair (the table sum and the
    bound's arithmetic) at the f32 rate off the tensor cores."""
    cb = S if bits == 8 else S // 2
    nbytes = (stream_rows * (cb + 8) + nq * 4 + 2 * nq * P * 4
              + nq * S * (1 << bits) * 4 + (2 * depth + 1) * nq * 128 * 4)
    t_ops = float(S + 10) * pair_rows / H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k5_inputs(res, index, Qx, P: int):
    """K5's operands for one batch at ``P`` probes, built by the path's own
    ``adc_operands``, with the batch's streamed rows and scored pairs."""
    from raft_tpu_torch.ann import ivf_flat as ivf
    from raft_tpu_torch.ann import ivf_pq

    probes = ivf._coarse_probe(res, index.centroids, Qx, P)
    args, sch = ivf_pq.adc_operands(index, Qx, probes.cpu().numpy(), probes)
    return {"args": args, "bits": index.pq_bits, "S": index.pq_dim,
            "probes": probes, "stream_rows": sch.stream_rows,
            "lists": sch.n_lists_probed,
            "pair_rows": int(index.sizes[probes.long()].sum())}


def pq_counts():
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.ops import pq_scan as k5

    return {"K1": k1.LAUNCHES, "K5": k5.LAUNCHES_8BIT,
            "K5_4bit": k5.LAUNCHES_4BIT}


def set_pq_counts(c):
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.ops import pq_scan as k5

    k1.LAUNCHES, k5.LAUNCHES_8BIT, k5.LAUNCHES_4BIT = (
        c["K1"], c["K5"], c["K5_4bit"])


def k5_lb(args, bits: int, S: int, q: int, row: int) -> float:
    """The twin's arithmetic for one (query, slab row): the row's entry in
    the schedule, the table sum in subspace order, the certified bound."""
    import torch
    from raft_tpu_torch.ops.pq_scan import decode_codes

    sched, xx, _, cdot, lut, codes, yy, eq, _ = args
    lo = sched[0] + sched[2]
    j = int(((row >= lo) & (row < lo + sched[1]) & (sched[3] >= 0))
            .nonzero()[0, 0])
    code = decode_codes(codes[row:row + 1], S, bits)[0]
    adc = torch.zeros((), device=lut.device)
    for s in range(S):
        adc = adc + lut[q, s * (1 << bits) + code[s]]
    d2 = (xx[q, 0] + yy.reshape(-1)[row]) - 2.0 * cdot[q, j] - 2.0 * adc
    v = (d2.clamp_min(0.0).sqrt() - eq.reshape(-1)[row]).clamp_min(0.0)
    return float(v * v)


def compare_k5(out, ref, inp, tag: str):
    """Hold K5's pools against its twin's: the two sum the same f32 terms
    in the same order with the same roundings, so values (and +inf slots)
    must agree bit for bit, and a slot's row may differ only where both
    rows score exactly that value (a tie, re-evaluated by the twin's
    arithmetic). Returns (max abs error, tie slots)."""
    import torch

    depth = (len(out) - 1) // 2
    err = 0.0
    for n in list(range(0, 2 * depth, 2)) + [2 * depth]:
        a, b = out[n], ref[n]
        fin = torch.isfinite(b)
        check(bool((torch.isfinite(a) == fin).all()),
              f"{tag} output {n}: +inf slots differ from the twin's")
        diff = (torch.where(fin, a, 0.0) - torch.where(fin, b, 0.0)).abs()
        err = max(err, diff.max().item())
    check(err == 0.0, f"{tag}: pool values differ from the twin's by up "
          f"to {err} (the same sums in the same order: bit for bit)")
    ties = 0
    for t in range(depth):
        bad = (out[2 * t + 1] != ref[2 * t + 1]).nonzero().tolist()
        for q, lane in bad:
            want = float(out[2 * t][q, lane])
            got = [k5_lb(inp["args"], inp["bits"], inp["S"], q,
                         int(o[2 * t + 1][q, lane])) for o in (out, ref)]
            check(got[0] == got[1] == want, f"{tag}: slot ({q}, {lane}) "
                  f"level {t} holds rows scoring {got}, not a tie at "
                  f"{want}")
            ties += 1
    return err, ties


def pq_cell(res, name: str, index, Q, P: int, X, o_ids, floor,
            plain: bool = True):
    """One IVF-PQ cell: ``search_ivf_pq(pq_scan="pq")`` with the counts
    zeroed just before and read just after; recall@10 against the exact
    oracle; the rungs; id sets held to ``pq_scan="flat"`` over the same
    probes (ties proven); the host-clock median of 5; the chooser's pick
    under ``auto``; K5 on the run's own inputs (CUDA events, beside its
    bound and, with ``plain``, its twin); the certificate margin's
    quantiles over θ; one profiled call."""
    import torch
    from raft_tpu_torch.ann import ivf_pq, resolve_pq_scan, search_ivf_pq
    from raft_tpu_torch.observability import quality
    from raft_tpu_torch.ops import pq_scan as k5

    nq = Q.shape[0]
    kname = "K5" if index.pq_bits == 8 else "K5_4bit"
    c0 = quality.certificate_counts(PQ_SITE)
    set_pq_counts({"K1": 0, "K5": 0, "K5_4bit": 0})
    vals, ids, reruns = search_ivf_pq(res, index, Q, IVF_K, n_probes=P,
                                      pq_scan="pq", with_stats=True)
    torch.cuda.synchronize()
    launches = pq_counts()
    c1 = quality.certificate_counts(PQ_SITE)
    check(tuple(ids.shape) == (nq, IVF_K)
          and bool(torch.isfinite(vals).all()),
          f"{name}: results are not finite [nq, k]")
    check(launches[kname] > 0, f"{name}: {kname} launched no time")
    recall = (ids.long()[:, :, None] == o_ids[:, None, :]).any(2) \
        .float().mean().item()
    fv, fi = search_ivf_pq(res, index, Q, IVF_K, n_probes=P, pq_scan="flat")
    n_tie = check_exact(ids, fi, fv, X, Q, f"{name} against the flat scan",
                        floor)
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        search_ivf_pq(res, index, Q, IVF_K, n_probes=P, pq_scan="pq")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rungs = {r: c1[r] - c0[r] for r in ("certified", "widened",
                                        "exact_rerun")}
    inp = k5_inputs(res, index, Q, P)
    saved = pq_counts()
    bits, S = index.pq_bits, index.pq_dim
    out = k5.pq_scan_list_major(*inp["args"], pq_bits=bits)
    ms = cuda_ms(lambda: k5.pq_scan_list_major(*inp["args"], pq_bits=bits),
                 5)
    # the certificate's margin (pooled bound − θ − e_k) over θ, the
    # quantity the rungs decide on
    pr = inp["probes"]
    theta, _, _, margin = ivf_pq.pq_scan_chunk(
        index, Q, pr.cpu().numpy(), pr, index.offsets[:-1][pr.long()],
        index.padded_sizes[pr.long()], IVF_K, P, index.probe_window)
    rel = margin / theta[:, -1].clamp_min(1e-30)
    set_pq_counts(saved)            # comparison launches do not count
    bound, bound_by = k5_bound_ms(nq, S, bits, P, 2, inp["stream_rows"],
                                  inp["pair_rows"])
    k5_row = {"ms": ms, "bound_ms": bound, "bound_by": bound_by,
              "library_ms": None, "lists": inp["lists"],
              "stream_rows": inp["stream_rows"],
              "pair_rows": inp["pair_rows"],
              "launches_per_call": launches[kname]}
    if plain:
        hold = []
        k5_row["plain_ms"] = cuda_ms(lambda: hold.append(
            k5.pq_scan_list_major_ref(*inp["args"], pq_bits=bits)), 1,
            warmup=0)
        k5_row["max_abs_err"], k5_row["tie_slots"] = compare_k5(
            out, hold[0], inp, f"K5 {name}")
        del hold
    del out
    pick = resolve_pq_scan(index, nq, IVF_K, P, index.probe_window, "auto",
                           probes_np=inp["probes"].cpu().numpy())
    del inp
    row = {"P": P, "pq_bits": bits, "pq_dim": S, "pq_mode": index.pq_mode,
           "recall": recall, "rungs": rungs,
           "cert_rerun_frac": rungs["exact_rerun"] / nq,
           "exact_reruns": reruns, "flat_parity_tie_queries": n_tie,
           "ms": 1e3 * statistics.median(times), "launches": launches,
           "auto_pick": pick, "k5": k5_row,
           "margin_over_theta_q10_q50_q90": torch.quantile(
               rel, torch.tensor([0.1, 0.5, 0.9], device=rel.device))
           .tolist(),
           "profile": profile_run(lambda: search_ivf_pq(
               res, index, Q, IVF_K, n_probes=P, pq_scan="pq"))}
    print(f"ivf_pq {name}: {json.dumps(row)}", flush=True)
    return row


def ivf_serving(res, index, data, P: int, algorithm: str,
                n_requests: int = 500, seed: int = 0):
    """Phases 5b and 6d: an ``ivf_flat`` or ``ivf_pq`` engine over
    ``index`` at ``n_probes=P`` with ``bench_serving.py``'s recipe (8
    clients, Exp(1 ms) think time, Poisson(16) sizes on the ladder (16,
    64, 256)); requests are blocks of index rows plus N(0, 0.1) noise,
    like the phase's queries. Every ``n_requests // 8``-th request is
    asked again through the engine and single-shot through the plane's
    search, and the two answers must have the same bits. The ``ivf_pq``
    burst runs with ``RAFT_TPU_IVF_PQ_SCAN=pq`` (the cell serves through
    K5; the chooser's pick for each bucket under ``auto`` is reported);
    the ``ivf_flat`` burst serves under the fine-scan chooser, so a
    bucket and the request asked alone may take different schedules.
    Returns (the report row, the plane kernel's launches)."""
    import numpy as np
    import torch
    from raft_tpu_torch.ann import (resolve_pq_scan, search_ivf_flat,
                                    search_ivf_pq)
    from raft_tpu_torch.serving import ServingEngine

    is_pq = algorithm == "ivf_pq"
    tag = f"serve_{algorithm}"
    search = search_ivf_pq if is_pq else search_ivf_flat
    counts, set_c = (pq_counts, set_pq_counts) if is_pq \
        else (k4_counts, set_counts)
    if is_pq:
        kname = "K5" if index.pq_bits == 8 else "K5_4bit"
    else:
        kname = "K4_q8" if index.db_dtype == "int8" else "K4"
    X = data["X"]
    clients, ladder = SERVE_SHAPE[4], (16, 64, 256)
    rng = np.random.default_rng(seed + 5)
    sizes = np.clip(rng.poisson(ladder[0], n_requests), 1, ladder[-1])
    pick = torch.from_numpy(rng.choice(X.shape[0], 64 * ladder[-1],
                                       replace=False)).cuda()
    blocks = (X[pick].cpu().numpy() + rng.normal(
        0, 0.1, (64 * ladder[-1], DIM)).astype(np.float32)).reshape(
            64, ladder[-1], DIM)

    def request(i):
        return blocks[i % 64, :int(sizes[i % n_requests])]

    picks, prev = None, os.environ.get("RAFT_TPU_IVF_PQ_SCAN")
    if is_pq:
        # the cell serves through K5: the chooser's own pick per bucket is
        # reported beside it
        picks = {b: resolve_pq_scan(index, b, IVF_K, P, index.probe_window,
                                    "auto") for b in ladder}
        os.environ["RAFT_TPU_IVF_PQ_SCAN"] = "pq"
    engine = ServingEngine(index, k=IVF_K, algorithm=algorithm, n_probes=P)
    check(engine.buckets == ladder, f"{tag}: ladder {engine.buckets}")
    t0 = time.perf_counter()
    engine.start()
    warm_s = time.perf_counter() - t0
    try:
        set_c({n: 0 for n in counts()})
        s0 = engine.stats()
        lat, errors, wall, _ = closed_loop(
            engine, request, n_requests, clients, SERVE_THINK_S, seed)
        launches = counts()
        s1 = engine.stats()
        check(not errors and len(lat) == n_requests,
              f"{tag}: {len(errors)} requests failed: {errors[:3]}")
        if is_pq:
            check(launches[kname] > 0, f"{tag}: {kname} launched no time")
        check(s1["builds_after_warmup"] == 0,
              f"{tag}: {s1['builds_after_warmup']} kernel builds or loads "
              f"after warm-up")
        parity = 0
        for n_probe, i in enumerate(range(0, n_requests, n_requests // 8)):
            q = request(i)
            sv, si = engine.query(q, deadline_s=30.0 if n_probe % 2
                                  else None, timeout=120)
            ov, oi = search(res, index, torch.from_numpy(q).cuda(), IVF_K,
                            n_probes=P)
            check(np.array_equal(sv, ov.cpu().numpy())
                  and np.array_equal(si, oi.cpu().numpy()),
                  f"{tag}: request {i} served differs from "
                  f"{search.__name__} asked single-shot")
            parity += 1
        batches = s1["batches"] - s0.get("batches", 0)
        lat_ms = np.asarray(lat) * 1e3
        row = {"P": P, "warmup_s": warm_s,
               "p50_ms": float(np.percentile(lat_ms, 50)),
               "p99_ms": float(np.percentile(lat_ms, 99)),
               "throughput_rps": n_requests / wall,
               "rows_per_s": float(sizes.sum()) / wall,
               "n_requests": n_requests, "batches": batches,
               "mean_fill": float(sizes.sum()) / max(1, batches)
               / ladder[-1],
               "fixups": s1["fixups"] - s0.get("fixups", 0),
               "builds_after_warmup": s1["builds_after_warmup"],
               "warmup_builds": s1["warmup_builds"],
               "launches": launches, "parity_checked": parity,
               "profile": profile_run(lambda: closed_loop(
                   engine, request, 150, clients, SERVE_THINK_S,
                   seed + 1))}
        if is_pq:
            row.update(pq_bits=index.pq_bits, auto_pick_by_bucket=picks)
    finally:
        engine.stop()
        if is_pq:
            if prev is None:
                os.environ.pop("RAFT_TPU_IVF_PQ_SCAN")
            else:
                os.environ["RAFT_TPU_IVF_PQ_SCAN"] = prev
    print(f"{algorithm} {tag}: {json.dumps(row)}", flush=True)
    return row, launches[kname]


def pq_phase(res, data, n_lists: int, probes=(32, 128)):
    """Phase 6 (see the module doc) on :func:`ann_data`'s ``data`` with
    ``n_lists`` lists; ``probes`` are the P of the pq cells (the first is
    also the diffuse cell's, the served burst's and the K5-against-twin
    check's). Returns (the ``ivf_pq`` report, K5's two ``kernels``
    entries)."""
    import torch
    from raft_tpu_torch.ann import build_ivf_pq
    from raft_tpu_torch.ops import pq_scan as k5

    X, Q, o_ids, floor = (data[n] for n in ("X", "Q", "o_ids", "floor"))
    n_rows, nq = X.shape[0], Q.shape[0]
    report = {"build": {}}
    index = {}

    def build(tag, Y, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ix = build_ivf_pq(res, Y, n_lists, max_iter=8, seed=3, **kw)
        torch.cuda.synchronize()
        report["build"][tag] = {
            "seconds": time.perf_counter() - t0, **ix.build_seconds,
            "pq_dim": ix.pq_dim, "pq_bits": ix.pq_bits,
            "pq_mode": ix.pq_mode, "code_bytes": ix.code_bytes,
            "probe_window": ix.probe_window, "slab_rows": ix.slab_rows,
            "eq_row_max": float(ix.pq_eq_rows.max()),
            "eq_row_median": float(ix.pq_eq_rows[ix.ids >= 0].median()),
            "resid_med": ix.pq_resid_med}
        print(f"ivf_pq build {tag}: {json.dumps(report['build'][tag])}",
              flush=True)
        return ix

    for bits in (8, 4):
        index[bits] = build(f"pq{bits}", X, pq_bits=bits)

    # ---- phase 6a: K5 against its twin on one real schedule ----
    for bits in (8, 4):
        inp = k5_inputs(res, index[bits], Q[:64], probes[0])
        for depth in (2, 4, 8):
            saved = pq_counts()
            out = k5.pq_scan_list_major(*inp["args"], pq_bits=bits,
                                        pool_depth=depth)
            torch.cuda.synchronize()
            check(pq_counts() != saved, "a K5 launch was not counted")
            set_pq_counts(saved)
            ref = k5.pq_scan_list_major_ref(*inp["args"], pq_bits=bits,
                                            pool_depth=depth)
            err, ties = compare_k5(out, ref, inp, f"K5 {bits}-bit d{depth}")
            print(f"K5 vs twin ({bits}-bit, depth {depth}, 64 queries, "
                  f"P={probes[0]}, {inp['lists']} lists): max_abs_err={err} "
                  f"tie_slots={ties}", flush=True)
            del out, ref
        del inp

    # ---- phase 6b: the IVF-PQ path at full width ----
    for bits in (8, 4):
        for P in probes:
            report[f"pq{bits}_p{P}"] = pq_cell(
                res, f"pq{bits}_p{P}", index[bits], Q, P, X, o_ids, floor,
                plain=P == probes[0])
    del index[4]
    torch.cuda.empty_cache()

    # ---- phase 6d: a short served burst on the 8-bit index ----
    report["serve_ivf_pq"], serve_launches = ivf_serving(
        res, index[8], data, probes[0], "ivf_pq")
    del index[8]
    torch.cuda.empty_cache()

    # ---- phase 6c: the diffuse worst case (bench_ann.py:360-380) ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(19)
    Xg = torch.randn(n_rows, DIM, device="cuda", generator=gen)
    Qg = torch.randn(nq, DIM, device="cuda", generator=gen)
    _, og_ids = exact_oracle(Xg, Qg, IVF_K)
    floor_g = 16 * 2.0 ** -24 * ((Qg * Qg).sum(1) + (Xg * Xg).sum(1).max())
    idxg = build("pq_diffuse_opq", Xg, pq_dim=DIM // 2, pq_bits=8,
                 pq_mode="opq")
    report["pq_diffuse_opq_p32"] = pq_cell(
        res, "pq_diffuse_opq_p32", idxg, Qg, probes[0], Xg, og_ids, floor_g,
        plain=False)
    del Xg, Qg, idxg
    torch.cuda.empty_cache()

    common = {"route": "cuda", "source": "raft_tpu_torch/ops/csrc/"
              "pq_scan.cu", "replaces": "raft_tpu/ops/pq_scan_pallas.py:279"}
    entries = []
    for bits, kname, label in ((8, "K5", "pq_scan_list_major"),
                               (4, "K5_4bit", "pq_scan_list_major_4bit")):
        p32, p128 = (report[f"pq{bits}_p{P}"] for P in probes)
        entries.append({
            "name": label, **common,
            "launches": p32["launches"][kname] + p128["launches"][kname],
            **{k: p32["k5"][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            "p128": p128["k5"]})
    entries[0]["serving_launches"] = serve_launches
    print("K5 library_ms: null (no one PyTorch call computes the masked "
          "table-lookup fold)", flush=True)
    return report, entries


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


# ---------------------------------------------------------------- serving
def closed_loop(engine, request, n_requests: int, clients: int,
                think_s: float, seed: int, keep: bool = False,
                go_on=None):
    """``benchmarks/bench_serving.py``'s closed loop: each client takes
    the next request index, submits ``request(i)``, waits for its answer
    and thinks for Exp(``think_s``). Runs ``n_requests`` requests, and
    past them while ``go_on(done)`` is true. Returns (latencies s, errors,
    wall s, {i: (vals, ids)} when ``keep``)."""
    import numpy as np

    lat, errors, answers = [], [], {}
    lock = threading.Lock()
    state = {"next": 0, "done": 0}
    seeds = np.random.default_rng(seed).integers(0, 2 ** 31, clients)

    def client(cid: int):
        rng = np.random.default_rng(seeds[cid])
        while True:
            with lock:
                i = state["next"]
                if i >= n_requests and (go_on is None
                                        or not go_on(state["done"])):
                    return
                state["next"] = i + 1
            t0 = time.perf_counter()
            try:
                vals, ids = engine.submit(request(i)).result(timeout=120)
            except Exception as e:
                with lock:
                    errors.append(f"{type(e).__name__}: {e}"[:200])
                continue
            dt = time.perf_counter() - t0
            with lock:
                lat.append(dt)
                state["done"] += 1
                if keep:
                    answers[i] = (vals, ids)
            if think_s > 0:
                time.sleep(float(rng.exponential(think_s)))

    t_start = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    engine.flush(60)
    return lat, errors, time.perf_counter() - t_start, answers


def serving_phase(res, seed: int = 0):
    """Phase 10 (see the module doc). Returns (the ``serving`` report, the
    launches of each cell's load run: K1 for brute_bf16, K2 for
    brute_int8)."""
    import numpy as np
    import torch
    from raft_tpu_torch.distance.knn_fused import knn_fused
    from raft_tpu_torch.distance import prepare_knn_index
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.serving import ServingEngine

    m, d, k, n_requests, clients = SERVE_SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    Y = torch.randn(m, d, device="cuda", generator=gen)
    rng = np.random.default_rng(seed)
    ladder = (16, 64, 256)        # the default: Qb = 256
    sizes = np.clip(rng.poisson(max(2, ladder[0]), n_requests), 1,
                    ladder[-1])
    blocks = rng.normal(size=(64, ladder[-1], d)).astype(np.float32)

    def request(i):
        return blocks[i % 64, :int(sizes[i % n_requests])]

    report, launches = {}, {}
    for cell, dtype in (("brute_bf16", "bf16"), ("brute_int8", "int8")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = prepare_knn_index(Y, db_dtype=dtype)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        engine = ServingEngine(idx, k=k)
        check(engine.buckets == ladder, f"{cell}: ladder {engine.buckets}")
        t0 = time.perf_counter()
        engine.start()
        warm_s = time.perf_counter() - t0
        try:
            kname = "K2" if dtype == "int8" else "K1"
            k1.LAUNCHES = k1.LAUNCHES_Q8 = 0
            s0 = engine.stats()
            lat, errors, wall, _ = closed_loop(
                engine, request, n_requests, clients, SERVE_THINK_S, seed)
            launches[cell] = (k1.LAUNCHES_Q8 if dtype == "int8"
                              else k1.LAUNCHES)
            s1 = engine.stats()
            check(not errors and len(lat) == n_requests,
                  f"{cell}: {len(errors)} requests failed: {errors[:3]}")
            check(launches[cell] > 0, f"{cell}: serving launched {kname} "
                  f"no time")
            check(s1["builds_after_warmup"] == 0,
                  f"{cell}: {s1['builds_after_warmup']} kernel builds or "
                  f"loads after warm-up")
            batches = s1["batches"] - s0.get("batches", 0)
            # bench_serving's parity probe: every 250th request asked
            # again, and single-shot through knn_fused on the same index;
            # every other probe carries a deadline, so the batch runs in a
            # deadline scope and waits on its polled completion event
            parity = 0
            for n_probe, i in enumerate(range(0, n_requests,
                                              n_requests // 8)):
                q = request(i)
                sv, si = engine.query(
                    q, deadline_s=30.0 if n_probe % 2 else None,
                    timeout=120)
                ov, oi = knn_fused(torch.from_numpy(q).cuda(), idx, k)
                check(np.array_equal(sv, ov.cpu().numpy())
                      and np.array_equal(si, oi.cpu().numpy()),
                      f"{cell}: request {i} served differs from the same "
                      f"query asked single-shot")
                parity += 1
            lat_ms = np.asarray(lat) * 1e3
            row = {
                "index": f"{dtype} p3", "prepare_s": prepare_s,
                "warmup_s": warm_s, "p50_ms": float(np.percentile(lat_ms, 50)),
                "p99_ms": float(np.percentile(lat_ms, 99)),
                "throughput_rps": n_requests / wall,
                "rows_per_s": float(sizes.sum()) / wall,
                "n_requests": n_requests, "errors": len(errors),
                "batches": batches,
                "mean_fill": float(sizes.sum()) / max(1, batches)
                / ladder[-1],
                "padded_rows": s1["padded_rows"] - s0.get("padded_rows", 0),
                "fixups": s1["fixups"] - s0.get("fixups", 0),
                "builds_after_warmup": s1["builds_after_warmup"],
                "warmup_builds": s1["warmup_builds"],
                "launches": {kname: launches[cell]},
                "parity_checked": parity}
            # a short burst under the profiler: device busy and idle share
            row["profile"] = profile_run(lambda: closed_loop(
                engine, request, 300, clients, SERVE_THINK_S, seed + 1))
            if dtype == "bf16":
                row["swap"] = swap_under_load(engine, idx, request, blocks,
                                              sizes, k, seed)
            report[cell] = row
            print(f"serving {cell}: {json.dumps(row)}", flush=True)
        finally:
            engine.stop()
        del engine, idx
        torch.cuda.empty_cache()
    return report, launches


def swap_under_load(engine, idx0, request, blocks, sizes, k: int,
                    seed: int):
    """``update_index`` to a second seeded Y while 8 clients keep
    submitting: each response must equal the single-shot answer of
    exactly one generation. Clients go on until 200 requests were answered
    after the swap landed."""
    import numpy as np
    import torch
    from raft_tpu_torch.distance.knn_fused import knn_fused

    m, d = idx0.n_rows, idx0.d_orig
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    Y2 = torch.randn(m, d, device="cuda", generator=gen)
    torch.cuda.synchronize()
    n_req, clients = 400, SERVE_SHAPE[4]
    gen0 = engine.snapshot.generation
    state = {"swapped_at": None}

    def trigger(i):
        if i == 100:
            engine.update_index(Y2)              # background rebuild
        if (state["swapped_at"] is None
                and engine.snapshot.generation != gen0):
            state["swapped_at"] = i
        return request(i)

    def go_on(done):
        # 200 more answers once the swap has landed (at most 20000)
        at = state["swapped_at"]
        return (at is None or done < at + 200) and done < 20000

    lat, errors, wall, answers = closed_loop(
        engine, trigger, n_req, clients, SERVE_THINK_S, seed + 2,
        keep=True, go_on=go_on)
    engine._store.wait_for_builds(120)
    check(not errors, f"swap: {len(errors)} requests failed: {errors[:3]}")
    check(engine.snapshot.generation == gen0 + 1, "swap: the update did "
          "not land")
    # single-shot answers of every request block, one per generation
    new = engine.snapshot.index
    xq = torch.from_numpy(blocks.reshape(-1, d)).cuda()
    per_gen = []
    for index in (idx0, new):
        v, i = knn_fused(xq, index, k)
        per_gen.append((v.cpu().numpy().reshape(64, -1, k),
                        i.cpu().numpy().reshape(64, -1, k)))
    count = [0, 0]
    for j, (vals, ids) in answers.items():
        n = vals.shape[0]
        hit = [np.array_equal(vals, gv[j % 64, :n])
               and np.array_equal(ids, gi[j % 64, :n])
               for gv, gi in per_gen]
        if not any(hit):
            why = [(float(np.abs(vals - gv[j % 64, :n]).max()),
                    int((ids != gi[j % 64, :n]).sum())) for gv, gi in per_gen]
            fail(f"swap: request {j}'s answer equals neither generation's "
                 f"(max |value diff|, ids differing) per generation: {why}")
        count[0 if hit[0] else 1] += 1
    check(count[1] > 0, "swap: no response came from the new generation")
    return {"requests": len(answers), "old_generation": count[0],
            "new_generation": count[1], "wall_s": wall,
            "rebuild_to_swap_at_request": state["swapped_at"],
            "p99_ms": float(np.percentile(np.asarray(lat) * 1e3, 99))}


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
    """Phases 7–9 (see the module doc) at R-MAT ``scale``, a band matrix of
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

    # ---- phase 7: spectral_g22, the headline ----
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

    # ---- phase 8: spectral_c4, BASELINE config 4 as bench_configs runs it
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

    # ---- phase 9: lanczos_dense, config 3's Lanczos on a Gram operator
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


# ---------------------------------------------------- pairwise and stats
#: FP32 instruction issue rate of the card: 132 SMs × 128 lanes × 1.98 GHz
H100_FP32_RATE = 132 * 128 * 1.98e9
#: the SFU's reciprocal rate, an eighth of the FP32 issue rate
H100_SFU_RATE = H100_FP32_RATE / 8
#: phase 11a/b: bench_unexpanded.py:48-55's shape, and its four metrics
K8_FULL = (2048, 1_000_000, 128)
K8_TIMED = ("l1", "linf", "canberra", "hamming")
#: phase 11e: bench_prims.py:44-46's make_blobs (rows, d, clusters)
STATS_SHAPE = (100_000, 128, 16)


def k8_bound_ms(name: str, n: int, m: int, d: int):
    """Least time for an [n, m] unexpanded distance matrix: the x and y
    rows read and the output written once, against the FP32 instructions
    each of the n·m·d terms needs at the least (l1: FSUB, FADD with |·|;
    linf: FSUB, a NaN-propagating max; hamming: a compare, a predicated
    add) or, for canberra, the one SFU reciprocal of its quotient."""
    terms = n * m * d
    if name == "canberra":
        t_ops = terms / H100_SFU_RATE
    else:
        t_ops = 2.0 * terms / H100_FP32_RATE
    t_bytes = ((n + m) * d * 4 + n * m * 4) / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def k9_bound_ms(n: int, batch: int, n_bins: int):
    """Least time for K9: the bins read and the counts written once."""
    return 1e3 * (n * batch + n_bins * batch) * 4 / H100_BYTES_PER_S, \
        "bytes"


def k8_hold(tag: str, x, y, t, p: float, out, ref, rows: int = 256):
    """K8's ``out`` against its twin's ``ref``: Linf and Hamming bit for
    bit; the others within ``ops.unexpanded.error_bound`` per entry
    (computed in row blocks of ``rows``); non-finite entries equal in
    kind. Returns (max |diff| over finite entries, worst diff/bound)."""
    import torch
    from raft_tpu_torch.distance import DistanceType
    from raft_tpu_torch.ops import unexpanded as k8

    both_nan = out.isnan() & ref.isnan()
    check(bool((out.isnan() == ref.isnan()).all()),
          f"{tag}: NaN entries differ")
    fin = torch.isfinite(ref)
    check(bool(((out == ref) | both_nan | fin).all()),
          f"{tag}: infinite entries differ")
    diff = torch.where(fin, (out - ref).abs(), 0.0)
    if t in (DistanceType.Linf, DistanceType.HammingUnexpanded):
        check(bool((diff == 0).all()), f"{tag}: not bit-identical "
              f"(max |diff| {diff.max().item()})")
        return 0.0, 0.0
    worst = 0.0
    for r0 in range(0, x.shape[0], rows):
        sl = slice(r0, r0 + rows)
        b = k8.error_bound(x[sl], y, t, p, ref[sl])
        d_ = diff[sl]
        ok = (d_ <= b) | ~fin[sl]
        check(bool(ok.all()), f"{tag}: kernel and twin differ beyond the "
              f"bound (max diff/bound "
              f"{float((d_ / b.clamp_min(1e-30))[fin[sl]].max())})")
        worst = max(worst, float(torch.where(
            fin[sl] & (b > 0), d_ / b.clamp_min(1e-30), 0.0).max()))
    torch.cuda.synchronize()
    return diff.max().item(), worst


def _k8_inputs(x, y, name):
    """KL/JS take non-negative, row-normalised inputs."""
    if name in ("kl_divergence", "jensenshannon"):
        x, y = x.abs(), y.abs()
        return x / x.sum(1, keepdim=True), y / y.sum(1, keepdim=True)
    return x, y


K8_METRICS = ("l1", "linf", "sqeuclidean_unexpanded", "euclidean_unexpanded",
              "minkowski", "canberra", "hamming", "braycurtis",
              "kl_divergence", "jensenshannon")


def _k8_type(name):
    from raft_tpu_torch.distance import METRIC_NAMES, DistanceType

    return {"sqeuclidean_unexpanded": DistanceType.L2Unexpanded,
            "euclidean_unexpanded": DistanceType.L2SqrtUnexpanded
            }.get(name) or METRIC_NAMES[name]


def k8_versus_twin(tag: str, x, y, workspace: int = 4 << 30):
    """All ten metrics through K8 and its twin on (x, y); Minkowski at
    p = 3. Returns {metric: {max_abs_err, worst_ratio}}."""
    import torch
    from raft_tpu_torch.ops import unexpanded as k8

    rows = {}
    for name in K8_METRICS:
        t, p = _k8_type(name), 3.0
        xs, ys = _k8_inputs(x, y, name)
        if name == "hamming":
            xs, ys = xs.round(), ys.round()
        out = k8.unexpanded_pairwise_tiled(xs, ys, t, p)
        ref = k8.unexpanded_pairwise_tiled_ref(xs, ys, t, p, workspace)
        err, worst = k8_hold(f"K8 {tag} {name}", xs, ys, t, p, out, ref)
        rows[name] = {"max_abs_err": err, "worst_diff_over_bound": worst}
        del out, ref
    torch.cuda.empty_cache()
    print(f"K8 vs twin {tag} {tuple(x.shape)} × {tuple(y.shape)}: "
          f"{json.dumps(rows)}", flush=True)
    return rows


def pairwise_stats_phase(res, full=K8_FULL, check_rows: int = 256,
                         stats_shape=STATS_SHAPE, hist_rows: int = 1_000_000,
                         trust_n: int = 5000):
    """Phase 11 (see the module doc): K8 against its twin at ``check_rows``
    × full[1] × full[2] and at config 1's shape, K8 timed at ``full``, config
    1, K9 against its twin and ``torch.bincount``, and the stats path on
    make_blobs ``stats_shape``. Returns (the ``pairwise_stats`` report,
    the K8/K9 ``kernels`` entries)."""
    import numpy as np
    import torch
    from raft_tpu_torch import stats
    from raft_tpu_torch.distance import DistanceType, pairwise_distance
    from raft_tpu_torch.models import KMeans
    from raft_tpu_torch.ops import histogram as k9
    from raft_tpu_torch.ops import unexpanded as k8
    from raft_tpu_torch.random import make_blobs

    report = {}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    n_full, m_full, d_full = full
    Y = torch.randn(m_full, d_full, device="cuda", generator=gen)

    # ---- 11a: K8 against its twin, all ten metrics ----
    n0 = k8.LAUNCHES
    checks = {"main": k8_versus_twin("main", Y[:check_rows], Y)}
    Xc, _ = make_blobs(res, 0, 5000, 50, n_clusters=8)
    checks["config1"] = k8_versus_twin("config1", Xc, Xc[:1000])
    xo = torch.randn(333, 61, device="cuda", generator=gen)
    yo = torch.randn(4097, 61, device="cuda", generator=gen)
    checks["odd"] = k8_versus_twin("odd", xo, yo)
    xo[3, 5], xo[7, 0], xo[9, 60] = float("inf"), float("-inf"), float("nan")
    yo[11, 2], yo[12, 40] = float("nan"), float("inf")
    yo[13] = float("inf")
    checks["nonfinite"] = k8_versus_twin("nonfinite", xo, yo)
    del xo, yo
    k8.LAUNCHES = n0                  # comparison launches do not count
    max_err = max(r["max_abs_err"] for c in checks.values()
                  for r in c.values())
    report["k8_checks"] = checks

    # ---- 11b: K8 at full width, timed ----
    Xf = Y[:n_full]
    k8_rows = {}
    for name in K8_TIMED:
        t = _k8_type(name)
        xs, ys = (Xf.round(), Y.round()) if name == "hamming" else (Xf, Y)
        out = k8.unexpanded_pairwise_tiled(xs, ys, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = k8.unexpanded_pairwise_tiled_ref(xs, ys, t, 2.0, 4 << 30)
        torch.cuda.synchronize()
        plain = 1e3 * (time.perf_counter() - t0)
        err, worst = k8_hold(f"K8 full {name}", xs, ys, t, 2.0, out, ref,
                             rows=128)
        del out
        p_lib = {"l1": 1.0, "linf": float("inf"), "hamming": 0.0}.get(name)
        lib_fn = None if p_lib is None else (
            lambda: torch.cdist(xs, ys, p=p_lib) / d_full if name == "hamming"
            else torch.cdist(xs, ys, p=p_lib))
        if name == "hamming":
            lib_err = lib_fn().sub_(ref).abs_().max().item()
            check(lib_err <= 2.0 ** -24, f"cdist(p=0) / d off the hamming "
                  f"twin by {lib_err}")
        del ref
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: k8.unexpanded_pairwise_tiled(xs, ys, t), 3)
        bound, by = k8_bound_ms(name, n_full, m_full, d_full)
        lib = None if lib_fn is None else library_ms(lib_fn, 2)
        k8_rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                         "bound_by": by, "library_ms": lib,
                         "max_abs_err": err, "worst_diff_over_bound": worst}
        if name == "hamming":
            k8_rows[name]["library_call"] = "torch.cdist(p=0) / d"
            k8_rows[name]["library_max_abs_diff_vs_twin"] = lib_err
        if lib is None:
            k8_rows[name]["library_null"] = (
                "no PyTorch call computes this metric")
        torch.cuda.empty_cache()
        print(f"K8 at {n_full} × {m_full} × {d_full} {name}: "
              f"{json.dumps(k8_rows[name])}", flush=True)
    k8.LAUNCHES = n0
    del Xf

    # ---- 11c: BASELINE config 1, pairwise_distance(res, X, X[:1000]) ----
    c1 = {}
    Xq = Xc[:1000]
    x64, q64 = Xc.double(), Xq.double()
    for metric, p_ in (("euclidean", 2.0), ("l1", 1.0)):
        k8.LAUNCHES = 0
        out = pairwise_distance(res, Xc, Xq, metric=metric)
        torch.cuda.synchronize()
        launches = k8.LAUNCHES
        exact = torch.cdist(x64, q64, p=p_)
        if metric == "euclidean":
            e2 = 4 * (Xc.shape[1] + 2) * 2.0 ** -24 * (
                (x64 * x64).sum(1)[:, None] + (q64 * q64).sum(1)[None, :])
            bound = e2 / torch.maximum(exact, e2.sqrt()) + 2.0 ** -23 * exact
        else:
            bound = (Xc.shape[1] + 2) * 2.0 ** -24 * exact
        diff = (out.double() - exact).abs()
        check(bool((diff <= bound).all()), f"config1 {metric}: off the f64 "
              f"cdist by {diff.max().item()}")
        times = []
        for _ in range(21):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pairwise_distance(res, Xc, Xq, metric=metric)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = 1e3 * statistics.median(times[1:])
        c1[metric] = {"ms": ms, "gbps": 5000 * 1000 * 4 / (ms * 1e-3) / 1e9,
                      "device_ms": cuda_ms(lambda: pairwise_distance(
                          res, Xc, Xq, metric=metric), 20),
                      "k8_launches": launches,
                      "max_abs_err_vs_f64": diff.max().item()}
    check(c1["l1"]["k8_launches"] == 1 and c1["euclidean"]["k8_launches"]
          == 0, f"config1: K8 launches {c1}")
    bound, by = k8_bound_ms("l1", 5000, 1000, 50)
    lib = library_ms(lambda: torch.cdist(Xc, Xq, p=1.0), 20)
    c1["l1"].update({"bound_ms": bound, "bound_by": by, "library_ms": lib})
    k8.LAUNCHES = 0
    report["config1"] = c1
    print(f"config1 5000 × 1000 × 50: {json.dumps(c1)}", flush=True)
    del Xc, Xq, x64, q64

    # ---- 11d: K9 against its twin and torch.bincount ----
    def k9_case(tag, bins, n_bins):
        n, batch = bins.shape
        flat = (torch.arange(batch, device="cuda")[None, :] * n_bins
                + bins).reshape(-1)
        out = k9.histogram_blocked(bins, n_bins)
        ref = k9.histogram_blocked_ref(bins, n_bins)
        lib = torch.bincount(flat, minlength=batch * n_bins).reshape(
            batch, n_bins).T.to(torch.int32)
        check(torch.equal(out, ref) and torch.equal(out, lib),
              f"K9 {tag}: counts differ from the twin or bincount")
        bound, by = k9_bound_ms(n, batch, n_bins)
        row = {"shape": [n, batch, n_bins],
               "ms": cuda_ms(lambda: k9.histogram_blocked(bins, n_bins), 20),
               "plain_ms": cuda_ms(
                   lambda: k9.histogram_blocked_ref(bins, n_bins), 3),
               "bound_ms": bound, "bound_by": by,
               "library_ms": library_ms(lambda: torch.bincount(
                   flat, minlength=batch * n_bins), 20),
               "max_abs_err": 0}
        print(f"K9 {tag}: {json.dumps(row)}", flush=True)
        return row

    n0 = k9.LAUNCHES
    k9_rows = {"bench_prims": k9_case("bench_prims", torch.randint(
        0, 64, (100_000, 8), device="cuda", generator=gen,
        dtype=torch.int32), 64)}
    n_s, d_s, k_s = stats_shape
    Xs, truth = make_blobs(res, 0, n_s, d_s, n_clusters=k_s)
    vals = Xs.reshape(-1)
    vh = stats.value_histogram(res, vals, 64)
    lo, hi = vals.min(), vals.max()
    vbins = ((vals - lo) / ((hi - lo) / 64)).to(torch.int32).clamp(0, 63)
    check(torch.equal(vh, torch.bincount(vbins, minlength=64).to(
        torch.int32)), "value_histogram differs from torch.bincount")
    k9_rows["value_histogram"] = k9_case("value_histogram",
                                         vbins[:, None].contiguous(), 64)
    colb = ((Y[:hist_rows] + 4.0) * 8.0).to(torch.int32).clamp(0, 63)
    k9_rows["main"] = k9_case("columns", colb, 64)
    # more column slabs (12 columns each at 1024 bins) than grid rows
    wide = torch.randint(-3, 1030, (3, 65537 * 12 - 7), device="cuda",
                         generator=gen, dtype=torch.int32)
    check(torch.equal(k9.histogram_blocked(wide, 1024),
                      k9.histogram_blocked_ref(wide, 1024)),
          f"K9 at {tuple(wide.shape)}, 1024 bins: counts differ from the twin")
    del wide
    via = stats.histogram(res, Y[:hist_rows], 64,
                          binner=lambda v, row: ((v + 4.0) * 8.0).to(
                              torch.int32))
    check(torch.equal(via, k9.histogram_blocked_ref(colb, 64)),
          "stats.histogram with a binner differs from K9's twin")
    k9.LAUNCHES = n0
    del colb, via, vbins, vals, Y
    torch.cuda.empty_cache()

    # ---- 11e: the stats path end to end, counts zeroed just before ----
    # K8 at the l1 silhouette's own chunk shapes, held to its twin first
    last = n_s - (n_s - 1) // 1024 * 1024
    sil_chunks = {}
    for tag, q in (("first", Xs[:1024]), ("last", Xs[n_s - last:])):
        out = pairwise_distance(res, q, Xs, metric="l1")
        ref = k8.unexpanded_pairwise_tiled_ref(q, Xs, DistanceType.L1, 2.0,
                                               4 << 30)
        err, worst = k8_hold(f"K8 silhouette chunk {tag}", q, Xs,
                             DistanceType.L1, 2.0, out, ref)
        sil_chunks[tag] = {"rows": q.shape[0], "max_abs_err": err,
                           "worst_diff_over_bound": worst}
        del out, ref
    checks["silhouette_l1_chunks"] = sil_chunks
    max_err = max(max_err, *(r["max_abs_err"] for r in sil_chunks.values()))
    print(f"K8 vs twin at the silhouette chunks: {json.dumps(sil_chunks)}",
          flush=True)
    k8.LAUNCHES = k9.LAUNCHES = 0
    torch.cuda.synchronize()
    t_path = time.perf_counter()
    path = {}
    mu, var = stats.meanvar(res, Xs)
    lo_, hi_ = stats.minmax(res, Xs)
    C = stats.cov(res, Xs, stable=True)
    x64 = Xs.double()
    mom_err = max(float((a.double() - b).abs().max() / b.abs().max())
                  for a, b in ((mu, x64.mean(0)),
                               (var, x64.var(0, correction=0)),
                               (C, torch.cov(x64.T))))
    check(mom_err <= 1e-4 and torch.equal(lo_, Xs.amin(0))
          and torch.equal(hi_, Xs.amax(0)),
          f"moments off the f64 evaluation by {mom_err} (relative)")
    path["moments_max_rel_err_vs_f64"] = mom_err
    t0 = time.perf_counter()
    km = KMeans(k_s, res=res).fit(Xs)
    torch.cuda.synchronize()
    path["kmeans_fit_s"] = time.perf_counter() - t0
    path["kmeans_inertia"] = km.inertia_
    path["kmeans_n_iter"] = km.n_iter_
    labels = km.labels_
    path["ari"] = stats.adjusted_rand_index(res, truth, labels)
    path["v_measure"] = stats.v_measure(res, truth, labels)
    cm = np.zeros((k_s, k_s))
    np.add.at(cm, (truth.cpu().numpy(), labels.cpu().numpy()), 1)

    def c2(v):
        return v * (v - 1) / 2.0

    sc, ca, cb = c2(cm).sum(), c2(cm.sum(1)).sum(), c2(cm.sum(0)).sum()
    ari_np = (sc - ca * cb / c2(n_s)) / (0.5 * (ca + cb) - ca * cb / c2(n_s))
    check(abs(path["ari"] - ari_np) <= 1e-12 and 0.0 <= path["v_measure"]
          <= 1.0 + 1e-12, f"ari {path['ari']} against numpy {ari_np}")
    h = stats.histogram(res, labels, k_s)
    check(torch.equal(h, torch.bincount(labels.long(), minlength=k_s).to(
        torch.int32)), "histogram of the labels differs from bincount")
    for metric in ("sqeuclidean", "l1"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s32 = stats.silhouette_score_batched(res, Xs, labels, metric=metric)
        sec = time.perf_counter() - t0
        s64 = stats.silhouette_score_batched(res, x64, labels, metric=metric)
        check(abs(s32 - s64) <= 1e-4, f"silhouette {metric}: {s32} against "
              f"f64 {s64}")
        path[f"silhouette_{metric}"] = {"value": s32, "f64": s64, "s": sec}
    P = torch.randn(d_s, 16, device="cuda", generator=gen) / 4.0
    E = Xs[:trust_n] @ P
    tw = stats.trustworthiness_score(res, Xs[:trust_n], E, 5)
    tw64 = stats.trustworthiness_score(res, x64[:trust_n], E.double(), 5)
    check(abs(tw - tw64) <= 1e-4 and 0.0 <= tw <= 1.0,
          f"trustworthiness {tw} against f64 {tw64}")
    path["trustworthiness"] = {"value": tw, "f64": tw64}
    torch.cuda.synchronize()
    path["wall_s"] = time.perf_counter() - t_path
    path["launches"] = {"K8": k8.LAUNCHES, "K9": k9.LAUNCHES}
    check(k8.LAUNCHES > 0 and k9.LAUNCHES > 0,
          f"the stats path launched K8 {k8.LAUNCHES}, K9 {k9.LAUNCHES} times")
    report["stats_path"] = path
    print(f"stats path: {json.dumps(path)}", flush=True)
    del Xs, x64, E

    main8 = k8_rows["l1"]
    k8_entry = {"name": "unexpanded_pairwise_tiled", "route": "cuda",
                "source": "raft_tpu_torch/ops/csrc/unexpanded.cu",
                "replaces": "raft_tpu/ops/unexpanded_pallas.py:261",
                "launches": path["launches"]["K8"],
                **{k: main8[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                "max_abs_err": max_err, "shape": list(full),
                "metrics": {k: v for k, v in k8_rows.items() if k != "l1"},
                "config1_l1": c1["l1"]}
    main9 = k9_rows["main"]
    k9_entry = {"name": "histogram_blocked", "route": "cuda",
                "source": "raft_tpu_torch/ops/csrc/histogram.cu",
                "replaces": "raft_tpu/ops/histogram_pallas.py:47",
                "launches": path["launches"]["K9"],
                **{k: main9[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "max_abs_err", "shape")},
                "bench_prims": k9_rows["bench_prims"],
                "value_histogram": k9_rows["value_histogram"]}
    report["k8"], report["k9"] = k8_rows, k9_rows
    return report, [k8_entry, k9_entry]


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
    from raft_tpu_torch.ops import histogram as k9
    from raft_tpu_torch.ops import pq_scan as k5
    from raft_tpu_torch.ops import unexpanded as k8
    from raft_tpu_torch.random import make_blobs

    t_start = time.perf_counter()
    # ---- phase 1: device and build ----
    card = gpu_name_power()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["fused_l2_topk", "fine_scan", "pq_scan", "spmv",
                      "sddmm", "unexpanded", "histogram"])
    k1._launcher()
    k1._launcher_q8()
    k4._launcher()
    k5._launcher()
    _build.load("spmv")
    _build.load("sddmm")
    k8._launcher()
    k9._launcher()
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

    # K2 against its twin: 4 whole groups of int8 rows, quantized as
    # prepare_knn_index(db_dtype="int8") does, with a padded tail
    from raft_tpu_torch.distance.knn_fused import _prepare_ops_q8

    Q2 = 256
    x = torch.randn(Q2, d, device="cuda", generator=gen)
    y = 2.0 * torch.randn(4 * g * T, d, device="cuda", generator=gen) + 0.5
    _, y_q, scales, yyh, _, _ = _prepare_ops_q8(y, T, g, "l2")
    yyh[-100:] = k1._PACK_PAD
    xxh = 0.5 * (x * x).sum(1)
    for passes in (1, 3):
        for pair in (False, True):
            n0 = k1.LAUNCHES_Q8
            kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits,
                      xxh=xxh)
            out = k1.fused_l2_group_topk_packed_q8(x, y_q, yyh, scales, **kw)
            torch.cuda.synchronize()
            check(k1.LAUNCHES_Q8 == n0 + 1, "K2 launch was not counted")
            ref = k1.fused_l2_group_topk_packed_q8_ref(x, y_q, yyh, scales,
                                                       **kw)
            err, n_diff = compare_k2(out, ref, x, y_q, scales, yyh, xxh, T,
                                     g, passes, pbits, pair)
            print(f"K2 vs twin Q={Q2} M={y_q.shape[0]} d={d} "
                  f"passes={passes} pair={pair}: max_abs_err={err} "
                  f"tie_slots={n_diff}", flush=True)
    del x, y, y_q, scales, yyh, xxh, out, ref

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
    t0 = time.perf_counter()
    idx8_1 = distance.prepare_knn_index(X, passes=1, db_dtype="int8")
    idx8_3 = distance.prepare_knn_index(X, passes=3, db_dtype="int8")
    res.sync()
    print(f"prepare int8 (p1 + p3): {time.perf_counter() - t0:.3f} s; "
          f"M={idx8_1.prepared_rows} groups={idx8_1.scales.numel()} "
          f"Eq max={idx8_1.eq_groups.max().item()}", flush=True)
    o_vals, o_ids = exact_oracle(X, Qx, K)

    runs = {"p1": (idx1, "kernel"), "p3": (idx3, "kernel"),
            "p1_f32": (idx1, "f32"), "int8_p1": (idx8_1, "kernel"),
            "int8_p3": (idx8_3, "kernel")}
    main_path, launches = {}, {}
    for name, (index, certify) in runs.items():
        kname = "K2" if index.db_dtype == "int8" else "K1"
        k1.LAUNCHES = k1.LAUNCHES_Q8 = 0
        vals, ids = distance.knn(res, index, Qx, k=K, certify=certify)
        torch.cuda.synchronize()
        launches[name] = k1.LAUNCHES_Q8 if kname == "K2" else k1.LAUNCHES
        check(launches[name] > 0, f"{name}: the main path launched "
              f"{kname} no time")
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
                           "kernel": kname, "launches": launches[name],
                           **quality}
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
                     "launches": sum(launches[n] for n in ("p1", "p3",
                                                           "p1_f32")),
                     **row}
        else:
            entry["p3"] = row
        print(f"K1 at the main path, passes={index.passes} pair={pair}: "
              f"{json.dumps(row)}", flush=True)
    torch.cuda.synchronize()

    # ---- K2 on the main path's own inputs: twin, times, bound ----
    k2_entry = None
    for index, pair in ((idx8_1, True), (idx8_3, False)):
        kw = dict(T=index.T, g=index.g, passes=index.passes, pair=pair,
                  pbits=index.pbits, xxh=xxh)
        args = (xq, index.y_q, index.yyh_k, index.scales)
        n0 = k1.LAUNCHES_Q8
        out = k1.fused_l2_group_topk_packed_q8(*args, **kw)
        ref = k1.fused_l2_group_topk_packed_q8_ref(*args, **kw)
        err, n_diff = compare_k2(out, ref, xq, index.y_q, index.scales,
                                 index.yyh_k, xxh, index.T, index.g,
                                 index.passes, index.pbits, pair)
        del out, ref
        ms = cuda_ms(lambda: k1.fused_l2_group_topk_packed_q8(*args, **kw),
                     10)
        plain_ms = cuda_ms(
            lambda: k1.fused_l2_group_topk_packed_q8_ref(*args, **kw), 3)
        k1.LAUNCHES_Q8 = n0          # comparison launches do not count
        M8 = index.prepared_rows
        S8 = M8 // (index.g * index.T) * 128
        bound, bound_by = k2_bound_ms(N_QUERIES, M8, index.stream_width,
                                      S8, index.passes)
        xb, qb = xq.to(torch.bfloat16), index.y_q.to(torch.bfloat16)
        lib_ms = cuda_ms(lambda: torch.matmul(xb, qb.T), 10)
        del qb
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by, "library_ms": lib_ms,
               "max_abs_err": err, "tie_slots": n_diff,
               "launches_per_batch": launches[f"int8_p{index.passes}"]}
        if index.passes == 1:
            k2_entry = {
                "name": "fused_l2_group_topk_packed_q8", "route": "cuda",
                "source": "raft_tpu_torch/ops/csrc/fused_l2_topk.cu",
                "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:1465",
                "launches": launches["int8_p1"] + launches["int8_p3"],
                **row}
        else:
            k2_entry["p3"] = row
        print(f"K2 at the main path, passes={index.passes} pair={pair}: "
              f"{json.dumps(row)}", flush=True)
    torch.cuda.synchronize()

    for name, (index, certify) in runs.items():
        br = profile_run(lambda: distance.knn(res, index, Qx, k=K,
                                              certify=certify))
        print(json.dumps({"profile": name, **br}), flush=True)
    bounds = unported_bounds_ms(N_QUERIES, Mi, index.stream_width, S,
                                index.T)
    del X, Qx, idx1, idx3, idx8_1, idx8_3, o_vals, o_ids
    torch.cuda.empty_cache()

    # ---- phase 10 (run here, on a fresh index): serving ----
    serving, serve_launches = serving_phase(res)
    entry["serving_launches"] = serve_launches["brute_bf16"]
    k2_entry["serving_launches"] = serve_launches["brute_int8"]
    torch.cuda.empty_cache()

    # ---- phases 4–6: K4 against its twin, IVF-Flat, then IVF-PQ ----
    data = ann_data(res, N_INDEX, N_QUERIES)
    ivf, k4_entries = ivf_phase(res, N_INDEX, N_QUERIES, IVF_LISTS,
                                data=data)
    torch.cuda.empty_cache()
    ivf_pq, k5_entries = pq_phase(res, data, IVF_LISTS)
    del data
    torch.cuda.empty_cache()

    # ---- phases 7–9: the spectral path ----
    spectral, sparse_entries = spectral_phase(res)
    torch.cuda.empty_cache()

    # ---- phase 11: pairwise distances and stats ----
    pairwise_stats, k89_entries = pairwise_stats_phase(res)
    print(json.dumps({"bounds_unported_ms": bounds}), flush=True)
    print(json.dumps({"main_path": main_path}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"ivf": ivf}), flush=True)
    print(json.dumps({"ivf_pq": ivf_pq}), flush=True)
    print(json.dumps({"spectral": spectral}), flush=True)
    print(json.dumps({"pairwise_stats": pairwise_stats}), flush=True)
    print(f"wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": [entry, k2_entry, *k4_entries,
                                  *k5_entries, *sparse_entries,
                                  *k89_entries]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
