#!/usr/bin/env python3
"""Smoke run of the PyTorch port (raft_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

1. Device and build: the card's name and power limit, then every CUDA
   kernel of the port built from the sources in this checkout; every
   instance of the wgmma kernels (K1, K2, K1's d-chunked form and K1's
   two slot forms) must build without a spill (``ptxas_packed``), the
   fold's SASS instructions a score are counted (``sass_fold_ops``), and
   ``fused_l2_topk.cu`` (the unpacked forms) must export no slot entry
   point; so must every instance of K4 and K7 build without a spill
   (``ptxas_fatal``: K4's scan at f32 and int8 and its merge, K7's ten).
2. K1 against its plain PyTorch twin on the card, at d = 128 and d = 512
   (the resident envelope's edge), Q=500 (not a whole number of the
   kernel's 128-query blocks) × M = 65 tiles of 2048 rows (a partial last
   group) with a padded tail, for passes {1, 3} × pair {False, True};
   then K2 (K1 over an int8 database) against its twin at Q=300 × 4
   groups of 16 × 2048 rows at both widths, the same four modes
   (``k1_k2_twins``): values (code bits cleared) within the f32
   summation bound (d + 2)·2⁻²⁴·Σ|x||ŷ| plus the norm terms' roundings and
   two units of the packing truncation; a slot's code may differ only
   where the two rows it names score within that bound (a tie, proven in
   f64). Then K1 and K2 once more (``nonfinite_k1_k2``, the same shapes and
   eight modes) with +inf, −inf and NaN planted in three query rows and
   three index rows (K2: in the rows' half-norm carrier) and a −inf
   carrier in chunk 0: every slot is NaN, +inf or −inf exactly where the
   twin's is (the merge's min/max propagate NaN), and the finite slots
   hold the bound above, taken over the finite rows (Q=500). Then K1's slot forms
   (``nonfinite_slot``) with the same planted rows, a −inf norm and a
   padded tail: the resident form at passes 1/3 × mask × track, the
   d-chunked form at d = 768, held by ``compare_slot`` (m1 and m2min
   equal in kind and within K1's f32 bound for d2, ids equal but at
   ties proven in f64). Then K1's d-chunked form (``dchunk_twins``) at
   (d, Q) = (640, 300) and (1024, 550) (``DCHUNK_TWINS``: the launcher's
   every geometry, queries resident or streamed × clusters of 1 and 2,
   the last cluster completed by a block that stores nothing) × 40 tiles
   with a padded tail and ±inf/NaN planted, passes × pair, held like
   ``nonfinite_k1_k2``. Last, ``inf_row_knn``: ``knn_fused`` end to end
   over a 65,536 × 128 index holding a +inf and a −inf row, 64 queries,
   k = 16, bf16 (K1) and int8 (K2) at passes 1 and 3: every query fails
   the certificate, and the answer (the ±inf rows first with NaN, as the
   reference's top_k ranks them) equals the same call on the CPU (the
   plain twins), ids exactly and values within 1e-5, NaN in place.
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
   printed. Last, the reference's K1 stage ladder (``k1_ladder``,
   ``benchmarks/profile_fused.py:146-165``) on these operands: the slot
   form (T = 2048) held against its twin at p1, p3 and min-only, then,
   with its count zeroed before and read after, packed K1 at p1/p3, the
   unpacked group form at p1/p3, the slot form at p1/p3 and its min-only
   fold timed by CUDA events beside their bounds and ``torch.matmul`` in
   bf16 of the same product: how K1's time splits between the
   contraction and the fold.
4. K4 (the list-major IVF fine scan, f32 and int8: its two template
   instances) against its plain twin on the card, on one real schedule:
   the first 256 queries of the IVF phase's batch at P=32, on the f32 and
   then the int8 index; then once more with NaN/±inf planted in three
   query rows and (f32) in three probed slab rows (``k4_nonfinite``): no
   NaN in either side's a1, a2 or a3, no planted row pooled; then on a
   schedule built for the work plan's edges (``k4_edge_case``): ragged
   member batches (256 members of the largest list, 33 of the second, 5
   of the smallest, 1 of another) and an empty list. Values within twice
   ``ops.fine_scan.sum_bound(d)``·(‖x‖ + max‖y‖)² (both sides sum the
   reference's bf16 hi/lo terms in f32, in other orders), ids equal on ≥
   99.9% of slots.
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
   prints recall@10, reruns, the host-clock median of 3 calls, launches
   per batch, and K4 timed on the run's own inputs beside its twin and
   its bound: its wrapper (CUDA events) and its scan and merge kernels
   alone under torch.profiler (``kernel_ms``, what the speed guard
   holds). serve_ivf_flat: an ``ivf_flat`` engine over the f32 index at
   P=32 under the fine-scan chooser, 300 requests with phase 6d's recipe,
   parity probes bit-identical to ``search_ivf_flat`` single-shot, 0
   builds after warm-up, p50/p99 and requests/s.
6. IVF-PQ on phase 5's data and lists: ``build_ivf_pq`` (max_iter=8,
   seed=3, pq_dim 32) at 8 and 4 bits, the build seconds split into
   coarse, codebooks and encode. (a) K5 against its twin on real
   schedules (the first 64 queries at P=32 and P=128) at depths 2, 4 and
   8, 8- and 4-bit: pool values bit for bit, rows equal except at exact
   ties. (b) pq8_p32,
   pq8_p128, pq4_p32, pq4_p128: ``search_ivf_pq(pq_scan="pq")`` with the
   counts zeroed just before and read just after; recall@10, the
   certificate rungs (certified, widened, exact rerun), id sets identical
   to ``pq_scan="flat"`` over the same probes up to proven ties (a hard
   check), the host-clock median of 3, K5 on the run's own inputs (CUDA
   events, beside its bound and, at P=32, its twin; depth 2 also alone
   under torch.profiler, ``kernel_ms``, what the speed guard holds) at
   every rung (depth 2, 4, 8) with each rung's launches in the run
   (``LAUNCHES_DEPTH``),
   on a ``k5`` line of its own beside the modelled lookup ceiling
   (``k5_lookup_ms``, not a measurement), the chooser's pick under
   ``auto`` and one profiled call. (d) serve_ivf_pq: an ``ivf_pq``
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
   twin. K6a (``k6a_case``: its y from a NaN-filled allocation, since
   whole row tiles are stored, not added) and K6c (``linalg.spmm`` at V =
   16 and 128) are held against their twins on that layout, with the
   bound (nnz_i + 2)·2⁻²⁴·Σ|a||x| per row, and timed beside the twin, the
   bound, K6a's own layout traffic and cuSPARSE's call
   (``torch.sparse_csr_tensor @``). K7 (``linalg.sddmm``, d = 64) runs on
   the scale-22 adjacency's CSR structure in entry order (its CSR form:
   indptr, no expanded rows; B column-major, as a caller holding Bᵀ
   passes it), is held to (d + 2)·2⁻²⁴·Σ|a·b| in CSR and entry form and
   timed (CUDA events; alone under torch.profiler) beside
   ``torch.sparse.sampled_addmm``, its entry form and a row-major B (the
   transpose of B included), and is timed again over the same entries in
   the (row tile × column tile) order of a TiledPairs layout (16384 ×
   16384 and 256 × 512), held there too. ``k7_checks``: a 50,000-row structure with empty rows, a
   row of 5000 entries and a partial last warp, in CSR and shuffled entry
   form at d = 64, 3, 200 and 512, and a structure whose row ends stop
   short of its entries (the CSR form must end and give those NaN). K7's
   modelled gather floor (one B row an entry from HBM, not a measurement)
   prints on a line of its own, outside the ``kernels`` line. K6b
   runs a Lanczos solve over the pair layout of a band matrix (n = 2²⁰,
   |i − j| ≤ 16, 34.6 M nonzeros) and is held and timed the same way.
   Then ``k6_checks``, each case against its twin within the same bound
   and timed: K6a, then K6c at V = 33 (scalar lanes) and 512 (the
   envelope's edge), on a scale-18 R-MAT Laplacian; K6a, then K6c at V =
   128 and 33, on a 2¹⁸-row matrix whose row tile 0 holds 129 chunks (its
   work items split and add with global atomics) and whose row tile 5 is
   empty (it must read 0, from a NaN-filled allocation); K6b on the band of half-width 1 (runs
   of 3) and on a scale-16 R-MAT under ``layout="pairs"`` (runs of 1).
   A line of its own prints the first designs' times (one block a
   chunk) beside this run's: constants recorded from an earlier full run
   of this script on an H100 80GB HBM3 at 700 W, not measured here and
   not part of the ``kernels`` line.
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
   values), on per-column bins of the 1,000,000 × 128 matrix (64
   bins) and on the stats path's labels (100,000 × 1, 16 bins), each
   timed (its wrapper by CUDA events, the kernel alone by torch.profiler,
   ``kernel_ms``) beside the twin, the bound and ``torch.bincount``, its
   form (``ops.histogram.k9_form``) equal to the one the source picks;
   and, untimed, at 3 × 786,437 bins (1024 bins), whose 65,537 column
   slabs are more than a grid's 65,535 rows.
   (e) The stats path on make_blobs 100,000 × 128 (16 clusters,
   ``bench_prims.py:44-46``), the K8/K9 counts zeroed just before and read
   after (both must be > 0), and first, outside the counts, K8 held to its
   twin at the silhouette's chunks (the first 1,024 and the last 672 rows
   against all 100,000, l1, where d = 128 leaves a ragged 32-column
   tile; the first chunk, the path's launch shape, is also timed beside
   its bound): moments (relative 1e-4 of f64), ``KMeans(16)
   .fit``, ARI (equal to a numpy evaluation to 1e-12) and V-measure
   against the true labels, ``stats.histogram`` of the labels (K9, equal
   to ``torch.bincount``), ``silhouette_score_batched`` with sqeuclidean
   and l1 (K8, 98 chunks of 1024 × 100,000 × 128), each within 1e-4 of
   the same call in f64, and trustworthiness at n = 5,000 against a
   seeded 128 → 16 projection, within 1e-4 of f64.
12. select_k and K3 (``select_k_phase``). (a) K3 (``ops.select_slotted``)
   against its twin at 256 × 1,048,576 N(0, 1) with tpg 4 and 1, at
   ``bench_prims.py:80-88``'s make_blobs 100,000 × 128 (16 clusters)
   reshaped to [1562, 8192], and at a ragged 37 × 70,001 with ±inf and
   NaN planted (tpg 4 and 1): bit for bit on every slot where the twin is
   not NaN, NaN exactly where it is. (b) ``select_k(algo=SLOTTED)`` at
   ``select_k_matrix.py:64-82``'s largest cells, [256, 1,048,576] with
   k ∈ {16, 64, 256} (k = 256 takes tpg 1) and [64, 10,485,760] with
   k = 64, the K3 count zeroed before each and read after (> 0): values
   equal to ``torch.topk``'s exactly, ids naming those values once each;
   the rows that failed the certificate, the host-clock median of five,
   K3 alone (CUDA events) beside its bound (bytes), its twin and
   ``torch.topk`` of the same [B, L, k] (the path's library time; K3's
   own ``library_ms`` is null: no PyTorch call computes the packed
   fold). (c) BITONIC, CHUNKED and RADIX once each at [256, 1,048,576],
   k = 64, equal to ``torch.topk``. (d) AUTO (``XLA_TOPK``, in
   ``jax.lax.top_k``'s order) on [256, 1,048,576] integer rows from
   0..3 with ±0, ±inf and ±NaN planted, k ∈ {16, 64, 256}, select_min
   either way: values and ids equal to ``core.kvp.smallest_by_key``'s bit
   for bit; then AUTO timed there and on N(0, 1) rows (host median of
   five). (e) select_min=False on rows with exact ties, ±0, ±inf, +NaN
   and −NaN (``signed_select_checks``), the card against the same call on
   the CPU, ids and value bits: ``select_k_slotted`` through K3 and the
   slot fold, its certified fallback, AUTO, and the streamed ip sweep's
   merge and sweep.
13. Wide and unpacked brute-force KNN (``wide_knn_phase``). wide_knn:
   ann-benchmarks' gist-960-euclidean shape as make_blobs 1,000,000 × 960
   (64 clusters, std 2.0), the first 1,000 rows as queries, k = 100;
   ``distance.knn`` on prepared indexes at p1 (recall ≥ 0.99), p3 and p1
   with ``certify="f32"``, and a ``db_dtype="int8"`` request at p3 (it
   must store bf16), each with K1's d-chunked count zeroed before and
   read after (> 0), ids identical to the exact f32 oracle's up to
   ties proven within the expanded score's rounding (16·2⁻²⁴ of ‖x‖² +
   max‖y‖², as phase 5's; the norms dwarf the distances at d = 960);
   then ``knn(res, X, Q, k)`` without an index, which must
   take the fused pipeline. ms, n_fail, launches and GB/s of the [1000,
   1M] f32 matrix. K1's d-chunked form against its twin on the path's
   own inputs (``compare_k1``), timed beside the twin, its bound and
   ``torch.matmul`` in bf16 of the same shape, its ``K1 dchunk at`` line
   also giving the launcher's geometry and the L2 → shared-memory bytes
   that geometry moves by a model (``dchunk_l2_bytes``, not a
   measurement). unpacked_knn:
   ``prepare_knn_index(Y, T=512, g=4096, passes=3)`` (16,384 codes, past
   the packed envelope) on the wide data and on phase 3's 1M × 128 data
   (2048 queries, k = 64): ids identical to the oracle's up to proven
   ties, n_fail printed (one group: most queries take the fixup); K1's
   unpacked form and its d-chunked form, whose one group is cut into S
   segments (``group_segments``) folded by their own blocks and merged by
   a second kernel: at the chosen S and at S = 1 bit for bit equal, the
   merge equal bit for bit to the split twin's ``merge_segments`` over the
   kernel's own segment summaries, and against their twins (values
   within the f32 summation bound, non-finite slots equal in kind, ids
   equal except where both rows score within twice the bound in f64),
   timed at both S beside twin, bound and ``torch.matmul``. K1's d-chunked slot form
   (``slot_dchunk_rows``) on wide_knn's operands at p1 and p3: held
   against its twin, then timed with its count zeroed before and read
   after, beside twin, bound and ``torch.matmul``.
14. A ``speed_guard`` line (``speed_guard``): packed K1 and K2, K1's
   d-chunked form, K4, K5 and K9 alone, the slot forms (resident and
   d-chunked), K6b, K6c and K7
   against their times recorded from earlier full runs
   (``GUARD_MS``), failing where one is more than 10% slower on the card
   they were recorded on and naming those more than 5% slower. Every
   timed window of this run starts on a settled card (``settle``: idle
   ``SETTLE_S`` seconds, so that a power-capped clock has recovered). The wall
   seconds of each phase (``phase_s``). A JSON ``kernels`` line (K1's
   and K2's rows also carry each instance's ptxas registers and spill
   bytes and ``fold_issue_ms``, the fold's SASS issue time, which
   ``bound_ms`` leaves out), ``nonfinite_k1_k2``
   (with the slot forms' cases), ``main_path``, ``k1_ladder``, ``serving``, ``ivf``, ``ivf_pq``,
   ``mutable``, ``spectral``, ``pairwise_stats``, ``select_k`` and ``wide_knn`` lines,
   the total wall time, the card's name and power limit, and the result
   line ``{"ok": true, "device": {...}}``.
15. The mutable index and its durability plane (``mutable_phase``), run
   right after phase 6 on phases 5's and 6's indexes. (a) brute bf16
   served at ``benchmarks/bench_mutation.py:55,112-210``'s shape:
   ``ServingEngine(Y, k=64, mutable=True, compact_threshold=5120,
   delta_cap=10240)`` over 1M × 128 N(0, 1) rows, 6 closed-loop readers
   (1500 batches at least, more while the writer or a fold runs; sizes
   Poisson around the ladder's first rung) beside one writer of 40
   batches (an upsert of 64 overwrites and 192 fresh ids, then a delete of
   32 other live ids), across at least one compaction; no read submitted
   after a delete's ack names its id; then 256 queries against the
   from-scratch oracle over the host model of the live rows (ids up to
   proven ties, values within the expanded form's rounding); read and
   write p50/p99, reads/s, folds (materialize, rebuild, rebase seconds),
   reads completed inside a fold window, delta refresh ms, base and delta
   n_fail, K1 launches per search (counts zeroed before the load, read
   after), device busy and idle share. (e) K1 against its twin on that
   base's operands after 2000 scattered deletes: 65 tiles with the view's
   tombstoned carrier, p1 (pair) and p3 (``compare_k1``). (b) the same at
   int8 (K2), 300 reads and 8 write batches. (c) the IVF-Flat and 8-bit
   IVF-PQ indexes wrapped in ``MutableIndex`` (no rebuild): 1000 deletes
   and 512 upserts, ``search_view(exact=True)`` against the oracle, the
   probed path (K5 with the masked ids on IVF-PQ, its count zeroed before
   and read after) never naming a deleted id, recall@10 printed. (d)
   ``benchmarks/bench_recovery.py:51,118-200``: 64 write batches of 256
   rows on a 1M × 128 ``MutableIndex`` in memory and then durable
   (``wal_sync="batch"``, a temporary directory removed afterwards):
   ``durable_overhead_x``, the genesis checkpoint's disk seconds; recovery
   after WAL tails of 64 and 256 records split into checkpoint load,
   build and replay, answering 256 queries with the pre-crash index's ids.
16. The SVD family, BASELINE config 3 whole (``svd_phase``;
   ``benchmarks/bench_configs.py:84-103``): make_blobs 100,000 × 1,000
   (16 clusters, seed 2) on the card. (a) ``linalg.randomized_svd(res,
   X3, k=16)`` (p = 10, 2 power iterations): its 16 singular values
   within 1e-4 relative of f64 ones (the singular values of the R of an
   f64 QR of X3), U and V orthonormal within 1e-4; its split (the six
   products over A, the five QRs, the small SVD) timed alone on the same
   shapes. (b) ``svd_qr`` of X3 (cuSOLVER's gesvd), its values held the
   same way; ``torch.linalg.svd`` of X3 with the gesvdj (torch's default)
   and gesvda drivers timed and measured beside it, not checked. (c)
   ``PCA(16)`` fit, transform and inverse_transform with COV_EIG_DC at
   full size and with COV_EIG_JACOBI on the first 256 columns, the
   explained variance within 1e-4 relative of f64 ``eigvalsh`` of the
   covariance; ``TruncatedSVD(16)`` likewise against the f64 Gram.
   (d) ``sparse.solver.randomized_svds`` (k = 16) on a scale-20 R-MAT
   adjacency symmetrised on the card: S[0] within 1% of the top
   eigenvalue from the port's Lanczos (the adjacency is symmetric and
   non-negative, so its top singular value is its Perron eigenvalue), U
   and V orthonormal, S descending and finite. (e) ``mst`` on a scale-18
   R-MAT symmetric graph (duplicates and self-loops dropped) with seeded
   uniform weights: the total weight within 1e-5 relative of
   ``scipy.sparse.csgraph.minimum_spanning_tree``'s and n − components
   edges. Each step's time is a host-clock median of 3 after a warm-up,
   each window after ``settle()``. Prints one ``svd`` line. No kernel of
   K1–K9 runs here.

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
#: what the K1/K2 rows' ``library_ms`` is
MATMUL_NOTE = ("torch.matmul bf16 of the same product, a reference point: "
               "no PyTorch call computes the fold")

N_INDEX, DIM, N_QUERIES, K = 1_000_000, 128, 2048, 64
# the serving phase: bench_serving.py's chip shape (rows, d, k, requests,
# clients) and its mean think time
SERVE_SHAPE = (1_000_000, 128, 64, 2000, 8)
SERVE_THINK_S = 1e-3
# the IVF phase: bench_ann.py's TPU shape and build
IVF_CENTERS, IVF_K, IVF_LISTS = 64, 10, 1024
#: host-clock repetitions of each IVF-Flat and IVF-PQ cell (their median;
#: 5 until the mutable phase joined the run, cut to hold the wall time)
IVF_TIMED_REPS = 3


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


def ptxas_report(name: str, log: str):
    """Print each kernel's registers and spills from ``nvcc -Xptxas=-v``'s
    report of library ``name``, each line led by the kernel's (mangled)
    name."""
    kernel = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            print(f"ptxas {name} {kernel}: {line.strip()}", flush=True)


#: SASS opcodes of the packed fold: the score's adds (FADD), K2's scale
#: (FMUL), the pack (LOP3), the min/max network (FMNMX) and pair's code
#: select (FSETP, SEL)
FOLD_OPCODES = ("FADD", "FMUL", "LOP3", "FMNMX", "FSETP", "SEL", "FSEL")
#: FP32/ALU instructions the card issues a second (132 SMs × 128 lanes ×
#: 1.98 GHz: the 67 TFLOP/s FP32 peak over 2)
H100_ISSUE_PER_S = 33.45e12


def sass_fold_ops(lib: str = "fused_l2_packed_sm90") -> dict:
    """Per instance of the wgmma kernels (``sm90_instance``'s names): the
    SASS instructions of the fold's opcodes
    (``FOLD_OPCODES``, from ``cuobjdump -sass`` of the built library) over
    the scores its unrolled chunk pair folds a thread (2 × 32), and the
    FMNMX count. The count takes every such instruction of the kernel,
    so the prologue's and the producer's few are in it: an upper
    estimate of the fold's issue a score."""
    import re
    import shutil

    from raft_tpu_torch.ops import _build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", _build.library_path(lib)],
                         capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    res, name, counts = {}, None, None
    for line in out.stdout.splitlines() + ["Function : end"]:
        if "Function :" in line:
            if name is not None:
                res[name] = {"per_score": sum(
                    counts[o] for o in FOLD_OPCODES) / 64.0,
                    "fmnmx": counts["FMNMX"]}
            m = re.search(SM90_KERNEL, line)
            name = sm90_instance(m) if m else None
            counts = {o: 0 for o in FOLD_OPCODES}
        elif name is not None:
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                          line)
            if m and m.group(1) in counts:
                counts[m.group(1)] += 1
    return res


def fold_issue_ms(per_score: float, Q: int, M: int) -> float:
    """The fold's issue time for Q·M scores at ``per_score`` SASS
    instructions each: a floor beside ``bound_ms``, not part of it."""
    return 1e3 * per_score * Q * M / H100_ISSUE_PER_S


def ptxas_spills(log: str) -> dict:
    """Registers and spill bytes of every kernel in one library's ``nvcc
    -Xptxas=-v`` report, by (mangled) kernel name."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line.strip()
            out[name] = {}
        elif name is not None and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            out[name]["spill_bytes"] = int(st) + int(ld)
        elif name is not None and "Used" in line and "registers" in line:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers",
                                                   line).group(1))
    return out


#: instances of the wgmma source: packed K1 and K2 (passes × pair × int8),
#: K1's d-chunked form (passes × pair × queries resident), the resident
#: slot form (passes × track × mask) and the d-chunked one (passes ×
#: queries resident)
PACKED_INSTANCES = 8 + 8 + 8 + 4
#: the wgmma kernels' template arguments in their mangled names: passes,
#: pair, q8 (d-chunked: queries resident), fold, mask
SM90_KERNEL = (r"(packed|wide)_sm90_kernelILi(\d)ELb(\d)ELb(\d)ELi(\d)"
               r"ELb(\d)E")


def sm90_instance(m) -> str:
    """The name of a wgmma kernel instance from a ``SM90_KERNEL`` match:
    packed ``p{passes}`` + ``_pair`` + ``_q8``; d-chunked ``wide_p
    {passes}`` + ``_pair`` + ``_stream`` where x streams; the slot forms
    ``slot_p{passes}`` + ``_min`` (track=False) + ``_mask``, and
    ``slot_wide_p{passes}`` + ``_stream``."""
    kind, passes, pair, flag, fold, mask = m.groups()
    if fold != "0":
        name = f"slot_{'wide_' if kind == 'wide' else ''}p{passes}"
        if kind == "wide":
            return name + ("" if flag == "1" else "_stream")
        return (name + ("_min" if fold == "2" else "")
                + ("_mask" if mask == "1" else ""))
    name = f"p{passes}{'_pair' if pair == '1' else ''}"
    if kind == "packed":
        return name + ("_q8" if flag == "1" else "")
    return "wide_" + name + ("" if flag == "1" else "_stream")


def ptxas_packed(log: str) -> dict:
    """Registers and spill bytes of each instance of the wgmma kernels
    (``sm90_instance``'s names) from ``nvcc -Xptxas=-v``'s report. The
    registers are the launch's (384 threads); setmaxnreg then gives the
    consumer warpgroups 232 and the producer 40."""
    import re

    out = {}
    for kernel, rep in ptxas_spills(log).items():
        m = re.search(SM90_KERNEL, kernel)
        if m is not None:
            out[sm90_instance(m)] = rep
    return out


#: the instances K4's and K7's sources must build: K4's scan at f32 and
#: int8 and its merge; K7 at NA = 1, 2, 4, 8, 16 in entry and CSR form
PTXAS_FATAL = {"fine_scan": 3, "sddmm": 10}


def ptxas_fatal(build_log: dict) -> dict:
    """K4's and K7's instances (``PTXAS_FATAL``), each built without a
    spill: fails otherwise, as the packed kernel's check does. Returns
    their registers and spills by library."""
    out = {}
    for lib, n in PTXAS_FATAL.items():
        if lib not in build_log:                  # (not when reloaded)
            continue
        rep = ptxas_spills(build_log[lib])
        check(len(rep) == n and all(r.get("spill_bytes") == 0
                                    for r in rep.values()),
              f"{lib}: {len(rep)} of {n} instances reported, or some "
              f"spill: {rep}")
        out[lib] = rep
    return out


#: seconds the card idles before a timed window. After a stretch at its
#: power limit the card holds its SM clock down for a while, and a kernel
#: timed inside that recovery reads slow: K5 alone up to 27% slow right
#: after one, bf16 torch.matmul 17%; after 0.1 s both read within 2% of
#: their times after a second's idle (PERF.md §6,
#: ``port_scripts/settle_probe.py``).
SETTLE_S = 0.2


def settle() -> None:
    """Let the card leave a power-capped stretch before a timed window."""
    import torch

    torch.cuda.synchronize()
    time.sleep(SETTLE_S)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches, timed
    on a settled card (:func:`settle`)."""
    import torch

    settle()
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


#: torch.profiler traces ``kernel_ms`` makes before it gives up on a kernel,
#: and the host seconds its first trace stays open before its first launch
#: and after its last synchronize. Past a few minutes of a run a trace can
#: hold the launches' runtime records and none of the kernel's device
#: records, and every later trace too: K7 in four of eight runs of this
#: script, a kernel the speed guard holds in two, where the guard then had
#: no time to hold. Kineto drops a record whose time, moved onto the host
#: clock, falls outside the trace's window; late in a run pads of 0.8 s
#: still missed K7 and 3.2 s held it. So the pads grow fourfold a missed
#: trace, up to ``TRACE_PAD_MAX_S``, and the next call starts from the pad
#: that last held its kernel.
KERNEL_MS_TRIES = 5
TRACE_PAD_S = 0.05
TRACE_PAD_MAX_S = 3.2
_trace_pad = [TRACE_PAD_S]
#: traces of ``kernel_ms`` that held no record of their kernel, by name
PROFILER_MISSES: dict = {}
#: (name, pad s, lead ms) of each trace that held its kernel: the lead is
#: the kernel's first device record after the trace's first record. It
#: stays a few ms with 3.2 s pads too: the records keep their order among
#: themselves, and it is the window that moves against them
PROFILER_LEADS: list = []


def kernel_ms(fn, name: str, reps: int = 5):
    """Mean device milliseconds of the kernels whose name holds ``name``
    over ``reps`` calls of ``fn()`` after one more, from torch.profiler's
    kernel records: the kernel alone, without its wrapper's host work or
    other device work (None where no trace of ``KERNEL_MS_TRIES`` saw
    such a kernel), on a settled card (:func:`settle`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    settle()
    fn()
    torch.cuda.synchronize()
    for _ in range(KERNEL_MS_TRIES):
        pad = _trace_pad[0]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        total, count, records = 0.0, 0, 0
        for e in prof.key_averages():
            records += e.count
            if name in e.key:
                t = getattr(e, "device_time_total", None)
                total += e.cuda_time_total if t is None else t
                count += e.count
        if count:
            starts = [e.time_range.start for e in prof.events()]
            mine = [e.time_range.start for e in prof.events()
                    if name in e.name]
            PROFILER_LEADS.append(
                [name, pad, (min(mine) - min(starts)) / 1e3 if mine
                 else None])
            return total / count / 1e3
        PROFILER_MISSES[name] = PROFILER_MISSES.get(name, 0) + 1
        _trace_pad[0] = min(4 * pad, TRACE_PAD_MAX_S)
        print(f"kernel_ms: a trace of {reps} calls with {pad} s pads held "
              f"no {name} record ({records} records in all); redone",
              file=sys.stderr, flush=True)
        settle()
    return None


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
    """Hold K4's pools against its twin's. Both compute the reference's
    bf16 hi/lo terms and sum them in f32 in other orders (the kernel on
    the tensor cores, the twin by torch.matmul with TF32 off), each within
    ``sum_bound(d)``·(‖x‖ + ‖y‖)² of their exact sum
    (``ops/csrc/fine_scan.cu``), so a value may differ by twice that with
    max‖y‖; +inf must match +inf. i1/i2 (global slab rows) must agree on
    ≥ 99.9% of slots: a near-tie may flip. Returns the max abs error."""
    import torch
    from raft_tpu_torch.ops.fine_scan import sum_bound

    d = x.shape[1]
    tol = (2 * sum_bound(d) * (x.norm(dim=1) + ymax) ** 2)[:, None]
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


def k4_nonfinite(inp):
    """K4 against its twin once more on ``k4_inputs``' operands with NaN,
    +inf and −inf planted in three query rows and (f32 slab) in a row of
    each of the schedule's first three entries: every score they make is
    NaN or +inf, which loses each strict < of the fold, so neither side
    may carry a NaN into a1, a2 or a3 (the kernel's partial merge takes
    its a3 min over such pools only) nor name a planted row; the pools
    must still match (``compare_k4``). Returns the max abs error."""
    import torch

    args = list(inp["args"])
    q8 = inp["q8"]
    ix, islab = (2, 5) if q8 else (1, 4)
    x = args[ix].clone()
    x[5, 3], x[9, 0], x[20, 7] = float("nan"), float("inf"), -float("inf")
    args[ix], args[ix + 1] = x, (x * x).sum(1)
    planted = []
    if not q8:
        sched, slab = args[0], args[islab].clone()
        for j in range(min(3, sched.shape[1])):
            start, lsize, off = (int(v) for v in sched[:3, j])
            if lsize:
                planted.append(start + off)
                slab[start + off, j] = (float("nan"), float("inf"),
                                        -float("inf"))[j]
        args[islab] = slab
    saved = k4_counts()
    out = inp["kern"](*args)
    ref = inp["twin"](*args)
    torch.cuda.synchronize()
    set_counts(saved)
    tag = "K4_q8" if q8 else "K4"
    for side, pools in (("kernel", out), ("twin", ref)):
        check(not any(bool(pools[n].isnan().any()) for n in (0, 2, 4)),
              f"{tag} with ±inf/NaN planted: the {side} carried a NaN into "
              f"its pools")
        ids = torch.cat([pools[1], pools[3]]).reshape(-1)
        check(not bool(torch.isin(ids, torch.tensor(
            planted, dtype=ids.dtype, device=ids.device)).any()),
              f"{tag}: the {side} pooled a planted row")
    check(bool((out[1][[5, 9, 20]] == -1).all()), f"{tag}: a planted "
          f"query row pooled a row")
    # the planted query rows pool nothing; their bound is left finite
    return compare_k4(out, ref, torch.where(torch.isfinite(x), x, 0.0),
                      inp["ymax"], q8)


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


def k4_edge_inputs(index, Qx):
    """K4's operands on a schedule built to reach its work plan's edges:
    256 queries, 4 probe columns. Every query probes the index's largest
    list (8 items of 32 members, each over every chunk of the longest
    window); queries 0–32 the second largest (33 members: an item of 32
    and one of 1); queries 33–37 the smallest non-empty list; query 40 a
    list no other query probes; queries 0–9 an empty list (length 0,
    written over the schedule's first pad entry: its members pool
    nothing); columns 2–3 of most queries are pads (−2)."""
    import numpy as np
    import torch
    from raft_tpu_torch.ann import ivf_flat as ivf
    from raft_tpu_torch.ops import fine_scan as k4

    sizes = index.sizes.cpu().numpy()
    order = np.argsort(-sizes, kind="stable")
    small = order[np.nonzero(sizes[order] > 0)[0][-1]]
    nq = 256
    probes = np.full((nq, 4), -2, np.int32)
    probes[:, 0] = order[0]
    probes[:33, 1] = order[1]
    probes[33:38, 1] = small
    probes[40, 1] = order[len(order) // 2]
    sch = ivf.build_list_schedule(index, probes)
    sched, scale_l = sch.sched.copy(), sch.scale_l.copy()
    pad = np.nonzero(sched[3] < 0)[0]
    if not pad.size:                     # append a cell of pad entries
        sched = np.concatenate([sched, np.tile(np.array(
            [[0], [0], [0], [-1]], np.int32), (1, k4.LISTS_PER_CELL))], 1)
        scale_l = np.concatenate([scale_l, np.ones(k4.LISTS_PER_CELL,
                                                   np.float32)])
        pad = np.nonzero(sched[3] < 0)[0]
    empty = index.n_lists + 7
    sched[:, pad[0]] = (0, 0, 0, empty)
    probes[:10, 2] = empty
    x = Qx[:nq].contiguous()
    xx = (x * x).sum(1)
    pp = torch.from_numpy(probes).cuda()
    Wk = k4.pad_window(index.probe_window)
    st = torch.from_numpy(sched).cuda()
    if index.db_dtype == "int8":
        args = (st, torch.from_numpy(scale_l).cuda(), x, xx, pp,
                index.slab_q, Wk)
        kern, twin = k4.fine_scan_list_major_q8, k4.fine_scan_list_major_q8_ref
        yy = index.yy_q
    else:
        args = (st, x, xx, pp, index.slab, Wk)
        kern, twin = k4.fine_scan_list_major, k4.fine_scan_list_major_ref
        yy = index.yy_slab
    return {"args": args, "kern": kern, "twin": twin, "x": x,
            "q8": index.db_dtype == "int8", "ymax": float(yy.max().sqrt()),
            "largest": int(sizes[order[0]]), "smallest": int(sizes[small])}


def k4_edge_case(index, Qx):
    """K4 against its twin on :func:`k4_edge_inputs`: ragged member
    batches, an empty list, the largest list; every query (each probes the
    largest list) pools a row on both sides. Returns (the max abs error,
    the largest and the smallest list's rows)."""
    import torch

    inp = k4_edge_inputs(index, Qx)
    saved = k4_counts()
    out = inp["kern"](*inp["args"])
    torch.cuda.synchronize()
    set_counts(saved)
    ref = inp["twin"](*inp["args"])
    err = compare_k4(out, ref, inp["x"], inp["ymax"], inp["q8"])
    for side, pools in (("kernel", out), ("twin", ref)):
        check(bool((pools[1] >= 0).any(1).all()), f"K4 edge case: a query "
              f"that probes the largest list pooled nothing ({side})")
    return err, inp["largest"], inp["smallest"]


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
              probes=(32, 128, 64), data=None, keep=None):
    """Phases 4 and 5 (see the module doc) at ``n_rows`` × 128 with
    ``n_lists`` lists; ``probes`` are the P of ivf_p32, ivf_p128 and
    ivf_q8_p64; ``data`` is :func:`ann_data`'s (made here when None).
    ``keep`` (a dict) receives the f32 index as ``"ivf_flat"``. Returns
    (the ``ivf`` report, K4's two ``kernels`` entries)."""
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
        del out, ref
        err_nf = k4_nonfinite(inp)
        err_edge, big, small = k4_edge_case(ix, Q)
        print(f"K4 vs twin ({ix.db_dtype}, 256 queries, P={probes[0]}, "
              f"{inp['lists']} lists): max_abs_err={err}; with ±inf/NaN "
              f"planted: max_abs_err={err_nf}, no NaN in the pools; ragged "
              f"batches, an empty list, the largest ({big} rows) and "
              f"smallest ({small}) lists: max_abs_err={err_edge}",
              flush=True)

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
        for _ in range(IVF_TIMED_REPS):
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
            # the kernels alone (torch.profiler): the scan and the merge
            scan_ms = kernel_ms(lambda: inp["kern"](*inp["args"]),
                                "fine_scan_kernel")
            merge_ms = kernel_ms(lambda: inp["kern"](*inp["args"]),
                                 "merge_kernel")
            set_counts(saved)           # comparison launches do not count
            bound, bound_by = k4_bound_ms(n_queries, DIM, P,
                                          inp["stream_rows"],
                                          inp["pair_rows"], inp["q8"])
            k4_rows[name] = {
                "ms": ms, "kernel_ms": (None if scan_ms is None
                                        or merge_ms is None
                                        else scan_ms + merge_ms),
                "scan_ms": scan_ms, "merge_ms": merge_ms,
                "plain_ms": plain_ms, "bound_ms": bound,
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
              "fine_scan.cu",
              "library_note": "null: no one PyTorch call computes the "
                              "masked gather-and-fold over the probed "
                              "lists (f32 slab, or int8 codes with their "
                              "row scales)"}
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
    if keep is not None:
        keep["ivf_flat"] = f32
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


#: 4-byte shared-memory reads the card serves a second: one a lane a
#: clock, 32 lanes × 132 SMs × 1.98 GHz (K5's table lookups)
H100_LDS_PER_S = 32 * 132 * 1.98e9


def k5_lookup_ms(S: int, pair_rows: int) -> float:
    """K5's lookup ceiling: the S table reads of every scored (query, row)
    pair at one conflict-free 4-byte read a lane a clock. A floor beside
    ``bound_ms``, not part of it."""
    return 1e3 * S * pair_rows / H100_LDS_PER_S


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
            "K5_4bit": k5.LAUNCHES_4BIT,
            **{f"K5_depth{t}": n for t, n in k5.LAUNCHES_DEPTH.items()}}


def set_pq_counts(c):
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.ops import pq_scan as k5

    k1.LAUNCHES, k5.LAUNCHES_8BIT, k5.LAUNCHES_4BIT = (
        c["K1"], c["K5"], c["K5_4bit"])
    for t in k5.LAUNCHES_DEPTH:
        k5.LAUNCHES_DEPTH[t] = c.get(f"K5_depth{t}", 0)


def k5_lb(args, bits: int, S: int, q: int, row: int) -> float:
    """The twin's arithmetic for one (query, slab row): the row's entry in
    the schedule, the table sum as the kernel takes it (``adc_sum`` at the
    row's window column), the certified bound."""
    import torch
    from raft_tpu_torch.ops.pq_scan import adc_sum

    sched, xx, _, cdot, lut, codes, yy, eq, _ = args
    lo = sched[0] + sched[2]
    j = int(((row >= lo) & (row < lo + sched[1]) & (sched[3] >= 0))
            .nonzero()[0, 0])
    col = torch.tensor([row - int(sched[0, j])], device=lut.device)
    adc = adc_sum(lut[q:q + 1], codes[row:row + 1], col, S, bits)[0, 0]
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
    probes (ties proven); the host-clock median of ``IVF_TIMED_REPS``; the chooser's pick
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
    for _ in range(IVF_TIMED_REPS):
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
                 10, warmup=2)
    # the kernel alone: the wrapper's probe inversion and allocations run
    # on the host and the card around it
    kms = kernel_ms(lambda: k5.pq_scan_list_major(*inp["args"],
                                                  pq_bits=bits),
                    "pq_scan_kernel")
    check(kms is not None, f"{name}: the profiler saw no pq_scan_kernel")
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
    # every rung on the batch's own operands, with its launches in the run
    rungs_k5 = {}
    for depth in (2, 4, 8):
        r_bound, _ = k5_bound_ms(nq, S, bits, P, depth, inp["stream_rows"],
                                 inp["pair_rows"])
        rungs_k5[depth] = {
            "ms": ms if depth == 2 else cuda_ms(
                lambda: k5.pq_scan_list_major(*inp["args"], pq_bits=bits,
                                              pool_depth=depth), 10),
            "bound_ms": r_bound,
            "launches": launches[f"K5_depth{depth}"]}
    set_pq_counts(saved)
    k5_row = {"ms": ms, "kernel_ms": kms, "bound_ms": bound,
              "bound_by": bound_by, "library_ms": None,
              "lists": inp["lists"], "stream_rows": inp["stream_rows"],
              "pair_rows": inp["pair_rows"],
              "launches_per_call": launches[kname], "rungs": rungs_k5}
    if plain:
        hold = []
        k5_row["plain_ms"] = cuda_ms(lambda: hold.append(
            k5.pq_scan_list_major_ref(*inp["args"], pq_bits=bits)), 1,
            warmup=0)
        k5_row["max_abs_err"], k5_row["tie_slots"] = compare_k5(
            out, hold[0], inp, f"K5 {name}")
        del hold
    del out
    model = {"lookup_ceiling_ms_modelled": k5_lookup_ms(S,
                                                         inp["pair_rows"])}
    print(f"k5 {name}: {json.dumps({**k5_row, **model})}", flush=True)
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


def pq_phase(res, data, n_lists: int, probes=(32, 128), keep=None):
    """Phase 6 (see the module doc) on :func:`ann_data`'s ``data`` with
    ``n_lists`` lists; ``probes`` are the P of the pq cells (the first is
    also the diffuse cell's, the served burst's and the K5-against-twin
    check's). ``keep`` (a dict) receives the 8-bit index as ``"ivf_pq"``.
    Returns (the ``ivf_pq`` report, K5's two ``kernels`` entries)."""
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

    # ---- phase 6a: K5 against its twin on real schedules, every rung ----
    for bits, P in ((b, p) for b in (8, 4) for p in probes):
        inp = k5_inputs(res, index[bits], Q[:64], P)
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
                  f"P={P}, {inp['lists']} lists): max_abs_err={err} "
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
    if keep is not None:
        keep["ivf_pq"] = index[8]
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
                "max_abs_err", "ms", "kernel_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "rungs")},
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


def k7_gather_floor_ms(nnz: int, d: int) -> float:
    """K7's modelled gather floor, not a measurement: one B row an entry
    (nnz·d·4 bytes) at the card's HBM rate, where no B row stays in L2
    between its uses."""
    return 1e3 * nnz * d * 4 / H100_BYTES_PER_S


def k7_checks(gen, m: int = 50_000, n: int = 70_000):
    """K7 against its twin on a structure made to reach its work items'
    edges: empty rows (the first and the last among them), a row of 5000
    entries (it spans many of the kernel's 64-entry runs and 256-entry
    warps), rows of 1 to 40, a last warp of partial runs; in CSR form and
    in entry form with a dst order, at d = 64, 3 (padded to 4), 200 and
    512 (the envelope's edge); then the CSR form on the structure with
    indptr[m] short of nnz (the kernel must end, and give NaN past it).
    Returns the max abs error by case."""
    import torch
    from raft_tpu_torch.ops import sddmm as k7

    deg = torch.randint(0, 41, (m,), generator=gen, device="cuda")
    deg[[0, 5, 6, m - 1]] = 0
    deg[7] = 5000
    deg[m - 2] = 3
    indptr = torch.zeros(m + 1, dtype=torch.int32, device="cuda")
    indptr[1:] = torch.cumsum(deg, 0)
    nnz = int(indptr[-1])
    cols = torch.randint(0, n, (nnz,), generator=gen, device="cuda",
                         dtype=torch.int32)
    rows = torch.repeat_interleave(torch.arange(m, device="cuda",
                                                dtype=torch.int32), deg)
    perm = torch.randperm(nnz, generator=gen, device="cuda")
    out = {"nnz": nnz}
    saved = sparse_counts()
    for d in (64, 3, 200, 512):
        A = torch.randn((m, d), generator=gen, device="cuda")
        B = torch.randn((d, n), generator=gen, device="cuda")
        twin = k7.sddmm_entries_ref(A, B, rows, cols)
        bound = (d + 2) * 2.0 ** -24 * k7.sddmm_entries_ref(
            A.abs(), B.abs(), rows, cols)
        e1 = check_bound(f"K7 CSR form d={d}",
                         k7.sddmm_csr(A, B, indptr, cols), twin, bound)
        e2 = check_bound(f"K7 entry form, shuffled, d={d}",
                         k7.sddmm_entries(A, B, rows[perm].contiguous(),
                                          cols[perm].contiguous(),
                                          dst=perm.to(torch.int32)),
                         twin, bound)
        out[f"d{d}"] = max(e1, e2)
    # a malformed structure, its row ends capped 300 entries short of nnz:
    # the kernel ends (no endless search for a row) and gives those NaN
    A = torch.randn((m, 64), generator=gen, device="cuda")
    B = torch.randn((64, n), generator=gen, device="cuda")
    short = indptr.clamp(max=nnz - 300)
    got = k7.sddmm_csr(A, B, short, cols)
    torch.cuda.synchronize()
    want = k7.sddmm_csr_ref(A, B, short, cols)
    check(bool(torch.isnan(got[nnz - 300:]).all()),
          "K7 CSR form: entries past indptr[m] are not NaN")
    bound = 66 * 2.0 ** -24 * k7.sddmm_entries_ref(
        A.abs(), B.abs(), rows[:nnz - 300], cols[:nnz - 300])
    check_bound("K7 CSR form, indptr[m] < nnz", got[:nnz - 300],
                want[:nnz - 300], bound)
    out["short_indptr"] = "ended, NaN past indptr[m]"
    set_sparse_counts(saved)
    print(f"K7 checks (empty rows, a row of 5000, partial last warp; CSR "
          f"and shuffled entry forms): {json.dumps(out)}", flush=True)
    return out


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


#: the first K6a, K6c and K6b designs (one block a chunk), recorded from
#: earlier full runs of this script on an H100 80GB HBM3 at 700 W (K6a
#: and K6c at V = 16 and 128 on spectral_g22's layout, K6b on the band
#: matrix); printed beside this run's times, never put in the ``kernels``
#: line
K6_FIRST_DESIGN_MS = {"K6a": 2.132, "K6c": 13.28, "K6c_V128": 268.37,
                      "K6b": 0.438}


def row_degrees(A):
    """Entries of each row of a port COO/CSR matrix, f32 (the bound's
    nnz_i; duplicates of a COO matrix count apart, as the kernels add
    them apart)."""
    import torch
    from raft_tpu_torch.core.sparse_types import CSRMatrix

    if isinstance(A, CSRMatrix):
        return (A.indptr[1:] - A.indptr[:-1]).float()
    return torch.bincount(A.rows.long(), minlength=A.shape[0]).float()


def k6c_case(tag: str, T, deg, B, reps: int, Lt=None, res=None):
    """K6c on layout ``T`` and B against its twin within (nnz_i + 2)·2⁻²⁴·
    Σ_j |a_ij·b_jv| (``deg`` = nnz_i), then timed (CUDA events) beside the
    twin and cuSPARSE's SpMM (``Lt @ B``, when ``Lt`` is given). Through
    ``linalg.spmm`` when ``res`` is given (the path's own entry point),
    else the wrapper. A first wrapper call starts its Y from a NaN-filled
    block of the caching allocator (its address is checked), so a row no
    item wrote would show."""
    import dataclasses

    import torch
    from raft_tpu_torch.ops import spmv as k6
    from raft_tpu_torch.sparse import linalg as sl

    V = B.shape[1]
    poison = torch.full((T.n_row_tiles * T.R, V), float("nan"),
                        device="cuda")
    ptr = poison.data_ptr()
    del poison
    n0 = k6.LAUNCHES_SPMM
    Y_nan = k6.spmm_tiled(T, B)
    check(Y_nan.data_ptr() == ptr,
          f"{tag}: K6c's Y did not start from the NaN-filled block")
    Y = Y_nan
    if res is not None:     # the path's own entry point, counted alone
        k6.LAUNCHES_SPMM = n0
        Y = sl.spmm(res, T, B)
    torch.cuda.synchronize()
    launches = k6.LAUNCHES_SPMM - n0
    check(launches > 0, f"{tag}: K6c launched no time")
    hold = []
    plain = cuda_ms(lambda: hold.append(k6.spmm_tiled_ref(T, B)), 1,
                    warmup=0)
    T_abs = dataclasses.replace(T, vals=T.vals.abs())
    bound = (deg + 2)[:, None] * 2.0 ** -24 * k6.spmm_tiled_ref(T_abs,
                                                               B.abs())
    err = check_bound(tag, Y, hold[0], bound)
    if Y_nan is not Y:
        err = max(err, check_bound(f"{tag} from NaN", Y_nan, hold[0], bound))
    del hold, bound, T_abs, Y_nan
    ms = cuda_ms(lambda: k6.spmm_tiled(T, B), reps)
    lib = library_ms(lambda: Lt @ B, reps) if Lt is not None else None
    b_ms, b_by = spmv_bound_ms(int(deg.sum().item()), T.shape[0],
                               T.shape[1], V)
    k6.LAUNCHES_SPMM = n0 + launches    # timing launches do not count
    VC, W, QP = k6.spmm_geometry(T.R, V, B.data_ptr() % 16 == 0)
    row = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib, "max_abs_err": err, "launches": launches,
           "V": V, "VC": VC, "W": W, "items": T.n_items,
           "split_items": int(T.item_split.sum().item()),
           "zero_tiles": T.zero_tiles.numel()}
    print(f"K6c {tag}: {json.dumps(row)}", flush=True)
    return Y, row


def k6a_layout_bound_ms(T):
    """Least time for K6a's own traffic: every scatter slot's in-tile row
    (4 bytes) and gather row (4 bytes an 8-slot row) read once, each real
    scatter row's eight values and columns (64 bytes) once, the item
    table, x read and y's row tiles written once, at HBM's rate."""
    import torch

    m_slots = T.m_chunks * T.E
    zero_row = T.n_chunks * T.E // 8
    real_rows = int((T.perm_rows < zero_row).sum().item())
    nbytes = (m_slots * 4 + m_slots // 8 * 4 + real_rows * 64
              + (2 * T.n_items + 1) * 4 + T.shape[1] * 4
              + T.n_row_tiles * T.R * 4)
    torch.cuda.synchronize()
    return 1e3 * nbytes / H100_BYTES_PER_S, real_rows * 8


def k6a_case(tag: str, T, deg, x, reps: int, Lt=None):
    """K6a on layout ``T`` and x against its twin within (nnz_i + 2)·
    2⁻²⁴·Σ_j |a_ij·x_j| (``deg`` = nnz_i), its y from a NaN-filled block
    of the caching allocator (its address is checked), so a row no item
    wrote would show; then timed (CUDA events) beside the twin, the CSR
    bound, the layout's own traffic and cuSPARSE's SpMV (``Lt @ x``, when
    ``Lt`` is given). The launches here are not counted."""
    import dataclasses

    import torch
    from raft_tpu_torch.ops import spmv as k6

    poison = torch.full((T.n_row_tiles * T.R,), float("nan"),
                        device="cuda")
    ptr = poison.data_ptr()
    del poison
    n0 = k6.LAUNCHES_SPMV
    y = k6.spmv_tiled(T, x)
    torch.cuda.synchronize()
    check(y.data_ptr() == ptr,
          f"{tag}: K6a's y did not start from the NaN-filled block")
    check(k6.LAUNCHES_SPMV == n0 + 1, f"{tag}: K6a launch was not counted")
    hold = []
    plain = cuda_ms(lambda: hold.append(k6.spmv_tiled_ref(T, x)), 1,
                    warmup=0)
    T_abs = dataclasses.replace(T, vals=T.vals.abs())
    bound = (deg + 2) * 2.0 ** -24 * k6.spmv_tiled_ref(T_abs, x.abs())
    err = check_bound(tag, y, hold[0], bound)
    del hold, bound, T_abs
    ms = cuda_ms(lambda: k6.spmv_tiled(T, x), reps)
    k6.LAUNCHES_SPMV = n0
    lib = library_ms(lambda: Lt @ x[:, None], reps) if Lt is not None \
        else None
    b_ms, b_by = spmv_bound_ms(int(deg.sum().item()), T.shape[0],
                               T.shape[1])
    lay_ms, real_slots = k6a_layout_bound_ms(T)
    row = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib, "max_abs_err": err,
           "layout_bound_ms": lay_ms, "scatter_slots": T.m_chunks * T.E,
           "real_slots": real_slots, "items": T.n_items,
           "split_items": int(T.item_split.sum().item()),
           "zero_tiles": T.zero_tiles.numel()}
    print(f"K6a {tag}: {json.dumps(row)}", flush=True)
    return y, row


def k6b_case(tag: str, A, x, reps: int):
    """K6b over the pair layout of COO matrix ``A`` against its twin within
    (nnz_i + 2)·2⁻²⁴·Σ_j |a_ij·x_j|, then timed beside the twin and
    cuSPARSE's SpMV of the same matrix. Returns (layout, row)."""
    import torch
    from raft_tpu_torch.ops import spmv as k6
    from raft_tpu_torch.sparse import convert
    from raft_tpu_torch.sparse import linalg as sl

    t0 = time.perf_counter()
    TP = sl.prepare_spmv(A, layout="pairs")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t0
    n0 = k6.LAUNCHES_PAIR
    y = k6.spmv_pair_tiled(TP, x)
    torch.cuda.synchronize()
    check(k6.LAUNCHES_PAIR == n0 + 1, f"{tag}: K6b launch was not counted")
    hold = []
    plain = cuda_ms(lambda: hold.append(k6.spmv_pair_tiled_ref(TP, x)), 1,
                    warmup=0)
    Acsr = convert.coo_to_csr(A)
    rnz = (Acsr.indptr[1:] - Acsr.indptr[:-1]).float()
    bound = (rnz + 2) * 2.0 ** -24 * sl.spmv(
        None, Acsr.with_values(Acsr.values.abs()), x.abs())
    err = check_bound(tag, y, hold[0], bound)
    del hold, y, bound
    ms = cuda_ms(lambda: k6.spmv_pair_tiled(TP, x), reps)
    k6.LAUNCHES_PAIR = n0
    At = csr_tensor(Acsr)
    lib = library_ms(lambda: At @ x[:, None], reps)
    b_ms, b_by = spmv_bound_ms(A.nnz, A.shape[0], A.shape[1])
    slots = TP.pairs.m_chunks * TP.pairs.E
    row = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": lib, "max_abs_err": err, "nnz": A.nnz,
           "slots": slots, "slots_per_nnz": slots / max(1, A.nnz),
           "layout_s": layout_s}
    print(f"K6b {tag}: {json.dumps(row)}", flush=True)
    return TP, row


def rmat_adjacency(res, seed: int, scale: int, edge_factor: int = 16):
    """The symmetrized R-MAT adjacency of spectral_g22's recipe, values
    1.0, as COO on the card."""
    import torch
    from raft_tpu_torch.core.sparse_types import COOMatrix
    from raft_tpu_torch.random import rmat_rectangular_gen

    n, n_edges = 1 << scale, edge_factor << scale
    src, dst = rmat_rectangular_gen(res, seed, n_edges, scale, scale)
    return COOMatrix(torch.cat([src, dst]), torch.cat([dst, src]),
                     torch.ones(2 * n_edges, device="cuda"), (n, n))


def hub_matrix(gen, n: int = 1 << 18, hub_cols: int = 1024,
               other: int = 8, empty_tile: int = 5, R: int = 256):
    """n × n COO whose row tile 0 holds ``hub_cols`` random columns a row
    (≥ 64 chunks at the default tiling, so its work items split), the
    other rows ``other`` each, and row tile ``empty_tile`` none."""
    import torch
    from raft_tpu_torch.core.sparse_types import COOMatrix

    hub = torch.arange(R, device="cuda").repeat_interleave(hub_cols)
    rest = torch.arange(R, n, device="cuda")
    rest = rest[(rest // R) != empty_tile].repeat_interleave(other)
    rows = torch.cat([hub, rest])
    cols = torch.randint(0, n, (rows.shape[0],), generator=gen,
                         device="cuda")
    vals = torch.randn(rows.shape[0], generator=gen, device="cuda")
    return COOMatrix(rows.to(torch.int32), cols.to(torch.int32), vals,
                     (n, n))


def k6_checks(res, gen, scale: int = 18, hub_n: int = 1 << 18,
              band_n: int = 1 << 20, pairs_scale: int = 16):
    """The K6a, K6c and K6b cases past the path's own shapes, each against
    its twin: K6a, then K6c at V = 33 (scalar lanes) and 512 (the
    envelope's edge), on a scale-``scale`` R-MAT Laplacian; K6a, then K6c
    at V = 128 and 33, on :func:`hub_matrix` (split items and their global
    atomics; an unvisited row tile that must read 0, each from a
    NaN-filled allocation); K6b on a band of half-width 1 (runs of 3)
    and on a scale-``pairs_scale`` R-MAT under ``layout="pairs"`` (runs of
    length 1); pair tilings past K6b's envelope (16-bit locals, the x and
    y tiles in a block's shared memory) raise ``ValueError`` on the card
    before any launch. Returns {"K6a": ..., "K6c": ..., "K6b": ...}."""
    import torch
    from raft_tpu_torch.ops import spmv as k6
    from raft_tpu_torch.sparse import convert
    from raft_tpu_torch.sparse import linalg as sl
    from raft_tpu_torch.sparse.tiled import ITEM_CHUNKS

    out = {"K6a": {}, "K6c": {}, "K6b": {}}
    adj = rmat_adjacency(res, 7, scale)
    L, _ = sl.laplacian_normalized(res, adj)
    del adj
    T = sl.prepare_spmv(L)
    deg, Lt = row_degrees(L), csr_tensor(L)
    x = torch.randn(L.shape[1], generator=gen, device="cuda")
    _, out["K6a"][f"rmat{scale}"] = k6a_case(f"rmat{scale}", T, deg, x, 20,
                                            Lt)
    for V in (33, 512):
        B = torch.randn((L.shape[1], V), generator=gen, device="cuda")
        _, out["K6c"][f"rmat{scale}_V{V}"] = k6c_case(
            f"rmat{scale} V={V}", T, deg, B, 5, Lt)
        del B
    del T, L, Lt, deg
    H = hub_matrix(gen, hub_n)
    TH = sl.prepare_spmv(H)
    deg = row_degrees(H)
    ic = TH.item_chunk0.tolist()
    crt = TH.chunk_row_tile.tolist()
    hub_chunks = sum(1 for c in crt if c == 0)
    hub_items = [i for i in range(TH.n_items) if crt[ic[i]] == 0]
    want = -(-hub_chunks // ITEM_CHUNKS)
    check(hub_chunks >= 64 and len(hub_items) == want
          and all(TH.item_split[i].item() == 1 for i in hub_items),
          f"hub: row tile 0 holds {hub_chunks} chunks in {len(hub_items)} "
          f"items; want ≥ 64 chunks split over {want} items")
    check(not bool(TH.visited_row_tiles[5]) and 5 in TH.zero_tiles.tolist(),
          "hub: row tile 5 should be unvisited and in zero_tiles")
    x = torch.randn(hub_n, generator=gen, device="cuda")
    y, row = k6a_case("hub", TH, deg, x, 20, csr_tensor(convert.coo_to_csr(
        H)))
    check(bool((y[5 * TH.R:6 * TH.R] == 0).all()),
          "hub K6a: the unvisited row tile does not read 0")
    row.update(hub_chunks=hub_chunks, hub_items=len(hub_items))
    out["K6a"]["hub"] = row
    del x, y
    for V in (128, 33):
        B = torch.randn((hub_n, V), generator=gen, device="cuda")
        Y, row = k6c_case(f"hub V={V}", TH, deg, B, 5)
        check(bool((Y[5 * TH.R:6 * TH.R] == 0).all()),
              f"hub V={V}: the unvisited row tile does not read 0")
        row.update(hub_chunks=hub_chunks, hub_items=len(hub_items))
        out["K6c"][f"hub_V{V}"] = row
        del B, Y
    del TH, H, deg
    torch.cuda.empty_cache()
    x = torch.randn(band_n, generator=gen, device="cuda")
    _, out["K6b"]["band_half1"] = k6b_case(
        "band half-width 1", band_matrix(band_n, 1, gen), x, 20)
    A = rmat_adjacency(res, 9, pairs_scale)
    x = torch.randn(A.shape[1], generator=gen, device="cuda")
    _, out["K6b"][f"rmat{pairs_scale}_pairs"] = k6b_case(
        f"rmat{pairs_scale} pairs", A, x, 20)
    del A, x
    tiny, n0 = band_matrix(300, 1, gen), k6.LAUNCHES_PAIR
    for R, C in ((65536, 128), (64, 65664), (64, 65536)):
        TPx = sl.prepare_spmv(tiny, R=R, C=C, E=512, layout="pairs")
        try:
            k6.spmv_pair_tiled(TPx, torch.ones(300, device="cuda"))
            refused = False
        except ValueError:
            refused = True
        check(refused and k6.LAUNCHES_PAIR == n0,
              f"K6b: R={R}, C={C} past the kernel's envelope was launched")
    del tiny, TPx
    torch.cuda.empty_cache()
    return out


def spectral_phase(res, scale: int = 22, band_n: int = 1 << 20,
                   c4=(17, 1_000_000), dense_rows: int = 100_000):
    """Phases 7–9 (see the module doc) at R-MAT ``scale``, a band matrix of
    ``band_n`` rows, config 4 at ``c4`` = (scale, edges) and config 3 at
    ``dense_rows`` × 1000. Returns (the ``spectral`` report, the K6/K7
    ``kernels`` entries)."""
    import torch
    from raft_tpu_torch.core.sparse_types import COOMatrix
    from raft_tpu_torch.models import SpectralEmbedding
    from raft_tpu_torch.ops import sddmm as k7
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
    adj = rmat_adjacency(res, 3, scale)
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
    deg = row_degrees(L)
    Lt = csr_tensor(L)
    _, row = k6a_case("spectral_g22", T, deg, x, 20, Lt)
    rows_k["K6a"] = {**row, "launches": g22["launches"]["K6a"]}
    g22["matvecs_per_fit"] = g22["launches"]["K6a"]
    g22["k6a_ms"] = row["ms"]

    # K6c (SpMM) on the same layout, V = 16 and 128, through linalg.spmm
    k6c = {}
    for V in (16, 128):
        B = torch.randn((n, V), generator=gen, device="cuda")
        set_sparse_counts(zero)
        Y, k6c[V] = k6c_case(f"spectral_g22 V={V}", T, deg, B, 5, Lt, res)
        del B, Y
    rows_k["K6c"] = {**k6c[16], "V128": k6c[128]}
    del Lt, T, L, emb, model
    torch.cuda.empty_cache()

    # ---- K7 on the adjacency structure, d = 64, through linalg.sddmm ----
    d = 64
    S = convert.coo_to_csr(adj)
    del adj
    torch.cuda.empty_cache()
    A = torch.randn((n, d), generator=gen, device="cuda")
    # B [d, n] as a caller holding the factor Bᵀ [n, d] passes it (the
    # layout K7 reads in place); a row-major copy is timed beside it
    Bm = torch.randn((n, d), generator=gen, device="cuda").T
    set_sparse_counts(zero)
    out = sl.sddmm(res, A, Bm, S)
    torch.cuda.synchronize()
    launches = sparse_counts()["K7"]
    check(launches > 0, "sddmm: K7 launched no time")
    saved = sparse_counts()
    rows, cols, indptr = S.row_ids(), S.indices, S.indptr
    hold = []
    plain = cuda_ms(lambda: hold.append(k7.sddmm_entries_ref(A, Bm, rows,
                                                             cols)), 1,
                    warmup=0)
    bound = (d + 2) * 2.0 ** -24 * k7.sddmm_entries_ref(A.abs(), Bm.abs(),
                                                        rows, cols)
    twin = hold.pop()
    err = check_bound("K7", out.values, twin, bound)
    del out
    check_bound("K7 entry form", k7.sddmm_entries(A, Bm, rows, cols), twin,
                bound)
    ms = cuda_ms(lambda: k7.sddmm_csr(A, Bm, indptr, cols), 5)
    k7_alone = kernel_ms(lambda: k7.sddmm_csr(A, Bm, indptr, cols),
                         "sddmm_kernel")
    entries_ms = cuda_ms(lambda: k7.sddmm_entries(A, Bm, rows, cols), 5)
    Br = Bm.contiguous()
    b_row_major_ms = cuda_ms(lambda: k7.sddmm_csr(A, Br, indptr, cols), 5)
    del Br
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
    rows_k["K7"] = {"ms": ms, "kernel_ms": k7_alone, "plain_ms": plain,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                    "max_abs_err": err, "launches": launches, "d": d,
                    "b_layout": "column-major (Bᵀ [n, d] contiguous)",
                    "entry_form_ms": entries_ms,
                    "b_row_major_ms": b_row_major_ms,
                    "tile_order_ms": tile_ms}
    print(f"K7 at d={d}: {json.dumps(rows_k['K7'])}", flush=True)
    print(f"K7 gather floor (modelled, not measured): "
          f"{k7_gather_floor_ms(S.nnz, d)} ms", flush=True)
    del A, Bm, St, S, rows, cols, indptr
    torch.cuda.empty_cache()
    rows_k["K7"]["checks"] = k7_checks(gen)
    report["spectral_g22"] = g22
    print(f"spectral_g22: {json.dumps(g22)}", flush=True)

    # ---- K6b on a block-clustered (band) matrix, through a Lanczos solve
    Bd = band_matrix(band_n, 16, gen)
    x = torch.randn(band_n, generator=gen, device="cuda")
    TP, row = k6b_case("band half-width 16", Bd, x, 20)
    band = {"n": band_n, "nnz": Bd.nnz, "layout_s": row["layout_s"],
            "slots_per_nnz": row["slots_per_nnz"]}
    bcfg = LanczosSolverConfig(n_components=4, max_iterations=60,
                               tolerance=1e-5, seed=1)
    set_sparse_counts(zero)
    bvals, _ = lanczos_compute_eigenpairs(res, TP, bcfg)
    torch.cuda.synchronize()
    band["launches"] = sparse_counts()["K6b"]
    band["eigenvalues"] = bvals.tolist()
    check(band["launches"] > 0 and bool(torch.isfinite(bvals).all()),
          "band: the pair-tiled solve launched K6b no time")
    rows_k["K6b"] = {**row, "launches": band["launches"]}
    first = {"K6a": [rows_k["K6a"]["ms"], K6_FIRST_DESIGN_MS["K6a"]],
             "K6c": [k6c[16]["ms"], K6_FIRST_DESIGN_MS["K6c"]],
             "K6c_V128": [k6c[128]["ms"], K6_FIRST_DESIGN_MS["K6c_V128"]],
             "K6b": [row["ms"], K6_FIRST_DESIGN_MS["K6b"]]}
    print("K6 [this run's ms, first design's ms recorded from an earlier "
          f"run, not measured here]: {json.dumps(first)}", flush=True)
    report["band_pairs"] = band
    print(f"K6b at the band matrix: {json.dumps(rows_k['K6b'])}; "
          f"{json.dumps(band)}", flush=True)
    del Bd, TP, x
    torch.cuda.empty_cache()

    # ---- K6c and K6b past the path's shapes, each against its twin
    checks = k6_checks(res, gen)
    rows_k["K6a"]["checks"] = checks["K6a"]
    rows_k["K6c"]["checks"] = checks["K6c"]
    rows_k["K6b"]["checks"] = checks["K6b"]
    report["k6_checks"] = checks

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


def k9_inputs(gen, Y, Xs, truth, k_s: int) -> dict:
    """K9's timed shapes, {tag: (bins, n_bins)}: ``bench_prims.py:125-130``'s
    100,000 × 8 random bins (64); the batch-1 bins ``value_histogram``
    takes of make_blobs ``Xs``'s values (64); per-column bins of ``Y``
    (64); the stats path's labels, ``truth`` (k_s bins)."""
    import torch

    vals = Xs.reshape(-1)
    lo, hi = vals.min(), vals.max()
    vbins = ((vals - lo) / ((hi - lo) / 64)).to(torch.int32).clamp(0, 63)
    return {"bench_prims": (torch.randint(0, 64, (100_000, 8), device="cuda",
                                          generator=gen, dtype=torch.int32),
                            64),
            "value_histogram": (vbins[:, None].contiguous(), 64),
            "columns": (((Y + 4.0) * 8.0).to(torch.int32).clamp(0, 63), 64),
            "labels": (truth.to(torch.int32)[:, None].contiguous(), k_s)}


def k9_case(tag: str, bins, n_bins: int, reps: int = 20) -> dict:
    """K9 on ``bins`` bit for bit against its twin and ``torch.bincount``,
    its form (``k9_form``) the one ``histogram.cu`` picks, then timed: the
    wrapper by CUDA events (``ms``), the kernel alone by torch.profiler
    (``kernel_ms``), beside the twin, the bound and ``torch.bincount``."""
    import torch
    from raft_tpu_torch.ops import histogram as k9

    n, batch = bins.shape
    flat = (torch.arange(batch, device="cuda")[None, :] * n_bins
            + bins).reshape(-1)
    out = k9.histogram_blocked(bins, n_bins)
    ref = k9.histogram_blocked_ref(bins, n_bins)
    lib = torch.bincount(flat, minlength=batch * n_bins).reshape(
        batch, n_bins).T.to(torch.int32)
    check(torch.equal(out, ref) and torch.equal(out, lib),
          f"K9 {tag}: counts differ from the twin or bincount")
    form = k9.k9_form(batch, n_bins)
    fn = k9._build.load("histogram").histogram_form
    check(form == ("lanes" if fn(batch, n_bins) else "blocked"),
          f"K9 {tag}: k9_form says {form}, histogram.cu does not")
    bound, by = k9_bound_ms(n, batch, n_bins)
    row = {"shape": [n, batch, n_bins], "form": form,
           "ms": cuda_ms(lambda: k9.histogram_blocked(bins, n_bins), reps),
           "kernel_ms": kernel_ms(lambda: k9.histogram_blocked(bins, n_bins),
                                  "histogram", reps),
           "plain_ms": cuda_ms(
               lambda: k9.histogram_blocked_ref(bins, n_bins), 3),
           "bound_ms": bound, "bound_by": by,
           "library_ms": library_ms(lambda: torch.bincount(
               flat, minlength=batch * n_bins), reps),
           "max_abs_err": 0}
    print(f"K9 {tag}: {json.dumps(row)}", flush=True)
    return row


def k9_edge_checks(gen):
    """K9's small-counter form at its edges, bit for bit against its twin:
    views starting 1–3 entries past a 16-byte boundary (the scalar head),
    1–3 entries past the last whole 16 bytes (the tail), fewer entries
    than one 16-byte load, several columns (4 × 16 = 64 counters) with
    ids outside [0, n_bins), and one bin."""
    import torch
    from raft_tpu_torch.ops import histogram as k9

    base = torch.randint(-2, 18, (100_003, 4), device="cuda", generator=gen,
                         dtype=torch.int32)
    flat = base.reshape(-1)
    cases = {f"head {h} tail {t}": (flat[h:h + 4 * 25_000 + t][:, None], 16)
             for h in range(4) for t in range(4)}
    cases.update({"two entries": (flat[1:3][:, None], 16),
                  "4 columns": (base, 16), "3 columns odd": (base[1:, 1:], 21),
                  "one bin": (flat[:99_999][:, None], 1)})
    for tag, (bins, n_bins) in cases.items():
        check(torch.equal(k9.histogram_blocked(bins, n_bins),
                          k9.histogram_blocked_ref(bins, n_bins)),
              f"K9 {tag}: counts differ from the twin")


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
    n0 = k9.LAUNCHES
    n_s, d_s, k_s = stats_shape
    Xs, truth = make_blobs(res, 0, n_s, d_s, n_clusters=k_s)
    vals = Xs.reshape(-1)
    vh = stats.value_histogram(res, vals, 64)
    inputs = k9_inputs(gen, Y[:hist_rows], Xs, truth, k_s)
    check(torch.equal(vh, torch.bincount(
        inputs["value_histogram"][0][:, 0], minlength=64).to(torch.int32)),
        "value_histogram differs from torch.bincount")
    k9_rows = {tag: k9_case(tag, *inp) for tag, inp in inputs.items()}
    k9_rows["main"] = k9_rows.pop("columns")
    colb = inputs["columns"][0]
    k9_edge_checks(gen)
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
    del colb, via, vals, Y, inputs
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
        if tag == "first":
            # the stats path's own launch shape, timed beside its bound
            bound, by = k8_bound_ms("l1", q.shape[0], n_s, Xs.shape[1])
            sil_chunks[tag].update(
                ms=cuda_ms(lambda: k8.unexpanded_pairwise_tiled(
                    q, Xs, DistanceType.L1), 10),
                bound_ms=bound, bound_by=by,
                shape=[q.shape[0], n_s, Xs.shape[1]])
            print(f"K8 at the stats path's chunk shape {q.shape[0]} × {n_s} "
                  f"× {Xs.shape[1]} l1: ms={sil_chunks[tag]['ms']} "
                  f"bound_ms={bound} ({by})", flush=True)
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
                "kernel_ms": main9["kernel_ms"], "form": main9["form"],
                "bench_prims": k9_rows["bench_prims"],
                "value_histogram": k9_rows["value_histogram"],
                "labels": k9_rows["labels"]}
    report["k8"], report["k9"] = k8_rows, k9_rows
    return report, [k8_entry, k9_entry]


# ---------------------------------------------------------- phases 12-13
#: phase 12b: select_k_matrix.py:64-82's largest cells (rows, length, k)
SELECT_CELLS = ((256, 1_048_576, 16), (256, 1_048_576, 64),
                (256, 1_048_576, 256), (64, 10_485_760, 64))
#: phase 13: ann-benchmarks' gist-960-euclidean shape (rows, d, queries,
#: k), as make_blobs with bench.py's recipe (64 clusters, std 2.0)
WIDE_SHAPE = (1_000_000, 960, 1000, 100)
#: phase 13: the unpacked geometry of the reference's own test
#: (tests/test_knn_fused.py:526-534)
UNPACKED_T, UNPACKED_G = 512, 4096


def k1_k2_twins(gen, d: int, Q: int = 500, tiles: int = 65, Q2: int = 300,
                groups: int = 4, T: int = 2048, g: int = 16, pbits: int = 8):
    """Phase 2's first half at one width d: K1 against its twin at Q
    queries (not a whole number of the kernel's 128-query blocks) ×
    ``tiles``·T rows (a partial last group) with a padded tail of 100
    rows, passes {1, 3} × pair {False, True} (``compare_k1``); then K2 at
    Q2 × ``groups`` whole groups of int8 rows, quantized as
    prepare_knn_index(db_dtype="int8") does, with a padded tail, the same
    four modes (``compare_k2``). Each launch must be counted. Returns
    {tag: max abs error}."""
    import torch
    from raft_tpu_torch.distance.knn_fused import _prepare_ops_q8
    from raft_tpu_torch.ops import fused_l2_topk as k1

    out_errs = {}
    M = tiles * T
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
            tag = f"K1 d={d} p{passes} pair={pair}"
            out_errs[tag] = err
            print(f"K1 vs twin Q={Q} M={M} d={d} passes={passes} "
                  f"pair={pair}: max_abs_err={err}", flush=True)
    del x, y, y_hi, y_lo, yyh, xxh, out, ref
    x = torch.randn(Q2, d, device="cuda", generator=gen)
    y = 2.0 * torch.randn(groups * g * T, d, device="cuda",
                          generator=gen) + 0.5
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
            out_errs[f"K2 d={d} p{passes} pair={pair}"] = err
            print(f"K2 vs twin Q={Q2} M={y_q.shape[0]} d={d} "
                  f"passes={passes} pair={pair}: max_abs_err={err} "
                  f"tie_slots={n_diff}", flush=True)
    del x, y, y_q, scales, yyh, xxh, out, ref
    torch.cuda.empty_cache()
    return out_errs


def dchunk_l2_bytes(Q: int, M: int, d: int, passes: int, T: int, g: int,
                    geo) -> float:
    """Bytes K1's d-chunked kernel moves from L2 into shared memory in
    geometry ``geo`` = (xres, stages, cluster), by a model (no counter
    measures them): y once a cluster of query blocks, x once a block
    (resident) or once a chunk (streamed), yyh once a block's chunk."""
    xres, _, cluster = geo
    xa = 2 if passes == 3 else 1
    blocks = -(-(-(-Q // 64)) // cluster) * cluster
    y = xa * M * d * 2 * blocks / cluster
    x = xa * 64 * d * 2 * blocks * (-(-(M // T) // g) if xres else M // 128)
    return y + x + blocks * M * 4


#: K1's d-chunked twins, (d, Q): every shipped geometry is reached, the
#: queries resident at passes=1 and streamed at passes=3 at both widths;
#: 300 queries are 5 blocks (one a cluster, the last one partial), 550 are
#: 9 (clusters of 2, the last one completed by a block that stores
#: nothing)
DCHUNK_TWINS = ((640, 300), (1024, 550))


def dchunk_twins(gen, d: int, Q: int, tiles: int = 40, T: int = 2048,
                 g: int = 16, pbits: int = 8):
    """K1's d-chunked form against its twin at width d: Q queries ×
    ``tiles``·T rows (a partial last group), a padded tail of 100 rows,
    +inf, −inf and NaN planted in query and index rows and a −inf norm;
    passes {1, 3} × pair {False, True}, each in the geometry the launcher
    picks (``fused_l2_topk.dchunk_geometry``). Non-finite slots equal the
    twin's in kind and finite ones hold ``finite_slots_close``'s bound.
    Each launch is counted. Returns ({tag: max abs error}, the (queries
    resident, cluster) pairs reached)."""
    import torch
    from raft_tpu_torch.ops import fused_l2_topk as k1

    inf, nan = float("inf"), float("nan")
    M = tiles * T
    x = torch.randn(Q, d, device="cuda", generator=gen)
    x[5, 3], x[77, 100], x[200, 0] = inf, -inf, nan
    y = torch.randn(M, d, device="cuda", generator=gen)
    y[1000, 7], y[40000, 50], y[70001, 1] = inf, -inf, nan
    y_hi, y_lo = k1.split_hi_lo(y)
    yyh = 0.5 * (y * y).sum(1)
    yyh[5] = -inf
    yyh[-100:] = k1._PACK_PAD
    xxh = 0.5 * (x * x).sum(1)
    live = torch.isfinite(y).all(1)
    ymax = y_hi.float()[live].norm(dim=1).max().item()
    yymax = yyh[torch.isfinite(yyh) & (yyh < 2.0 ** 123)].max().item()
    errs, reached = {}, set()
    for passes in (1, 3):
        geo = k1.dchunk_geometry(Q, d, passes)
        reached.add((geo[0], geo[2]))
        for pair in (False, True):
            kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits,
                      xxh=xxh)
            args = (x, y_hi, y_lo, yyh)
            n0 = k1.LAUNCHES_DCHUNK
            out = k1.fused_l2_group_topk_packed_dchunk(*args, **kw)
            torch.cuda.synchronize()
            check(k1.LAUNCHES_DCHUNK == n0 + 1, "K1 dchunk launch was not "
                  "counted")
            ref = k1.fused_l2_group_topk_packed_dchunk_ref(*args, **kw)
            tag = f"K1 dchunk Q={Q} d={d} p{passes} pair={pair}"
            kinds = same_in_kind(out, ref, tag)
            errs[tag] = finite_slots_close(out, ref, x, ymax, yymax, pbits,
                                           pair, tag)
            del out, ref
            print(f"{tag} (geometry {geo}, ±inf/NaN planted): "
                  f"max_abs_err={errs[tag]} {json.dumps(kinds)}",
                  flush=True)
    k1.LAUNCHES_DCHUNK = 0
    torch.cuda.empty_cache()
    return errs, reached


def dchunk_twins_all(gen):
    """``dchunk_twins`` at every case of ``DCHUNK_TWINS``; fails unless
    they reach every (queries resident, cluster of 1 or 2) the launcher
    ships. Returns {tag: max abs error}."""
    errs, reached = {}, set()
    for d, Q in DCHUNK_TWINS:
        e, r = dchunk_twins(gen, d, Q)
        errs.update(e)
        reached |= r
    want = {(xres, c) for xres in (True, False) for c in (1, 2)}
    check(reached == want, f"K1 dchunk twins reached the geometries "
          f"{sorted(reached)}, not every shipped one {sorted(want)}")
    return errs


def nonfinite_k1_k2(gen, Q: int = 500, M: int = 131072, d: int = 128,
                    T: int = 2048, g: int = 16, pbits: int = 8):
    """Phase 2's second half: K1 and K2 against their twins with +inf,
    −inf and NaN planted in query rows and index rows (K2: in the rows'
    half-norm carrier, its codes being int8). Non-finite slots must equal
    the twin's in kind; finite slots hold ``finite_slots_close``'s bound.
    Returns {form: the twin's non-finite slots by kind}."""
    import torch
    from raft_tpu_torch.distance.knn_fused import _prepare_ops_q8
    from raft_tpu_torch.ops import fused_l2_topk as k1

    inf, nan = float("inf"), float("nan")
    x = torch.randn(Q, d, device="cuda", generator=gen)
    x[5, 3], x[77, 100], x[300, 0] = inf, -inf, nan
    y = torch.randn(M, d, device="cuda", generator=gen)
    y[1000, 7], y[70000, 50], y[99999, 1] = inf, -inf, nan
    y_hi, y_lo = k1.split_hi_lo(y)
    yyh = 0.5 * (y * y).sum(1)
    yyh[5] = -inf                 # chunk 0 (code 0): the slot stays −inf
    yyh[-100:] = k1._PACK_PAD
    xxh = 0.5 * (x * x).sum(1)
    y_q, scales = _prepare_ops_q8(torch.nan_to_num(y, 0.0, 0.0, 0.0), T, g,
                                  "l2")[1:3]
    grp = torch.arange(M, device="cuda") // (g * T)
    live = torch.isfinite(y).all(1)
    ymax = {False: y_hi.float()[live].norm(dim=1).max().item(),
            True: (y_q.float() * scales[grp][:, None])[live].norm(
                dim=1).max().item()}
    yymax = yyh[torch.isfinite(yyh) & (yyh < 2.0 ** 123)].max().item()
    report = {}
    n0, n8 = k1.LAUNCHES, k1.LAUNCHES_Q8
    for q8 in (False, True):
        for passes in (1, 3):
            for pair in (False, True):
                kw = dict(T=T, g=g, passes=passes, pair=pair, pbits=pbits,
                          xxh=xxh)
                if q8:
                    args = (x, y_q, yyh, scales)
                    out = k1.fused_l2_group_topk_packed_q8(*args, **kw)
                    ref = k1.fused_l2_group_topk_packed_q8_ref(*args, **kw)
                else:
                    args = (x, y_hi, y_lo, yyh)
                    out = k1.fused_l2_group_topk_packed(*args, **kw)
                    ref = k1.fused_l2_group_topk_packed_ref(*args, **kw)
                tag = f"{'K2' if q8 else 'K1'} p{passes} pair={pair}"
                report[tag] = same_in_kind(out, ref, tag)
                report[tag]["max_abs_err"] = finite_slots_close(
                    out, ref, x, ymax[q8], yymax, pbits, pair, tag)
                print(f"{tag} with ±inf/NaN planted: "
                      f"{json.dumps(report[tag])}", flush=True)
    k1.LAUNCHES, k1.LAUNCHES_Q8 = n0, n8
    return report


def inf_row_knn(gen, M: int = 65536, d: int = 128, Q: int = 64,
                k: int = 16):
    """Phase 2's end to end ±inf check: ``knn_fused`` over an index that
    holds a +inf and a −inf row, on the card (K1 / K2 and the exact fixup)
    and on the CPU (their twins), bf16 and int8 at passes 1 and 3. Every
    query fails the certificate; the two answers must agree, ids exactly
    and values within 1e-5 with NaN in place, and the ±inf rows must be
    in them. Returns {mode: NaN slots, failed queries}."""
    import torch
    from raft_tpu_torch.distance.knn_fused import knn_fused, \
        prepare_knn_index
    from raft_tpu_torch.ops import fused_l2_topk as k1

    y = torch.randn(M, d, device="cuda", generator=gen)
    y[7, 3], y[40000, 9] = float("inf"), -float("inf")
    x = torch.randn(Q, d, device="cuda", generator=gen)
    report = {}
    n0, n8 = k1.LAUNCHES, k1.LAUNCHES_Q8
    for db in ("bf16", "int8"):
        for passes in (1, 3):
            idx = prepare_knn_index(y, passes=passes, db_dtype=db)
            v, i, n_fail = knn_fused(x, idx, k, with_stats=True)
            cidx = prepare_knn_index(y.cpu(), passes=passes, db_dtype=db,
                                     device="cpu")
            cv, ci = knn_fused(x.cpu(), cidx, k)
            tag = f"{db} p{passes}"
            v, i = v.cpu(), i.cpu()
            check(torch.equal(i, ci), f"inf_row_knn {tag}: ids differ "
                  f"from the CPU twins' ({(i != ci).sum().item()} slots)")
            nan = torch.isnan(cv)
            check(torch.equal(torch.isnan(v), nan) and torch.allclose(
                v[~nan], cv[~nan], rtol=1e-5, atol=1e-5),
                f"inf_row_knn {tag}: values differ from the CPU twins'")
            check(bool(nan.any()) and bool(torch.isin(
                i[nan], torch.tensor([7, 40000], dtype=i.dtype)).all()),
                f"inf_row_knn {tag}: the ±inf rows are not in the answer")
            report[tag] = {"nan_slots": int(nan.sum()), "n_fail": n_fail}
    k1.LAUNCHES, k1.LAUNCHES_Q8 = n0, n8
    print(f"inf_row_knn: {json.dumps(report)}", flush=True)
    return report


def finite_slots_close(out, ref, x, ymax: float, yymax: float, pbits: int,
                       pair: bool, tag: str):
    """Where the twin's slot is finite, the kernel's value (code bits
    cleared) lies within the f32 summation bound 2·(d + 2)·2⁻²⁴·‖x‖·max‖y‖
    (max over the finite rows; for K2 the dequantized rows), four units of
    the norm terms' rounding and two of the packing truncation; the codes
    of a1/a2 agree on ≥ 99.9% of those slots. Returns the max abs error."""
    import torch

    d = x.shape[1]
    xn = torch.nan_to_num(x.norm(dim=1), nan=0.0, posinf=0.0)
    acc = (2.0 * (d + 2) * 2.0 ** -24 * xn * ymax
           + 4.0 * 2.0 ** -24 * (yymax + 0.5 * xn * xn))[:, None]
    err = 0.0
    for n, (a, b) in enumerate(zip(out, ref)):
        fin = torch.isfinite(b)
        ca, va = unpack(a, pbits)
        cb, vb = unpack(b, pbits)
        diff = torch.where(fin, (va - vb).abs(), 0.0)
        tol = torch.where(fin, acc + 2.0 * 2.0 ** (pbits - 23) * vb.abs(),
                          0.0)
        check(bool((diff <= tol).all()), f"{tag}: finite values of output "
              f"{n} differ by up to {diff.max().item()}")
        if n < 2 or not pair:
            same = (ca == cb)[fin].float().mean().item()
            check(same >= 0.999, f"{tag}: codes of output {n} agree on "
                  f"only {same:.5f} of the finite slots")
        err = max(err, diff.max().item())
    torch.cuda.synchronize()
    return err


def same_in_kind(out, ref, tag: str):
    """NaN where the twin has NaN, +inf and −inf where it has them.
    Returns the counts of each kind over the outputs."""
    import torch

    counts = {"nan": 0, "+inf": 0, "-inf": 0}
    for n, (a, b) in enumerate(zip(out, ref)):
        for kind, f in (("nan", torch.isnan),
                        ("+inf", lambda t: t == float("inf")),
                        ("-inf", lambda t: t == -float("inf"))):
            fa, fb = f(a), f(b)
            check(bool(torch.equal(fa, fb)),
                  f"{tag}: output {n} has {kind} at {int((fa != fb).sum())} "
                  f"slots where the twin does not, or the reverse")
            counts[kind] += int(fb.sum())
    return counts


def k1_counts():
    from raft_tpu_torch.ops import fused_l2_topk as k1

    return {"K1": k1.LAUNCHES, "K1_dchunk": k1.LAUNCHES_DCHUNK,
            "K1_group": k1.LAUNCHES_GROUP,
            "K1_group_dchunk": k1.LAUNCHES_GROUP_DCHUNK}


def zero_k1_counts():
    from raft_tpu_torch.ops import fused_l2_topk as k1

    k1.LAUNCHES = k1.LAUNCHES_DCHUNK = 0
    k1.LAUNCHES_GROUP = k1.LAUNCHES_GROUP_DCHUNK = 0


def k3_bound_ms(B: int, L: int, T: int, tpg: int):
    """Least time for K3's work: the rows read once and the three pools
    written once at the HBM rate (its ~10 operations a value are some 30×
    below that)."""
    G = -(-(-(-L // T)) // tpg)
    return 1e3 * (B * L * 4 + 3 * B * G * 128 * 4) / H100_BYTES_PER_S, \
        "bytes"


def compare_k3(out, ref, tag: str):
    """K3 against its twin: the same min/max network over the same packed
    values, so bit for bit on every slot where the twin is not NaN, and
    NaN exactly where it is (a NaN's payload may differ: PTX returns the
    canonical NaN). Returns the twin's NaN slots."""
    import torch

    n_nan = 0
    for n, (a, b) in enumerate(zip(out, ref)):
        na, nb = torch.isnan(a), torch.isnan(b)
        check(bool(torch.equal(na, nb)), f"K3 {tag}: output {n} is NaN at "
              f"{int((na != nb).sum())} slots where the twin is not, or "
              f"the reverse")
        diff = int((a.view(torch.int32) != b.view(torch.int32))[~nb].sum())
        check(diff == 0, f"K3 {tag}: output {n} differs from the twin at "
              f"{diff} slots")
        n_nan += int(nb.sum())
    torch.cuda.synchronize()
    return n_nan


def signed_rows(L: int, seed: int, rows: int = 136):
    """[rows, L] f32 (numpy): N(0, 1) rows, then 8 rows of small integers
    (exact ties) with ±0, ±inf, +NaN and −NaN planted; the first of them
    is zeros of both signs with three 2s, a +NaN and a −NaN, the second a
    run of tied maxima."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nan_p = np.uint32(0x7FC00000).view(np.float32)
    nan_n = np.uint32(0xFFC00000).view(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, nan_p, nan_n],
                        np.float32)
    v = rng.normal(size=(rows, L)).astype(np.float32)
    t = rng.integers(-3, 4, (8, L)).astype(np.float32)
    where = rng.random((8, L)) < 0.1
    t[where] = rng.choice(specials, int(where.sum()))
    t[0] = np.where(rng.random(L) < 0.5, 0.0, -0.0)
    t[0, rng.choice(L, 3, replace=False)] = 2.0
    t[0, [L // 3, L // 2]] = nan_p, nan_n
    t[1, ::7] = 3.0
    v[rows - 8:] = t
    return v


def same_selection(tag: str, got, want):
    """Ids equal and values equal bit for bit (a card result against the
    same call on the CPU)."""
    import torch

    (gv, gi), (wv, wi) = got, want
    check(torch.equal(gi.cpu().long(), wi.long())
          and torch.equal(gv.cpu().contiguous().view(torch.int32),
                          wv.contiguous().view(torch.int32)),
          f"{tag}: the card's ids or value bits differ from the same call "
          f"on the CPU")


def signed_select_checks(res):
    """Phase 12e: the selections that rank the largest (select_min=False)
    by sign-flipped bits, on rows with exact ties, ±0, ±inf, +NaN and −NaN,
    on the card against the same call on the CPU (which the CPU tests hold
    bit for bit to the reference): ``select_k_slotted`` through K3 (L =
    16384) and the slot fold (L = 2048), its certified fallback (rows of
    ±0 holding ±NaN), ``select_k`` AUTO, and the streamed inner-product
    sweep's merge (``_merge_topk`` with and without ``unsure``) and its
    ``_sweep`` over crafted tiles. Returns the rows each path re-solved."""
    import numpy as np
    import torch
    from raft_tpu_torch.distance import fused_l2nn as fl
    from raft_tpu_torch.matrix import select_k
    from raft_tpu_torch.matrix.select_k_slotted import select_k_slotted
    from raft_tpu_torch.ops import select_slotted as k3

    out = {}
    n0 = k3.LAUNCHES
    for L, k in ((16384, 16), (16384, 100), (2048, 8)):
        v = torch.from_numpy(signed_rows(L, L + k))
        gv, gi, n_fail = select_k_slotted(v.cuda(), None, k, False,
                                          with_stats=True)
        same_selection(f"select_k_slotted L={L} k={k} select_min=False",
                       (gv, gi), select_k_slotted(v, None, k, False))
        check(n_fail >= 1, f"select_k_slotted L={L}: no row re-solved")
        out[f"slotted_L{L}_k{k}_n_fail"] = n_fail
        same_selection(f"select_k AUTO L={L} k={k} select_min=False",
                       select_k(res, v.cuda(), k=k, select_min=False),
                       select_k(None, v, k=k, select_min=False))
    rng = np.random.default_rng(5)
    for L in (16384, 2048):
        z = np.where(rng.random((136, L)) < 0.5, 0.0, -0.0).astype(
            np.float32)
        z[:, 3] = np.uint32(0x7FC00000).view(np.float32)
        z[:, L - 5] = np.uint32(0xFFC00000).view(np.float32)
        v = torch.from_numpy(z)
        gv, gi, n_fail = select_k_slotted(v.cuda(), None, 12, False,
                                          with_stats=True)
        same_selection(f"select_k_slotted fallback rows of ±0/±NaN L={L}",
                       (gv, gi), select_k_slotted(v, None, 12, False))
        out[f"fallback_L{L}_n_fail"] = n_fail
    k3.LAUNCHES = n0
    # the streamed ip sweep: its merge, then a sweep over crafted tiles
    k, tile, n_tiles = 12, 40, 6
    t = torch.from_numpy(signed_rows(k + tile * n_tiles, 9, rows=16))
    ids = torch.arange(t.numel(), dtype=torch.int32).reshape(t.shape)
    for unsure in (False, True):
        def merge(dev):
            u = torch.zeros(16, dtype=torch.bool, device=dev) if unsure \
                else None
            v, i = fl._merge_topk(t[:, :k].to(dev), ids[:, :k].to(dev),
                                  t[:, k:].to(dev), ids[:, k:].to(dev), k,
                                  False, u)
            return v, i, u
        gv, gi, gu = merge("cuda")
        wv, wi, wu = merge("cpu")
        sure = torch.ones(16, dtype=torch.bool)
        if unsure:
            # the first k of a row not marked unsure are exact; what
            # follows them, and unsure rows, are swept again
            check(torch.equal(gu.cpu(), wu), "_merge_topk: the card marks "
                  "other rows unsure than the CPU")
            sure = ~wu
        same_selection(f"_merge_topk select_min=False unsure={unsure}",
                       (gv[:, :k][sure.cuda()], gi[:, :k][sure.cuda()]),
                       (wv[:, :k][sure], wi[:, :k][sure]))

    def sweep(dev):
        tiles = t[:, k:].to(dev)

        def tile_fn(i):
            return (tiles[:, i * tile:(i + 1) * tile],
                    torch.arange(i * tile, (i + 1) * tile, device=dev,
                                 dtype=torch.int32))
        return fl._sweep(tile_fn, n_tiles, 16, k, False, torch.device(dev))
    same_selection("the streamed ip sweep (_sweep) select_min=False",
                   sweep("cuda"), sweep("cpu"))
    print(f"select_min=False on ±0/±NaN tied rows, card against CPU: "
          f"{json.dumps(out)}", flush=True)
    return out


def select_k_phase(res, cells=SELECT_CELLS, k3_shape=(256, 1_048_576),
                   blobs=(100_000, 128, 16), ragged=(37, 70_001)):
    """Phase 12 (see the module doc): K3 against its twin bit for bit,
    ``select_k(algo=SLOTTED)`` at ``cells`` with the K3 count zeroed
    before each and read after, and the reference's alias names once.
    Returns (the ``select_k`` report, K3's ``kernels`` entry)."""
    import torch
    from raft_tpu_torch.matrix import SelectAlgo, select_k
    from raft_tpu_torch.matrix.select_k_slotted import (_T_SEL,
                                                        select_k_slotted,
                                                        slotted_envelope)
    from raft_tpu_torch.ops import select_slotted as k3
    from raft_tpu_torch.random import make_blobs

    inf, nan = float("inf"), float("nan")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    report = {"k3_vs_twin": {}, "cells": {}, "aliases": {}}

    # ---- 12a: K3 against its twin ----
    v = torch.randn(*k3_shape, device="cuda", generator=gen)
    X, _ = make_blobs(res, 12, blobs[0], blobs[1], n_clusters=blobs[2])
    vb = X[:blobs[0] // 64 * 64].reshape(-1, blobs[1] * 64)
    vr = torch.randn(*ragged, device="cuda", generator=gen)
    for r, c, val in ((3, 5, inf), (3, 9000, inf), (10, 40000, -inf),
                      (20, 128, -inf), (30, ragged[1] - 1, nan),
                      (36, 1, nan)):
        vr[r, min(c, ragged[1] - 1)] = val
    n0 = k3.LAUNCHES
    for tag, t, tpg in ((f"N(0,1) {tuple(v.shape)} tpg=4", v, 4),
                        (f"N(0,1) {tuple(v.shape)} tpg=1", v, 1),
                        (f"bench_prims blobs {tuple(vb.shape)} tpg=4", vb,
                         4),
                        (f"ragged ±inf/NaN {tuple(vr.shape)} tpg=4", vr, 4),
                        (f"ragged ±inf/NaN {tuple(vr.shape)} tpg=1", vr,
                         1)):
        out = k3.select_slot_topk_packed(t, T=_T_SEL, tpg=tpg)
        ref = k3.select_slot_topk_packed_ref(t, T=_T_SEL, tpg=tpg)
        report["k3_vs_twin"][tag] = {"bit_for_bit": True,
                                     "nan_slots": compare_k3(out, ref, tag)}
        print(f"K3 vs twin {tag}: {json.dumps(report['k3_vs_twin'][tag])}",
              flush=True)
    del out, ref, X, vr
    k3.LAUNCHES = n0

    # ---- 12b: select_k(SLOTTED) at the matrix's largest cells ----
    k3_rows, launches = {}, 0
    for B, L, k in cells:
        if tuple(v.shape) != (B, L):
            del v
            torch.cuda.empty_cache()
            v = torch.randn(B, L, device="cuda", generator=gen)
        tag = f"{B}x{L} k={k}"
        k3.LAUNCHES = 0
        vals, ids = select_k(res, v, k=k, algo=SelectAlgo.SLOTTED)
        torch.cuda.synchronize()
        n_launch = k3.LAUNCHES
        check(n_launch > 0, f"select_k SLOTTED {tag}: K3 launched no time")
        launches += n_launch
        ref_v, _ = torch.topk(v, k, dim=1, largest=False, sorted=True)
        check(bool(torch.equal(vals, ref_v)),
              f"select_k SLOTTED {tag}: values differ from torch.topk's")
        check(bool(torch.equal(torch.gather(v, 1, ids.long()), vals))
              and bool((torch.sort(ids, 1).values.diff(dim=1) > 0).all()),
              f"select_k SLOTTED {tag}: ids do not name the values once "
              f"each (not a tie)")
        _, _, n_fail = select_k_slotted(v, None, k, True, with_stats=True)
        times = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            select_k(res, v, k=k, algo=SelectAlgo.SLOTTED)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        tpg = slotted_envelope(L, k)[1]
        key = (B, L, tpg)
        if key not in k3_rows:
            bound, by = k3_bound_ms(B, L, _T_SEL, tpg)
            k3_rows[key] = {
                "ms": cuda_ms(lambda: k3.select_slot_topk_packed(
                    v, T=_T_SEL, tpg=tpg), 10),
                "plain_ms": cuda_ms(lambda: k3.select_slot_topk_packed_ref(
                    v, T=_T_SEL, tpg=tpg), 1, warmup=0),
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "shape": [B, L], "tpg": tpg}
        row = {"ms": 1e3 * statistics.median(times[1:]), "n_fail": n_fail,
               "launches": n_launch, "tpg": tpg,
               "k3_ms": k3_rows[key]["ms"],
               "k3_bound_ms": k3_rows[key]["bound_ms"],
               "topk_ms": cuda_ms(lambda: torch.topk(
                   v, k, dim=1, largest=False, sorted=True), 5),
               "values_equal_topk": True}
        report["cells"][tag] = row
        print(f"select_k SLOTTED {tag}: {json.dumps(row)}", flush=True)

    # ---- 12c: the reference's names once each ----
    v = torch.randn(256, 1_048_576, device="cuda", generator=gen)
    ref_v, _ = torch.topk(v, 64, dim=1, largest=False, sorted=True)
    for algo in (SelectAlgo.BITONIC, SelectAlgo.CHUNKED, SelectAlgo.RADIX):
        k3.LAUNCHES = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals, ids = select_k(res, v, k=64, algo=algo)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        check(bool(torch.equal(vals, ref_v))
              and bool(torch.equal(torch.gather(v, 1, ids.long()), vals)),
              f"select_k {algo.name}: values differ from torch.topk's")
        report["aliases"][algo.name] = {"ms_first_call": ms,
                                        "k3_launches": k3.LAUNCHES}
        launches += k3.LAUNCHES if algo == SelectAlgo.BITONIC else 0
    print(f"select_k aliases at 256x1048576 k=64: "
          f"{json.dumps(report['aliases'])}", flush=True)
    del v, ref_v, vals, ids
    torch.cuda.empty_cache()
    k3.LAUNCHES = 0

    # ---- 12d: AUTO (the XLA_TOPK order) on tied integer rows ----
    from raft_tpu_torch.core.kvp import smallest_by_key

    vt = torch.randint(0, 4, k3_shape, device="cuda",
                       generator=gen).float()
    vn = torch.randn(*k3_shape, device="cuda", generator=gen)
    vt[5, 100], vt[9, 7], vt[17, 3], vt[17, 4] = nan, -nan, inf, -0.0
    report["auto"] = {}
    for k in (16, 64, 256):
        for select_min in (True, False):
            vals, ids = select_k(res, vt, k=k, select_min=select_min)
            want_v, want_i = smallest_by_key(vt, k,
                                             descending=not select_min)
            check(torch.equal(ids.long(), want_i)
                  and torch.equal(vals.view(torch.int32),
                                  want_v.view(torch.int32)),
                  f"select_k AUTO k={k} select_min={select_min}: not "
                  f"smallest_by_key's order on tied rows")
        row = {}
        for name, t in (("normal", vn), ("tied_integers", vt)):
            times = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                select_k(res, t, k=k)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            row[f"ms_{name}"] = 1e3 * statistics.median(times[1:])
        report["auto"][k] = row
    print(f"select_k AUTO at {list(k3_shape)} (ids equal to "
          f"smallest_by_key's on tied integer rows with ±0, ±inf, ±NaN): "
          f"{json.dumps(report['auto'])}", flush=True)
    del vt, vn

    # ---- 12e: select_min=False on ±0/±NaN tied rows, card against CPU
    report["signed"] = signed_select_checks(res)

    main_key = (k3_shape[0], k3_shape[1], 4)
    main = k3_rows.get(main_key) or next(iter(k3_rows.values()))
    k3_entry = {"name": "select_slot_topk_packed", "route": "cuda",
                "source": "raft_tpu_torch/ops/csrc/select_slotted.cu",
                "replaces": "raft_tpu/ops/select_slotted_pallas.py:67",
                "launches": launches,
                **{k: main[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
                "max_abs_err": 0.0, "shape": main["shape"],
                "library_note": "no one PyTorch call computes the packed "
                                "fold; torch.topk of the path is in the "
                                "select_k cells",
                "other_shapes": [r for kk, r in k3_rows.items()
                                 if kk != main_key]}
    report["k3"] = list(k3_rows.values())
    return report, k3_entry


def compare_unpacked(out, ref, x, y_hi, y_lo, yyh, passes: int):
    """The unpacked form against its twin: values within the f32
    summation bound 2·d·2⁻²⁴·‖x‖·max‖y‖ plus two units of the half-score's
    rounding, non-finite slots equal in kind; where an id differs, both
    rows score within twice that bound in f64 (a tie). Returns (max abs
    value error, slots whose ids differ)."""
    import torch

    d = x.shape[1]
    ymax = y_hi.float().norm(dim=1).max()
    acc = (2.0 * d * 2.0 ** -24 * x.norm(dim=1) * ymax)[:, None]
    same_in_kind([out[0], out[2], out[4]], [ref[0], ref[2], ref[4]],
                 "unpacked")
    err = 0.0
    for n in (0, 2, 4):
        a, b = out[n], ref[n]
        fin = torch.isfinite(b)
        tol = acc + 2.0 * 2.0 ** -24 * b.abs()
        diff = torch.where(fin, (a - b).abs(), 0.0)
        check(bool((diff <= torch.where(fin, tol, 0.0)).all()),
              f"unpacked values of output {n} differ by up to "
              f"{diff.max().item()}")
        err = max(err, diff.max().item())
    xh = x.to(torch.bfloat16)
    xl = (x - xh.float()).to(torch.bfloat16)
    n_diff = 0
    for n in (1, 3):
        q_idx, s_idx = (out[n] != ref[n]).nonzero(as_tuple=True)
        n_diff += int(q_idx.numel())
        if not q_idx.numel():
            continue

        def score(r):
            r = r.long()
            s = (xh[q_idx].double() * y_hi[r].double()).sum(1)
            if passes == 3:
                s += (xh[q_idx].double() * y_lo[r].double()).sum(1)
                s += (xl[q_idx].double() * y_hi[r].double()).sum(1)
            return yyh[r].double() - s
        ra, rb = out[n][q_idx, s_idx], ref[n][q_idx, s_idx]
        check(bool((ra >= 0).all() and (rb >= 0).all()),
              f"unpacked ids of output {n}: −1 on one side only")
        gap = (score(ra) - score(rb)).abs()
        tol = 2 * (acc[q_idx, 0] + 4.0 * 2.0 ** -24
                   * ref[n - 1][q_idx, s_idx].abs()).double()
        check(bool((gap <= tol).all()),
              f"unpacked ids of output {n}: {int(q_idx.numel())} slots name "
              f"other rows than the twin's, up to {gap.max().item()} apart")
    torch.cuda.synchronize()
    return err, n_diff


def expanded_floor(X, Qx):
    """[Q] rounding of the expanded f32 score xx + yy − 2·x·y that the
    oracle and the rescore both rank by: 16·2⁻²⁴ of the norms. At d = 960
    the norms (~7·10⁴) dwarf the k-th distances (~7·10³), so two rows
    within it are a tie (as ``ann_data``'s floor)."""
    return 16 * 2.0 ** -24 * ((Qx * Qx).sum(1) + (X * X).sum(1).max())


def knn_cell(res, name: str, index, Qx, k: int, certify: str, X, o_vals,
             o_ids, counter: str, exact: bool = True):
    """One ``distance.knn`` run on a prepared index with the K1 counts
    zeroed before and read after; the result held against the oracle
    (recall ≥ 0.99, or ids identical up to ties proven within
    ``expanded_floor``), then n_fail, the host-clock median of five and
    the GB/s of the [Q, M] f32 matrix."""
    import torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.distance.knn_fused import knn_fused

    zero_k1_counts()
    vals, ids = distance.knn(res, index, Qx, k=k, certify=certify)
    torch.cuda.synchronize()
    counts = k1_counts()
    check(counts[counter] > 0, f"{name}: the path launched {counter} no "
          f"time ({counts})")
    nq = Qx.shape[0]
    check(tuple(vals.shape) == (nq, k) and bool(torch.isfinite(vals).all()),
          f"{name}: results are not finite [Q, k]")
    if exact:
        quality = {"ids_exact": True,
                   "tie_queries": check_exact(ids, o_ids, o_vals, X, Qx,
                                              name,
                                              expanded_floor(X, Qx)),
                   "max_abs_val_err": (vals - o_vals).abs().max().item()}
    else:
        got, want = ids.cpu().tolist(), o_ids.cpu().tolist()
        recall = sum(len(set(a) & set(b)) for a, b in zip(got, want)) \
            / (nq * k)
        check(recall >= 0.99, f"{name}: recall {recall} < 0.99")
        quality = {"recall": recall}
    _, _, n_fail = knn_fused(Qx, index, k, certify=certify, with_stats=True)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        distance.knn(res, index, Qx, k=k, certify=certify)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    ms = 1e3 * statistics.median(times[1:])
    row = {"ms": ms, "gbps": nq * index.n_rows * 4.0 / (ms * 1e-3) / 1e9,
           "n_fail": n_fail, "kernel": counter,
           "launches": counts[counter], **quality}
    print(f"{name}: {json.dumps(row)}", flush=True)
    return row


def padded_queries(index, Qx):
    """The queries as the core sees them: padded to the stream width."""
    import torch

    pad = index.stream_width - Qx.shape[1]
    return torch.cat([Qx, Qx.new_zeros((Qx.shape[0], pad))], 1) if pad \
        else Qx


def same_bits(a, b) -> bool:
    """Equal bit for bit, any NaN matching any NaN (ids: equal)."""
    import torch

    if a.dtype != torch.float32:
        return bool(torch.equal(a, b))
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def unpacked_kernel_row(index, Qx, reps: int = 3):
    """The unpacked form (or its d-chunked form) on a path's own inputs:
    at the segment count S its wrapper chooses (``ops.fused_l2_topk.
    group_segments``; read back from the summaries it kept) and at S = 1,
    bit for bit equal to each other; at S > 1 the merge
    kernel bit for bit equal to ``merge_segments`` (the split twin's
    merge) over the kernel's own segment summaries; against its twin
    (``compare_unpacked``); then both S timed beside the twin, the bound
    and the bf16 product of the same shape. Its launches here are not
    counted."""
    import torch
    from raft_tpu_torch.ops import fused_l2_topk as k1

    x = padded_queries(index, Qx)
    wide = x.shape[1] > 512
    kern = k1.fused_l2_group_topk_dchunk if wide else k1.fused_l2_group_topk
    twin = (k1.fused_l2_group_topk_dchunk_ref if wide
            else k1.fused_l2_group_topk_ref)
    args = (x, index.y_hi, index.y_lo, index.yyh_k)
    kw = dict(T=index.T, g=index.g, passes=index.passes)
    M = index.prepared_rows
    counts = k1_counts()
    out, part = k1._group(*args, index.T, index.g, index.passes, wide,
                          None, keep_part=True)
    segs = 1 if part is None else part[0].shape[0]
    S = out[0].shape[1]                    # n_groups·128 buckets a query
    one = kern(*args, **kw, segments=1)
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for a, b in zip(out, one)),
          f"unpacked S={segs} and S=1 differ (not bit for bit)")
    if part is not None:
        merged = k1.merge_segments(part)
        check(all(same_bits(a, b) for a, b in zip(out, merged)),
              f"unpacked S={segs}: the merge kernel differs from the split "
              f"twin's merge of its own segment summaries")
        del merged
    del part, one
    hold = []
    plain_ms = cuda_ms(lambda: hold.append(twin(*args, **kw)), 1, warmup=0)
    err, n_diff = compare_unpacked(out, hold[0], x, index.y_hi, index.y_lo,
                                   index.yyh_k, index.passes)
    del out, hold
    ms = cuda_ms(lambda: kern(*args, **kw), reps)
    ms_one = cuda_ms(lambda: kern(*args, **kw, segments=1), reps)
    nq = x.shape[0]
    ops = 2.0 * nq * M * index.d_orig * (3 if index.passes == 3 else 1)
    nbytes = (nq * index.d_orig * 4 + M * index.d_orig * 2
              * (2 if index.passes == 3 else 1) + M * 4 + 5 * nq * S * 4)
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    xb = x.to(torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.matmul(xb, index.y_hi.T), 5)
    (k1.LAUNCHES, k1.LAUNCHES_DCHUNK, k1.LAUNCHES_GROUP,
     k1.LAUNCHES_GROUP_DCHUNK) = counts.values()
    return {"ms": ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms, "max_abs_err": err,
            "tie_slots": n_diff, "shape": [nq, M, index.d_orig],
            "passes": index.passes, "segments": segs,
            "ms_one_segment": ms_one,
            "library_note": MATMUL_NOTE}


# ------------------------------------------------ K1's slot forms, ladder
#: the reference's stage ladder (``benchmarks/profile_fused.py:146-165``)
#: runs its unpacked group and slot kernels at this fixed tile
LADDER_T = 2048


def slot_bound_ms(Q: int, M: int, d: int, T: int, passes: int):
    """Least time for a slot form's work: the bf16 products at the
    tensor-core peak, or x, the index rows, both norms read once and m1,
    i1 (8 bytes a slot) and m2min written once at the HBM rate."""
    S = M // T * 128
    ops = 2.0 * Q * M * d * (3 if passes == 3 else 1)
    nbytes = (Q * d * 4 + M * d * 2 * (2 if passes == 3 else 1) + M * 4
              + Q * 4 + 2 * Q * S * 4 + Q * 128 * 4)
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def compare_slot(out, ref, x, y_hi, y_lo, xx, yy, passes: int, track: bool,
                 tag: str):
    """A slot form against its twin. m1 and m2min: non-finite entries
    equal in kind, finite ones within K1's f32 summation bound taken for
    d2 = (xx + yy) − 2·x·y: twice 2·(d + 2)·2⁻²⁴·‖x‖·max‖y‖ plus four units
    of the norms' rounding, 4·2⁻²⁴·(xx + max yy), over the finite rows.
    i1: equal, except where both rows score within twice that bound in
    f64 (a tie); all 0 for the min-only form. Returns the twin's
    non-finite entries by kind, the max abs error and the slots whose ids
    differ."""
    import torch

    d = x.shape[1]
    live = torch.isfinite(y_hi.float()).all(1) & torch.isfinite(yy)
    ymax = y_hi.float()[live].norm(dim=1).max()
    yymax = yy[live].max()
    xn = torch.nan_to_num(x.norm(dim=1), nan=0.0, posinf=0.0)
    xxf = torch.nan_to_num(xx, nan=0.0, posinf=0.0)
    tol = (4.0 * (d + 2) * 2.0 ** -24 * xn * ymax
           + 4.0 * 2.0 ** -24 * (xxf + yymax))[:, None]
    report = same_in_kind([out[0], out[2]], [ref[0], ref[2]], tag)
    err = 0.0
    for n in (0, 2):
        a, b = out[n], ref[n]
        fin = torch.isfinite(b)
        diff = (torch.where(fin, a, 0.0) - torch.where(fin, b, 0.0)).abs()
        check(bool((diff <= tol).all()), f"{tag}: output {n} differs from "
              f"the twin by up to {diff.max().item()}")
        err = max(err, diff.max().item())
    report.update(max_abs_err=err, tie_slots=0)
    if not track:
        check(not bool(out[1].any()), f"{tag}: min-only i1 is not all 0")
        return report
    q_idx, s_idx = (out[1] != ref[1]).nonzero(as_tuple=True)
    if not q_idx.numel():
        return report
    check(bool(torch.isfinite(ref[0][q_idx, s_idx]).all()),
          f"{tag}: ids differ at a non-finite slot")
    xh = x.to(torch.bfloat16)
    xl = (x - xh.float()).to(torch.bfloat16)

    def score(r):
        r = r.long()
        s = (xh[q_idx].double() * y_hi[r].double()).sum(1)
        if passes == 3:
            s += (xh[q_idx].double() * y_lo[r].double()).sum(1)
            s += (xl[q_idx].double() * y_hi[r].double()).sum(1)
        return xx[q_idx].double() + yy[r].double() - 2 * s
    ra, rb = out[1][q_idx, s_idx], ref[1][q_idx, s_idx]
    check(bool((ra >= 0).all() and (rb >= 0).all()),
          f"{tag}: −1 on one side only")
    gap = (score(ra) - score(rb)).abs()
    check(bool((gap <= 2 * tol[q_idx, 0].double()).all()),
          f"{tag}: {int(q_idx.numel())} slots name other rows than the "
          f"twin's, up to {gap.max().item()} apart")
    report["tie_slots"] = int(q_idx.numel())
    return report


def slot_counts():
    from raft_tpu_torch.ops import fused_l2_topk as k1

    return k1.LAUNCHES_SLOT, k1.LAUNCHES_SLOT_DCHUNK


def set_slot_counts(c):
    from raft_tpu_torch.ops import fused_l2_topk as k1

    k1.LAUNCHES_SLOT, k1.LAUNCHES_SLOT_DCHUNK = c


def nonfinite_slot(gen, Q: int = 512, M: int = 131072, d: int = 128,
                   wide: int = 768, T: int = 2048):
    """Phase 2's slot half: both slot forms against their twins with +inf,
    −inf and NaN planted in three query rows and three index rows and a
    −inf norm, the last 100 rows padding (rows ≥ m_real): the resident
    form at passes 1/3 × mask × track, the d-chunked form at d = ``wide``
    (a multiple of its dc = 256) at passes 1/3, each launch counted.
    Returns {case: the twin's non-finite entries by kind, the max abs
    error and the tie slots}."""
    import torch
    from raft_tpu_torch.ops import fused_l2_topk as k1

    inf, nan = float("inf"), float("nan")
    saved = slot_counts()
    report = {}
    for dd in (d, wide):
        x = torch.randn(Q, dd, device=gen.device, generator=gen)
        x[5, 3], x[77, 100], x[300, 0] = inf, -inf, nan
        Md = M if dd == d else M // 2
        y = torch.randn(Md, dd, device=gen.device, generator=gen)
        y[1000 % Md, 7], y[70000 % Md, 50], y[99999 % Md, 1] = inf, -inf, nan
        y_hi, y_lo = k1.split_hi_lo(y)
        xx, yy = (x * x).sum(1), (y * y).sum(1)
        yy[5] = -inf
        m_real = Md - 100
        cases = ([(p, m, t) for p in (1, 3) for m in (True, False)
                  for t in (True, False)] if dd == d
                 else [(1, True, True), (3, True, True)])
        for passes, mask, track in cases:
            args = (x, y_hi, y_lo, xx, yy, m_real)
            kw = dict(T=T, Qb=256, passes=passes)
            n0 = slot_counts()
            if dd == d:
                kw.update(mask=mask, track=track)
                out = k1.fused_l2_slot_topk(*args, **kw)
                ref = k1.fused_l2_slot_topk_ref(*args, **kw)
                tag = f"slot p{passes} mask={mask} track={track}"
            else:
                out = k1.fused_l2_slot_topk_dchunk(*args, **kw)
                ref = k1.fused_l2_slot_topk_dchunk_ref(*args, **kw)
                tag = f"slot dchunk d={dd} p{passes}"
            torch.cuda.synchronize()
            check(sum(slot_counts()) == sum(n0) + 1,
                  f"{tag}: the launch was not counted")
            report[tag] = compare_slot(out, ref, x, y_hi, y_lo, xx, yy,
                                       passes, track, tag)
            check(report[tag]["nan"] > 0 and report[tag]["-inf"] > 0,
                  f"{tag}: the planted NaN / −inf reached no slot")
            print(f"{tag} with ±inf/NaN planted: {json.dumps(report[tag])}",
                  flush=True)
        del x, y, y_hi, y_lo, xx, yy, out, ref
    set_slot_counts(saved)
    return report


def k1_ladder(idx1, idx3, Qx, reps: int = 10):
    """The reference's K1 stage ladder (``benchmarks/profile_fused.py:
    146-165``) on the main path's operands: packed K1 at p1 (pair, the
    path's own launch) and p3, the unpacked group form at T = 2048 (p1,
    p3), the slot form at T = 2048 (p1, p3) and its min-only fold
    (track=False, p1), each timed by CUDA events beside its bound and
    ``torch.matmul`` in bf16 of the same [Q, d] × [d, M]. Every row but
    the unpacked one (mma.sync) runs the wgmma + TMA mainloop, so the
    min-only, slot and packed rows split K1's time between the
    contraction with a min, the argmin and 2nd min, and the group fold.
    First, outside
    the counts, the slot forms are held against their twins on these
    inputs; the slot counts are zeroed just before the timed ladder and
    read just after it. Returns (the ladder report, the slot form's
    ``kernels`` entry)."""
    import torch
    from raft_tpu_torch.ops import fused_l2_topk as k1

    x = Qx
    nq, d = x.shape
    xx = (x * x).sum(1)
    xxh = 0.5 * xx
    yy = idx1.yy_raw                      # exact norms, 0 on padded rows
    M, m_real, T = idx1.y_hi.shape[0], idx1.n_rows, LADDER_T
    y_hi, y_lo = idx3.y_hi, idx3.y_lo        # idx1's split is the same
    yyh_inf = torch.where(torch.arange(M, device=x.device) < m_real,
                          0.5 * yy, float("inf"))
    k1_saved = k1_counts()
    saved = slot_counts()

    # ---- the slot form against its twin on these inputs ----
    held = {}
    for name, passes, track in (("slot_p1", 1, True), ("slot_p3", 3, True),
                                ("slot_minonly", 1, False)):
        kw = dict(T=T, Qb=256, passes=passes, track=track)
        args = (x, y_hi, y_lo, xx, yy, m_real)
        out = k1.fused_l2_slot_topk(*args, **kw)
        ref = k1.fused_l2_slot_topk_ref(*args, **kw)
        held[name] = compare_slot(out, ref, x, y_hi, y_lo, xx, yy,
                                  passes, track, f"ladder {name}")
        del out, ref
        held[name]["plain_ms"] = cuda_ms(
            lambda: k1.fused_l2_slot_topk_ref(*args, **kw), 1, warmup=0)
        print(f"ladder {name} vs twin: {json.dumps(held[name])}",
              flush=True)
    torch.cuda.empty_cache()

    # ---- the timed ladder: the path the slot forms run on ----
    pk = dict(g=idx1.g, pbits=idx1.pbits, xxh=xxh)
    rows = {
        "kernel_pck_p1": (lambda: k1.fused_l2_group_topk_packed(
            x, y_hi, y_lo, idx1.yyh_k, T=idx1.T, passes=1, pair=True,
            **pk), k1_bound_ms(nq, M, d, -(-(M // idx1.T) // idx1.g) * 128,
                               1)),
        "kernel_pck_p3": (lambda: k1.fused_l2_group_topk_packed(
            x, y_hi, y_lo, idx1.yyh_k, T=idx1.T, passes=3, **pk),
            k1_bound_ms(nq, M, d, -(-(M // idx1.T) // idx1.g) * 128, 3))}
    S_grp = -(-(M // T) // idx1.g) * 128
    for p in (1, 3):
        ops = 2.0 * nq * M * d * (3 if p == 3 else 1)
        nbytes = (nq * d * 4 + M * d * 2 * (2 if p == 3 else 1) + M * 4
                  + 5 * nq * S_grp * 4)
        t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
        rows[f"kernel_grp_p{p}"] = (
            lambda p=p: k1.fused_l2_group_topk(x, y_hi, y_lo, yyh_inf, T=T,
                                               g=idx1.g, passes=p),
            (1e3 * max(t_ops, t_bytes),
             "operations" if t_ops >= t_bytes else "bytes"))
    for name, p, track in (("kernel_slot_p1", 1, True),
                           ("kernel_slot_p3", 3, True),
                           ("kernel_slot_minonly", 1, False)):
        rows[name] = (lambda p=p, track=track: k1.fused_l2_slot_topk(
            x, y_hi, y_lo, xx, yy, m_real, T=T, Qb=256, passes=p,
            track=track), slot_bound_ms(nq, M, d, T, p))
    set_slot_counts((0, 0))
    ladder = {}
    for name, (fn, (bound, by)) in rows.items():
        ms = cuda_ms(fn, reps)
        ladder[name] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                        "over_bound": ms / bound}
    launches = slot_counts()[0]
    set_slot_counts(saved)
    (k1.LAUNCHES, k1.LAUNCHES_DCHUNK, k1.LAUNCHES_GROUP,
     k1.LAUNCHES_GROUP_DCHUNK) = k1_saved.values()
    check(launches > 0, "ladder: the slot form launched no time")
    xb = x.to(torch.bfloat16)
    mm = cuda_ms(lambda: torch.matmul(xb, y_hi.T), reps)
    ladder["matmul_bf16"] = {"ms": mm}
    for name, row in ladder.items():
        row["over_matmul"] = row["ms"] / mm
        print(f"K1 ladder {name}: {json.dumps(row)}", flush=True)
    torch.cuda.empty_cache()
    report = {"shape": [nq, M, d], "T": T, "g": idx1.g, "rows": ladder,
              "held": held, "slot_launches": launches,
              "note": "every row but kernel_grp_* runs the wgmma + TMA "
                      "mainloop (fused_l2_packed_sm90.cu: kernel_pck_* "
                      "its packed fold, kernel_slot_* its slot fold); "
                      "kernel_grp_* is the mma.sync kernel "
                      "(fused_l2_topk.cu)",
              "split_p1_ms": {
                  "contraction_and_min_fold":
                      ladder["kernel_slot_minonly"]["ms"],
                  "argmin_and_2nd_min": ladder["kernel_slot_p1"]["ms"]
                  - ladder["kernel_slot_minonly"]["ms"],
                  "group_fold_vs_slot_p1": ladder["kernel_pck_p1"]["ms"]
                  - ladder["kernel_slot_p1"]["ms"],
                  "matmul_bf16": mm}}
    def kernel_row(name):
        return {**{k: ladder[f"kernel_{name}"][k]
                   for k in ("ms", "bound_ms", "bound_by")},
                "library_ms": mm,
                **{k: held[name][k]
                   for k in ("plain_ms", "max_abs_err", "tie_slots")}}
    entry = {"name": "fused_l2_slot_topk", "route": "cuda",
             "source": "raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu",
             "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:406",
             "launches": launches, **kernel_row("slot_p1"),
             "max_abs_err": max(h["max_abs_err"] for h in held.values()),
             "shape": [nq, M, d], "T": T, "library_note": MATMUL_NOTE,
             "p3": kernel_row("slot_p3"),
             "min_only": kernel_row("slot_minonly")}
    return report, entry


def slot_dchunk_rows(indexes, Qx, reps: int = 5):
    """The slot form's d-chunked form on a wide index's operands (x padded
    to the stream width, a multiple of its dc = 256): against its twin
    (outside the counts), then timed with its count zeroed just before
    and read just after, beside its twin, its bound and ``torch.matmul``
    in bf16 of the same shape. Returns (rows by passes, the ``kernels``
    entry)."""
    import torch
    from raft_tpu_torch.ops import fused_l2_topk as k1

    saved = slot_counts()
    rows, timed = {}, []
    for index in indexes:
        x = padded_queries(index, Qx)
        nq, d = x.shape
        check(d % 256 == 0, f"slot dchunk: stream width {d} is not a "
              f"multiple of dc = 256")
        xx = (x * x).sum(1)
        args = (x, index.y_hi, index.y_lo, xx, index.yy_raw, index.n_rows)
        kw = dict(T=index.T, Qb=256, passes=index.passes, dc=256)
        tag = f"slot dchunk p{index.passes}"
        out = k1.fused_l2_slot_topk_dchunk(*args, **kw)
        ref = k1.fused_l2_slot_topk_dchunk_ref(*args, **kw)
        held = compare_slot(out, ref, x, index.y_hi, index.y_lo, xx,
                            index.yy_raw, index.passes, True, tag)
        del out, ref
        plain_ms = cuda_ms(lambda: k1.fused_l2_slot_topk_dchunk_ref(
            *args, **kw), 1, warmup=0)
        M = index.y_hi.shape[0]
        bound, by = slot_bound_ms(nq, M, index.d_orig, index.T,
                                  index.passes)
        xb = x.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: torch.matmul(xb, index.y_hi.T), reps)
        rows[f"p{index.passes}"] = {
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": library_ms, "max_abs_err": held["max_abs_err"],
            "tie_slots": held["tie_slots"], "shape": [nq, M, index.d_orig],
            "stream_width": d}
        timed.append((f"p{index.passes}", args, kw))
        del xb
        torch.cuda.empty_cache()
    set_slot_counts((0, 0))
    for name, args, kw in timed:
        rows[name]["ms"] = cuda_ms(lambda: k1.fused_l2_slot_topk_dchunk(
            *args, **kw), reps)
    launches = slot_counts()[1]
    set_slot_counts(saved)
    check(launches > 0, "slot dchunk: launched no time")
    for name, row in rows.items():
        print(f"K1 slot dchunk at the wide shape, {name}: "
              f"{json.dumps(row)}", flush=True)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    first = rows[timed[0][0]]
    entry = {"name": "fused_l2_slot_topk_dchunk", "route": "cuda",
             "source": "raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu",
             "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:474",
             "launches": launches, **{k: first[k] for k in keys},
             "shape": first["shape"], "library_note": MATMUL_NOTE,
             **{k: r for k, r in rows.items() if r is not first}}
    return rows, entry


def wide_knn_phase(res, shape=WIDE_SHAPE, main=(N_INDEX, DIM, N_QUERIES, K)):
    """Phase 13 (see the module doc): wide_knn at ``shape`` (K1's
    d-chunked form), then unpacked_knn at ``main`` and on the wide data
    (K1's unpacked forms); K1's d-chunked slot form on the wide data
    (``slot_dchunk_rows``). Returns (the ``wide_knn`` report, the four
    ``kernels`` entries)."""
    import torch
    from raft_tpu_torch import distance
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.random import make_blobs

    n, d, nq, k = shape
    report = {"wide_knn": {}, "unpacked_knn": {}}
    X, _ = make_blobs(res, 13, n, d, n_clusters=64, cluster_std=2.0)
    Qx = X[:nq].clone()
    o_vals, o_ids = exact_oracle(X, Qx, k, chunk=65536)
    t0 = time.perf_counter()
    idx1 = distance.prepare_knn_index(X, passes=1)
    idx3 = distance.prepare_knn_index(X, passes=3)
    res.sync()
    print(f"wide prepare (p1 + p3): {time.perf_counter() - t0:.3f} s; "
          f"T={idx1.T} g={idx1.g} pbits={idx1.pbits} "
          f"stream width {idx1.stream_width}", flush=True)
    cells = report["wide_knn"]
    for name, index, certify, exact in (("p1", idx1, "kernel", False),
                                        ("p3", idx3, "kernel", True),
                                        ("p1_f32", idx1, "f32", True)):
        cells[name] = knn_cell(res, f"wide_knn {name}", index, Qx, k,
                               certify, X, o_vals, o_ids, "K1_dchunk",
                               exact)

    # ---- K1's d-chunked form on the path's own inputs ----
    x = padded_queries(idx1, Qx)
    xxh = 0.5 * (x * x).sum(1)
    rows = {}
    for index in (idx1, idx3):
        kw = dict(T=index.T, g=index.g, passes=index.passes, pair=False,
                  pbits=index.pbits, xxh=xxh)
        args = (x, index.y_hi, index.y_lo, index.yyh_k)
        counts = k1_counts()
        out = k1.fused_l2_group_topk_packed_dchunk(*args, **kw)
        ref = k1.fused_l2_group_topk_packed_dchunk_ref(*args, **kw)
        err = compare_k1(out, ref, x, index.y_hi, index.pbits, False)
        del out, ref
        ms = cuda_ms(lambda: k1.fused_l2_group_topk_packed_dchunk(
            *args, **kw), 10)
        plain_ms = cuda_ms(lambda: k1.fused_l2_group_topk_packed_dchunk_ref(
            *args, **kw), 1, warmup=0)
        M = index.prepared_rows
        S = -(-(M // index.T) // index.g) * 128
        bound, bound_by = k1_bound_ms(nq, M, d, S, index.passes)
        xb = x.to(torch.bfloat16)
        library_ms = cuda_ms(lambda: torch.matmul(xb, index.y_hi.T), 10)
        (k1.LAUNCHES, k1.LAUNCHES_DCHUNK, k1.LAUNCHES_GROUP,
         k1.LAUNCHES_GROUP_DCHUNK) = counts.values()
        rows[f"p{index.passes}"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": library_ms,
            "max_abs_err": err, "shape": [nq, M, d],
            "stream_width": index.stream_width}
        geo = k1.dchunk_geometry(nq, index.stream_width, index.passes)
        model = {"geometry": list(geo), "l2_gb_modelled": dchunk_l2_bytes(
            nq, M, index.stream_width, index.passes, index.T, index.g,
            geo) / 1e9}
        print(f"K1 dchunk at wide_knn, passes={index.passes}: "
              f"{json.dumps({**rows[f'p{index.passes}'], **model})}",
              flush=True)
    # ---- K1's d-chunked slot form on the same operands ----
    slot_rows, slot_entry = slot_dchunk_rows((idx1, idx3), Qx)
    del idx1, idx3
    torch.cuda.empty_cache()

    # ---- the int8 request (downgrades to bf16) and knn without an index
    idx8 = distance.prepare_knn_index(X, passes=3, db_dtype="int8")
    check(idx8.db_dtype == "bf16", f"wide int8 request stored "
          f"{idx8.db_dtype}, not the bf16 downgrade")
    cells["int8_p3"] = knn_cell(res, "wide_knn int8_p3 (bf16)", idx8, Qx,
                                k, "kernel", X, o_vals, o_ids, "K1_dchunk")
    del idx8
    torch.cuda.empty_cache()
    zero_k1_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, ids = distance.knn(res, X, Qx, k)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = k1_counts()
    check(counts["K1_dchunk"] > 0, f"knn(res, X, Q, k) at d={d} did not "
          f"take the fused pipeline ({counts})")
    cells["auto_unprepared"] = {
        "ms_with_prepare": ms, "launches": counts["K1_dchunk"],
        "ids_exact": True,
        "tie_queries": check_exact(ids, o_ids, o_vals, X, Qx, "wide auto",
                                   expanded_floor(X, Qx))}
    print(f"wide_knn auto (no prepared index): "
          f"{json.dumps(cells['auto_unprepared'])}", flush=True)
    del vals, ids
    dchunk_launches = sum(c["launches"] for c in cells.values())

    # ---- unpacked_knn on the wide data (K1's unpacked d-chunked form) ----
    uidx = distance.prepare_knn_index(X, T=UNPACKED_T, g=UNPACKED_G,
                                      passes=3)
    check(uidx.g * (uidx.T // 128) > (1 << uidx.pbits), "the unpacked "
          "geometry fits the packed codes")
    ucells = report["unpacked_knn"]
    ucells["wide"] = knn_cell(res, "unpacked_knn wide", uidx, Qx, k,
                              "kernel", X, o_vals, o_ids, "K1_group_dchunk")
    wide_row = unpacked_kernel_row(uidx, Qx, reps=2)
    print(f"K1 unpacked dchunk at unpacked_knn wide: "
          f"{json.dumps(wide_row)}", flush=True)
    del uidx, X, Qx, o_vals, o_ids
    torch.cuda.empty_cache()

    # ---- unpacked_knn on the main path's data (K1's unpacked form) ----
    n2, d2, nq2, k2 = main
    X, _ = make_blobs(res, 0, n2, d2, n_clusters=64, cluster_std=2.0)
    Qx = X[:nq2].clone()
    o_vals, o_ids = exact_oracle(X, Qx, k2)
    uidx = distance.prepare_knn_index(X, T=UNPACKED_T, g=UNPACKED_G,
                                      passes=3)
    ucells["main"] = knn_cell(res, "unpacked_knn main", uidx, Qx, k2,
                              "kernel", X, o_vals, o_ids, "K1_group")
    main_row = unpacked_kernel_row(uidx, Qx)
    print(f"K1 unpacked at unpacked_knn main: {json.dumps(main_row)}",
          flush=True)
    del uidx, X, Qx, o_vals, o_ids
    torch.cuda.empty_cache()
    zero_k1_counts()

    src = "raft_tpu_torch/ops/csrc/fused_l2_topk.cu"
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")
    entries = [
        {"name": "fused_l2_group_topk_packed_dchunk", "route": "cuda",
         "source": "raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu",
         "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:1294",
         "launches": dchunk_launches, **{k: rows["p1"][k] for k in keys},
         "shape": rows["p1"]["shape"], "p3": rows["p3"],
         "library_note": MATMUL_NOTE},
        {"name": "fused_l2_group_topk", "route": "cuda", "source": src,
         "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:1230",
         "launches": ucells["main"]["launches"],
         **{k: main_row[k] for k in keys}, "shape": main_row["shape"],
         "passes": 3, "tie_slots": main_row["tie_slots"],
         "segments": main_row["segments"],
         "ms_one_segment": main_row["ms_one_segment"],
         "library_note": MATMUL_NOTE},
        {"name": "fused_l2_group_topk_dchunk", "route": "cuda",
         "source": src,
         "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:1254",
         "launches": ucells["wide"]["launches"],
         **{k: wide_row[k] for k in keys}, "shape": wide_row["shape"],
         "passes": 3, "tie_slots": wide_row["tie_slots"],
         "segments": wide_row["segments"],
         "ms_one_segment": wide_row["ms_one_segment"],
         "library_note": MATMUL_NOTE}, slot_entry]
    report["kernel_rows"] = {"dchunk": rows, "unpacked_main": main_row,
                             "unpacked_wide": wide_row,
                             "slot_dchunk": slot_rows}
    return report, entries


#: kernels this run holds to their times recorded from earlier runs of
#: this script or of an A/B script on the same inputs (PERF.md §6), with
#: the card they were taken on. A kernel
#: fails the run where it is more than GUARD_SLACK times slower on that
#: card: the widest run-to-run spread of one kernel on one input recorded
#: in PERF.md §7 (K4's times), while these kernels themselves have moved
#: by at most 2% between full runs. Each time is taken on a settled card
#: (:func:`settle`): a kernel timed while the card recovers from its
#: power limit reads up to 27% slow. Those past GUARD_NOTE are named in the
#: line; a parent build timed in the same call (``port_scripts/ab_*.py``)
#: is the finer comparison.
# ---------------------------------------------------------------- mutable
# bench_mutation.py:55's chip shape: (index rows, d, k, reads, readers,
# write batches, upserts a batch); its watermark is half the write volume
MUT_SHAPE = (1_000_000, 128, 64, 1500, 6, 40, 256)
MUT_INT8_BATCHES = 8
# bench_recovery.py:51's chip shape: write batches, rows a batch, tails
RECOVERY_SHAPE = (64, 256, (64, 256))


class LiveModel:
    """The host's model of what a mutable brute index holds: the base rows
    ``Y`` [m, d] (on the card) under ids 0..m−1, and every upserted row by
    its external id. ``alive`` / ``deleted_at`` span the id space."""

    def __init__(self, Y, id_space: int):
        import numpy as np

        self.Y, self.m = Y, Y.shape[0]
        self.alive = np.zeros(id_space, bool)
        self.alive[:self.m] = True
        self.base_alive = self.alive[:self.m].copy()
        self.extra = {}
        self.deleted_at = np.full(id_space, np.inf)
        self.lock = threading.Lock()

    def upsert(self, ids, rows):
        for e, r in zip(ids.tolist(), rows):
            if e < self.m:
                self.base_alive[e] = False
            self.extra[e] = r
        self.alive[ids] = True

    def delete(self, ids, at: float):
        for e in ids.tolist():
            if e < self.m:
                self.base_alive[e] = False
            self.extra.pop(e, None)
        self.alive[ids] = False
        self.deleted_at[ids] = at

    def live(self):
        """(rows [n, d] on the card, their external ids int64 on the
        card)."""
        import numpy as np
        import torch

        base = torch.from_numpy(np.flatnonzero(self.base_alive)).cuda()
        ext = np.fromiter(self.extra, np.int64, len(self.extra))
        rows = [self.Y[base]]
        if len(ext):
            rows.append(torch.from_numpy(np.stack(
                [self.extra[e] for e in ext.tolist()])).cuda())
        return (torch.cat(rows), torch.cat([base,
                                            torch.from_numpy(ext).cuda()]))


def mutable_check(vals, ids, rows, exts, Qx, k: int, label: str,
                  floor=None):
    """Hold a mutable search's answer against the from-scratch oracle over
    the live ``rows`` (external ids ``exts``): every returned id live, the
    ids the oracle's up to proven ties (``check_exact``), values within
    the expanded f32 form's rounding. Returns (tie queries, max abs value
    error)."""
    import torch

    o_vals, o_pos = exact_oracle(rows, Qx, k)
    pos_of = torch.full((int(exts.max()) + 2,), -1, dtype=torch.long,
                        device=rows.device)
    pos_of[exts] = torch.arange(exts.numel(), device=rows.device)
    ids = ids.long().to(rows.device)
    check(bool((ids >= 0).all()) and int(ids.max()) < pos_of.numel() - 1,
          f"{label}: an id outside the live set came back")
    pos = pos_of[ids]
    check(bool((pos >= 0).all()), f"{label}: a deleted or unknown id came "
          f"back ({int((pos < 0).sum())} slots)")
    n_tie = check_exact(pos, o_pos, o_vals, rows, Qx, label, floor)
    tol = 16 * 2.0 ** -24 * ((Qx * Qx).sum(1) + (rows * rows).sum(1).max())
    err = (vals.to(o_vals.device) - o_vals).abs()
    check(bool((err <= tol[:, None] + 1e-5 * o_vals.abs()).all()),
          f"{label}: values differ from the oracle's by up to "
          f"{err.max().item()}")
    return n_tie, err.max().item()


def _timed(report: dict, name: str, fn, sync: bool = False):
    """``fn`` wrapped to add its wall seconds to ``report[name]``."""
    import torch

    def run(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            if sync:
                torch.cuda.synchronize()
            report.setdefault(name, []).append(time.perf_counter() - t0)
    return run


def mutable_brute_cell(res, Y, db_dtype: str, n_reads: int,
                       write_batches: int, seed: int):
    """3a / 3b: ``ServingEngine(Y, mutable=True)`` under closed-loop
    readers and one writer (bench_mutation.py:112-210), then the quiet
    oracle check. Returns (the cell's report, its K1/K2 launches, the
    engine's view for 3e — the engine is stopped)."""
    import numpy as np
    import torch
    from raft_tpu_torch.mutable import search_view
    from raft_tpu_torch.ops import fused_l2_topk as k1
    from raft_tpu_torch.serving import ServingEngine

    m, d, k, _, readers, _, wbatch = MUT_SHAPE
    threshold = (MUT_SHAPE[5] * wbatch) // 2
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    engine = ServingEngine(Y, k=k, mutable=True, compact_threshold=threshold,
                           delta_cap=2 * threshold,
                           db_dtype=None if db_dtype == "bf16" else db_dtype)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mi = engine.mutable
    folds = {}
    mi._materialize_locked = _timed(folds, "materialize_s",
                                    mi._materialize_locked)
    mi._store.update = _timed(folds, "rebuild_s", mi._store.update)
    mi._rebase_locked = _timed(folds, "rebase_s", mi._rebase_locked)
    refresh = {}
    mi._refresh_delta = _timed(refresh, "s", mi._refresh_delta, sync=True)
    ladder = engine.buckets
    model = LiveModel(Y, m + write_batches * wbatch + 16)
    t0 = time.perf_counter()
    engine.start()
    warm_s = time.perf_counter() - t0
    report = {"index": f"{db_dtype} p3", "rows": m, "build_s": build_s,
              "warmup_s": warm_s, "compact_threshold": threshold,
              "delta_cap": mi.delta_cap, "buckets": list(ladder)}
    try:
        # prime the delta path before the measured window
        nxt = [m]
        prime = rng.normal(size=(1, d)).astype(np.float32)
        engine.upsert([nxt[0]], prime).result(timeout=120)
        model.upsert(np.array([nxt[0]]), prime)
        nxt[0] += 1
        engine.query(rng.normal(size=(4, d)).astype(np.float32),
                     timeout=120)
        sizes = np.clip(rng.poisson(max(2, ladder[0]), n_reads + 4096), 1,
                        ladder[-1])
        blocks = rng.normal(size=(64, ladder[-1], d)).astype(np.float32)
        lock = threading.Lock()
        state = {"next": 0, "writer": True}
        reads, w_lat, errors, windows = [], [], [], []

        def reader():
            while True:
                with lock:
                    i = state["next"]
                    if i >= n_reads and not (state["writer"]
                                             or mi.folding):
                        return
                    state["next"] = i + 1
                q = blocks[i % 64, :int(sizes[i % len(sizes)])]
                t_sub = time.perf_counter()
                try:
                    _, ids = engine.query(q, timeout=120)
                except Exception as e:
                    with lock:
                        errors.append(f"read: {type(e).__name__}: {e}"[:200])
                    continue
                with lock:
                    reads.append((t_sub, time.perf_counter(), ids))

        def writer():
            w_rng = np.random.default_rng(seed + 1)
            try:
                for _ in range(write_batches):
                    with model.lock:
                        live = np.flatnonzero(model.alive)
                    n_over = wbatch // 4
                    pick = w_rng.choice(live, n_over + wbatch // 8,
                                        replace=False)
                    over, dels = pick[:n_over], pick[n_over:]
                    fresh = np.arange(nxt[0], nxt[0] + wbatch - n_over)
                    nxt[0] += wbatch - n_over
                    ids = np.concatenate([over, fresh])
                    rows = w_rng.normal(size=(wbatch, d)).astype(np.float32)
                    t0 = time.perf_counter()
                    engine.upsert(ids, rows).result(timeout=120)
                    with model.lock:
                        model.upsert(ids, rows)
                    engine.delete(dels).result(timeout=120)
                    t1 = time.perf_counter()
                    with model.lock:
                        model.delete(dels, t1)
                    w_lat.append(t1 - t0)
            except Exception as e:
                errors.append(f"write: {type(e).__name__}: {e}"[:200])
            finally:
                with lock:
                    state["writer"] = False

        def fold_monitor():
            start = None
            while state["writer"] or start is not None or mi.folding:
                f = mi.folding
                now = time.perf_counter()
                if f and start is None:
                    start = now
                elif not f and start is not None:
                    windows.append((start, now))
                    start = None
                time.sleep(0.001)

        k1.LAUNCHES = k1.LAUNCHES_Q8 = 0
        s0 = engine.stats()
        c0 = mi.compactions
        threads = [threading.Thread(target=reader) for _ in range(readers)]
        threads += [threading.Thread(target=writer),
                    threading.Thread(target=fold_monitor)]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        engine.flush(60)
        wall = time.perf_counter() - t_start
        mi.wait_for_compaction(timeout=300)
        launches = k1.LAUNCHES_Q8 if db_dtype == "int8" else k1.LAUNCHES
        s1 = engine.stats()
        check(not errors, f"mutable {db_dtype}: {errors[:3]}")
        check(len(w_lat) == write_batches, f"mutable {db_dtype}: "
              f"{len(w_lat)} of {write_batches} write batches applied")
        # no read submitted after a delete's ack returned its id
        stale = sum(int((model.deleted_at[ids[ids >= 0]] < t_sub).sum())
                    for t_sub, _, ids in reads)
        check(stale == 0, f"mutable {db_dtype}: {stale} slots named an id "
              f"deleted before the read was submitted")
        batches = s1["batches"] - s0["batches"]
        lat_ms = np.asarray([b - a for a, b, _ in reads]) * 1e3
        in_fold = sum(any(a <= done <= b for a, b in windows)
                      for _, done, _ in reads)
        report.update({
            "reads": len(reads), "readers": readers,
            "write_batches": write_batches, "rows_per_write_batch": wbatch,
            "read_p50_ms": float(np.percentile(lat_ms, 50)),
            "read_p99_ms": float(np.percentile(lat_ms, 99)),
            "write_p50_ms": 1e3 * float(np.percentile(w_lat, 50)),
            "write_p99_ms": 1e3 * float(np.percentile(w_lat, 99)),
            "reads_per_s": len(reads) / wall, "wall_s": wall,
            "compactions": mi.compactions - c0,
            "fold_windows_s": [b - a for a, b in windows],
            "reads_completed_in_fold": int(in_fold),
            "fold_s": {n: v for n, v in folds.items()},
            "delta_refresh_ms": {
                "p50": 1e3 * float(np.median(refresh["s"])),
                "max": 1e3 * float(np.max(refresh["s"])),
                "count": len(refresh["s"])},
            "batches": batches, "fixups": s1["fixups"] - s0["fixups"],
            "launches": {"K2" if db_dtype == "int8" else "K1": launches},
            "launches_per_search": launches / max(1, batches),
            "stale_deleted_slots": stale, "mutable": s1["mutable"]})
        check(launches > 0, f"mutable {db_dtype}: the load launched no "
              f"{'K2' if db_dtype == 'int8' else 'K1'}")
        if write_batches * wbatch >= threshold:
            check(report["compactions"] >= 1, f"mutable {db_dtype}: the "
                  f"load crossed no compaction")
        # the quiet check: 256 queries through the engine against the
        # from-scratch oracle over the model's live rows
        Qx = torch.from_numpy(rng.normal(size=(256, d)).astype(
            np.float32)).cuda()
        vals, ids = engine.query(Qx.cpu().numpy(), timeout=120)
        rows, exts = model.live()
        n_tie, err = mutable_check(torch.from_numpy(vals),
                                   torch.from_numpy(ids), rows, exts, Qx, k,
                                   f"mutable {db_dtype}")
        _, _, st = search_view(mi, Qx, k, with_stats=True)
        report.update({"oracle_queries": 256, "oracle_tie_queries": n_tie,
                       "max_abs_val_err": err, "n_fail": st,
                       "live_rows": int(exts.numel())})
        del rows, exts
        # device busy and idle share over a short read burst
        report["profile"] = profile_run(lambda: closed_loop(
            engine, lambda i: blocks[i % 64, :int(sizes[i])], 200, readers,
            0.0, seed + 2))
    finally:
        engine.stop()
    return report, launches, engine, model


def tombstoned_k1_twin(engine, model, gen, Q: int = 500, tiles: int = 65):
    """3e: K1 against its twin on the mutable base's own operands after
    2000 scattered deletes: the first ``tiles`` tiles of the base with the
    view's tombstoned carrier (never-wins sentinels at the holes), at p1
    (pair) and p3. Returns {tag: max abs error, "holes": n}."""
    import numpy as np
    import torch
    from raft_tpu_torch.mutable import apply_delete
    from raft_tpu_torch.ops import fused_l2_topk as k1

    mi = engine.mutable
    live = np.flatnonzero(model.base_alive)
    dels = np.random.default_rng(7).choice(live, 2000, replace=False)
    apply_delete(mi, dels)
    view = mi.view()
    idx = view.plane.index
    M = tiles * idx.T
    y_hi, y_lo = idx.y_hi[:M], idx.y_lo[:M]
    yyh = view.base_yyh[:M].contiguous()
    holes = int((yyh >= k1._PACK_PAD).sum()) - int(
        (idx.yyh_k[:M] >= k1._PACK_PAD).sum())
    check(holes > 0, "3e: no tombstone landed in the checked tiles")
    x = torch.randn(Q, idx.stream_width, device="cuda", generator=gen)
    xxh = 0.5 * (x * x).sum(1)
    out_errs = {"holes": holes}
    saved = k1.LAUNCHES
    for passes, pair in ((1, True), (3, False)):
        kw = dict(T=idx.T, g=idx.g, passes=passes, pair=pair,
                  pbits=idx.pbits, xxh=xxh)
        out = k1.fused_l2_group_topk_packed(x, y_hi, y_lo, yyh, **kw)
        ref = k1.fused_l2_group_topk_packed_ref(x, y_hi, y_lo, yyh, **kw)
        out_errs[f"p{passes}"] = compare_k1(out, ref, x, y_hi, idx.pbits,
                                            pair)
        del out, ref
    k1.LAUNCHES = saved              # comparison launches do not count
    print(f"K1 vs twin on the tombstoned base (Q={Q}, {tiles} tiles, "
          f"{holes} holes): {json.dumps(out_errs)}", flush=True)
    return out_errs


def mutable_ann_cell(res, index, algorithm: str, data, P: int = 32,
                     n_q: int = 256):
    """3c: the ivf / ivf_pq phase's 1M-row index wrapped in a
    ``MutableIndex`` (no rebuild): 1000 deletes and 512 upserts, then
    ``search_view(exact=True)`` against the oracle over the live rows, the
    probed path (K5 with the masked ids on IVF-PQ) never naming a deleted
    id, and its recall@10. Returns (report, K5 launches)."""
    import numpy as np
    import torch
    from raft_tpu_torch.mutable import (MutableIndex, apply_delete,
                                        apply_upsert, search_view)
    from raft_tpu_torch.ops import pq_scan as k5

    X, Q, floor = data["X"], data["Q"][:n_q], data["floor"][:n_q]
    m, d = X.shape
    rng = np.random.default_rng(23)
    t0 = time.perf_counter()
    mi = MutableIndex(index, algorithm=algorithm, res=res,
                      auto_compact=False, compact_threshold=4096)
    torch.cuda.synchronize()
    wrap_s = time.perf_counter() - t0
    dels = rng.choice(m, 1000, replace=False)
    # half the upserts land near the queries, so the delta competes
    near = X[torch.from_numpy(rng.choice(m, 256, replace=False)).cuda()]
    new_rows = torch.cat([near + 0.05 * torch.randn_like(near),
                          torch.randn(256, d, device="cuda") * 3.0])
    new_ids = np.arange(m, m + 512)
    t0 = time.perf_counter()
    apply_delete(mi, dels)
    apply_upsert(mi, new_ids, new_rows.cpu().numpy())
    torch.cuda.synchronize()
    mut_s = time.perf_counter() - t0
    keep = np.ones(m, bool)
    keep[dels] = False
    keep_ids = torch.from_numpy(np.flatnonzero(keep)).cuda()
    rows = torch.cat([X[keep_ids], new_rows])
    exts = torch.cat([keep_ids, torch.from_numpy(new_ids).cuda()])
    t0 = time.perf_counter()
    vals, ids = search_view(mi, Q, IVF_K, exact=True)
    torch.cuda.synchronize()
    exact_ms = 1e3 * (time.perf_counter() - t0)
    n_tie, err = mutable_check(vals, ids, rows, exts, Q, IVF_K,
                               f"mutable {algorithm} exact", floor=floor)
    set_pq_counts({"K1": 0, "K5": 0, "K5_4bit": 0})
    t0 = time.perf_counter()
    pv, pi, st = search_view(mi, Q, IVF_K, n_probes=P, with_stats=True)
    torch.cuda.synchronize()
    probed_ms = 1e3 * (time.perf_counter() - t0)
    k5_launches = pq_counts()["K5"]
    if algorithm == "ivf_pq":
        check(k5_launches > 0, "3c: the masked IVF-PQ probe launched no K5")
    dead = torch.from_numpy(dels).cuda()
    check(not bool(torch.isin(pi.long(), dead).any()),
          f"mutable {algorithm}: the probed path returned a deleted id")
    o_ids = ids.cpu().numpy()
    got = pi.cpu().numpy()
    recall = float(np.mean([len(set(a) & set(b)) / IVF_K
                            for a, b in zip(got, o_ids)]))
    report = {"rows": m, "wrap_s": wrap_s, "deletes": 1000, "upserts": 512,
              "mutate_s": mut_s, "exact_ms": exact_ms,
              "exact_tie_queries": n_tie, "max_abs_val_err": err,
              "probes": P, "probed_ms": probed_ms,
              "recall_at_10": recall, "probed_reruns": st["base_fail"],
              "queries": n_q, "K5_launches": k5_launches}
    print(f"mutable {algorithm}: {json.dumps(report)}", flush=True)
    del mi
    torch.cuda.empty_cache()
    return report, k5_launches


def durability_cell(Y, seed: int = 0):
    """3d (bench_recovery.py:118-200): 64 write batches of 256 rows (and a
    delete of 32) on a 1M × 128 ``MutableIndex``, in memory and then with
    a durable directory (``wal_sync="batch"``), then recovery after WAL
    tails of 64 and 256 records, each held against the pre-crash index.
    One durable index serves all three: its directory is copied after 32
    batches (the 64-record tail, outside the timed writes), and it goes on
    to 128 batches (256 records; the delta fills its cap on the way and
    folds inline, as the reference's run does). Returns the report."""
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch
    import raft_tpu_torch.mutable.checkpoint as ckpt
    from raft_tpu_torch.mutable import (MutableIndex, apply_delete,
                                        apply_upsert, recover, search_view)

    batches, wbatch, tails = RECOVERY_SHAPE
    m, d = Y.shape
    k = MUT_SHAPE[2]
    cap = max(1024, batches * wbatch + 64)
    common = dict(auto_compact=False, compact_threshold=cap, delta_cap=cap)
    rng = np.random.default_rng(seed)
    writes = {}
    real_write = ckpt.CheckpointStore.write
    ckpt.CheckpointStore.write = _timed(writes, "s", real_write)

    def drive(idx, n_batches, state):
        t0 = time.perf_counter()
        for _ in range(n_batches):
            b, nxt = state["b"], state["next"]
            apply_upsert(idx, np.arange(nxt, nxt + wbatch, dtype=np.int32),
                         rng.normal(size=(wbatch, d)).astype(np.float32))
            dels = np.unique((7 * b + np.arange(wbatch // 8)) * 997 % m)
            apply_delete(idx, dels.astype(np.int32))
            state["b"], state["next"] = b + 1, nxt + wbatch
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def held(tag, directory, want):
        t0 = time.perf_counter()
        ridx, st = recover(directory, attach=False, **common)
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        vr, ir = search_view(ridx, q, k)
        check(torch.equal(want[1], ir), f"3d: recovery after a {tag}-record "
              f"tail answers with other ids than the pre-crash index")
        check(bool(torch.allclose(want[0], vr, atol=1e-5)),
              f"3d: recovered values differ (tail {tag})")
        return {"tail_records": tag,
                "wal_records": st["wal_last_lsn"] - st["checkpoint_lsn"],
                "replayed_records": st["replayed_records"],
                "recovery_s": rec_s, "load_s": st["load_seconds"],
                "build_s": st["build_seconds"],
                "replay_s": st["replay_seconds"],
                "checkpoint_rows": st["checkpoint_rows"]}

    root = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    report = {"rows": m, "write_batches": batches, "rows_per_batch": wbatch}
    q = torch.from_numpy(rng.normal(size=(256, d)).astype(np.float32)).cuda()
    try:
        plain = MutableIndex(Y, **common)
        t_plain = drive(plain, batches, {"b": 0, "next": m})
        del plain
        ddir = os.path.join(root, "durable")
        t0 = time.perf_counter()
        dur = MutableIndex(Y, durable_dir=ddir, wal_sync="batch", **common)
        report["genesis_s"] = time.perf_counter() - t0
        report["genesis_checkpoint_disk_s"] = writes["s"][-1]
        report["genesis_checkpoint_bytes"] = sum(
            os.path.getsize(p) for p in glob.glob(
                os.path.join(ddir, "ckpt-*", "*")))
        state = {"b": 0, "next": m}
        t_dur = drive(dur, tails[0] // 2, state)   # 2 records a batch
        want64 = search_view(dur, q, k)
        shutil.copytree(ddir, os.path.join(root, "tail64"))
        t_dur += drive(dur, batches - tails[0] // 2, state)
        report.update({"memory_s": t_plain, "durable_s": t_dur,
                       "durable_overhead_x": t_dur / t_plain,
                       "writes_per_s": 2 * batches / t_dur})
        drive(dur, tails[1] // 2 - batches, state)
        want256 = search_view(dur, q, k)
        report["checkpoint_disk_s"] = writes["s"]
        dur.close()                      # the fsync horizon: a crash
        del dur
        report["recovery"] = [
            held(tails[0], os.path.join(root, "tail64"), want64),
            held(tails[1], ddir, want256)]
        torch.cuda.empty_cache()
    finally:
        ckpt.CheckpointStore.write = real_write
        shutil.rmtree(root, ignore_errors=True)
    print(f"mutable durability: {json.dumps(report)}", flush=True)
    return report


def mutable_phase(res, ivf_index, pq_index, data, seed: int = 0):
    """Phase ``mutable`` (see the module doc): 3a brute bf16 served, 3e K1
    on its tombstoned base, 3b brute int8 served, 3c the IVF-Flat and
    IVF-PQ indexes wrapped, 3d durability. Returns (the ``mutable``
    report, the path's launches {K1, K2, K5})."""
    import torch

    m, d = MUT_SHAPE[:2]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    Y = torch.randn(m, d, device="cuda", generator=gen)
    report, launches = {}, {}
    report["brute_bf16"], launches["K1"], engine, model = \
        mutable_brute_cell(res, Y, "bf16", MUT_SHAPE[3], MUT_SHAPE[5], seed)
    print(f"mutable brute_bf16: {json.dumps(report['brute_bf16'])}",
          flush=True)
    report["k1_tombstoned_twin"] = tombstoned_k1_twin(engine, model, gen)
    del engine, model
    torch.cuda.empty_cache()
    report["brute_int8"], launches["K2"], engine, model = \
        mutable_brute_cell(res, Y, "int8", 300, MUT_INT8_BATCHES, seed + 5)
    print(f"mutable brute_int8: {json.dumps(report['brute_int8'])}",
          flush=True)
    del engine, model
    torch.cuda.empty_cache()
    report["ivf_flat"], _ = mutable_ann_cell(res, ivf_index, "ivf_flat",
                                             data)
    report["ivf_pq"], launches["K5"] = mutable_ann_cell(res, pq_index,
                                                        "ivf_pq", data)
    report["durability"] = durability_cell(Y, seed)
    del Y
    torch.cuda.empty_cache()
    return report, launches


SVD_SHAPE = (100_000, 1000, 16, 20, 18)   # rows, cols, k, svds/mst scales


def host_median_ms(fn, reps: int = 3):
    """Host-clock median milliseconds of ``fn()`` over ``reps`` calls after
    one warm-up, each window after :func:`settle`; returns (ms, the
    warm-up's output)."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        settle()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times), out


def orthonormal_err(U) -> float:
    import torch

    U = U.double()
    return (U.T @ U - torch.eye(U.shape[1], dtype=U.dtype,
                                device=U.device)).abs().max().item()


def rel_err(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs() / want.abs()).max().item()


def spectrum_err(got, want) -> float:
    """max |got − want| over max |want|: an f32 SVD or eigensolver is
    backward stable, so its error on every value is a few ε times the
    largest, however small the value."""
    got, want = got.double(), want.double()
    return ((got - want).abs().max() / want.abs().max()).item()


def svds_split(res, A, At, k: int = 16, p: int = 10,
               n_iters: int = 2) -> dict:
    """randomized_svds' steps timed alone (CUDA events) on its own shapes:
    the transpose, the six SpMMs, the five cholesky_qr2 and the small
    SVD of the ℓ × n core."""
    import torch

    from raft_tpu_torch.sparse.linalg import spmm, transpose
    from raft_tpu_torch.sparse.solver import cholesky_qr2

    m, n = A.shape
    omega = torch.randn(n, k + p, device=A.values.device)
    Q = cholesky_qr2(spmm(res, A, omega))[0]
    Bt = spmm(res, At, Q)
    return {"transpose_ms": cuda_ms(lambda: transpose(res, A), 3),
            "products_ms": (2 * n_iters + 2) * cuda_ms(
                lambda: spmm(res, A, Q), 3),
            "cholesky_qr2_ms": (n_iters + 1) * cuda_ms(
                lambda: cholesky_qr2(Bt), 3) + n_iters * cuda_ms(
                lambda: cholesky_qr2(Q), 3),
            "small_svd_ms": cuda_ms(lambda: torch.linalg.svd(
                Bt.T, full_matrices=False), 3)}


def rsvd_split(A, k: int = 16, p: int = 10, n_iters: int = 2) -> dict:
    """randomized_svd's steps timed alone (CUDA events) on its own shapes:
    the six products over A, the five tall QRs and the small SVD."""
    import torch

    m, n = A.shape
    ell = k + p
    omega = torch.randn(n, ell, device=A.device)
    Q, _ = torch.linalg.qr(A @ omega)
    Z, _ = torch.linalg.qr(A.T @ Q)
    B = Q.T @ A
    products = (cuda_ms(lambda: A @ omega, 5)
                + n_iters * (cuda_ms(lambda: A.T @ Q, 5)
                             + cuda_ms(lambda: A @ Z, 5))
                + cuda_ms(lambda: Q.T @ A, 5))
    Ym, Yn = A @ omega, A.T @ Q
    qrs = ((n_iters + 1) * cuda_ms(lambda: torch.linalg.qr(Ym), 5)
           + n_iters * cuda_ms(lambda: torch.linalg.qr(Yn), 5))
    small = cuda_ms(lambda: torch.linalg.svd(B, full_matrices=False), 5)
    return {"products_ms": products, "qr_ms": qrs, "small_svd_ms": small}


def svd_phase(res, shape=SVD_SHAPE) -> dict:
    """Phase 16: BASELINE config 3 whole on the card (see the module
    docstring). Returns the ``svd`` report."""
    import numpy as np
    import torch
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import (connected_components,
                                      minimum_spanning_tree)

    from raft_tpu_torch import linalg
    from raft_tpu_torch.core.sparse_types import COOMatrix
    from raft_tpu_torch.linalg import Solver
    from raft_tpu_torch.models import PCA, TruncatedSVD
    from raft_tpu_torch.random import make_blobs, rmat_rectangular_gen
    from raft_tpu_torch.sparse.convert import coo_to_csr
    from raft_tpu_torch.sparse.solver import (LANCZOS_WHICH,
                                              LanczosSolverConfig, SvdsConfig,
                                              lanczos_compute_eigenpairs, mst,
                                              randomized_svds)

    rows, cols, k, svds_scale, mst_scale = shape
    report = {}
    X3, _ = make_blobs(res, 2, rows, cols, n_clusters=16)
    X64 = X3.double()
    s64 = torch.linalg.svdvals(torch.linalg.qr(X64, mode="r")[1])

    # (a) randomized SVD, config 3's timed call
    ms, (U, S, V) = host_median_ms(
        lambda: linalg.randomized_svd(res, X3, k=k))
    a = {"ms": ms, "s_rel_err": rel_err(S, s64[:k]),
         "u_orth_err": orthonormal_err(U), "v_orth_err": orthonormal_err(V),
         **rsvd_split(X3, k)}
    a["qr_share"] = a["qr_ms"] / (a["products_ms"] + a["qr_ms"]
                                  + a["small_svd_ms"])
    check(a["s_rel_err"] <= 1e-4 and a["u_orth_err"] <= 1e-4
          and a["v_orth_err"] <= 1e-4,
          f"svd (a) randomized_svd: {json.dumps(a)}")
    report["rsvd"] = a
    print(f"svd rsvd: {json.dumps(a)}", flush=True)
    del U, S, V

    # (b) the full thin SVD
    ms, (_, S, _) = host_median_ms(lambda: linalg.svd_qr(res, X3))
    b = {"ms": ms, "s_rel_err": rel_err(S[:k], s64[:k]),
         "all_err_over_s_max": spectrum_err(S, s64)}
    check(b["s_rel_err"] <= 1e-4 and b["all_err_over_s_max"] <= 1e-4,
          f"svd (b) svd_qr: {json.dumps(b)}")
    # cuSOLVER's other drivers on the same X3, reference points for
    # svd_qr's choice of gesvd (not checked): torch's default, gesvdj,
    # and gesvda, which solves by the Gram matrix
    for driver in ("gesvdj", "gesvda"):
        ms, (_, S, _) = host_median_ms(lambda: torch.linalg.svd(
            X3, full_matrices=False, driver=driver))
        b[driver] = {"ms": ms, "s_rel_err": rel_err(S[:k], s64[:k]),
                     "all_err_over_s_max": spectrum_err(S, s64)}
    report["svd_qr"] = b
    print(f"svd svd_qr: {json.dumps(b)}", flush=True)
    del S

    # (c) PCA (eigDC at full width, Jacobi on 256 columns) and TSVD
    for name, solver, X in (("pca_eig_dc", Solver.COV_EIG_DC, X3),
                            ("pca_jacobi", Solver.COV_EIG_JACOBI,
                             X3[:, :256].contiguous())):
        pca = PCA(k, solver=solver, res=res)
        fit_ms, _ = host_median_ms(lambda: pca.fit(X))
        tr_ms, T = host_median_ms(lambda: pca.transform(X))
        inv_ms, back = host_median_ms(lambda: pca.inverse_transform(T))
        Xd = X.double()
        Xc = Xd - Xd.mean(0)
        w64 = torch.linalg.eigvalsh(Xc.T @ Xc / (rows - 1)).flip(0)[:k]
        ev = pca.explained_variance_
        big = w64 >= 1e-2 * w64[0]
        c = {"fit_ms": fit_ms, "transform_ms": tr_ms,
             "inverse_ms": inv_ms, "components_above_1pct": int(big.sum()),
             "explained_var_rel_err": rel_err(ev[big], w64[big]),
             "explained_var_err_over_max": spectrum_err(ev, w64),
             "explained_var_rel_err_each": (
                 (ev.double() - w64).abs() / w64).tolist(),
             "reconstruction_rel": ((back.double() - Xd).norm()
                                    / Xc.norm()).item()}
        check(c["explained_var_rel_err"] <= 1e-4
              and c["explained_var_err_over_max"] <= 1e-4
              and bool(torch.isfinite(back).all()),
              f"svd (c) {name}: {json.dumps(c)}")
        report[name] = c
        print(f"svd {name}: {json.dumps(c)}", flush=True)
        del Xd, Xc, T, back
    tsvd = TruncatedSVD(k, res=res)
    fit_ms, _ = host_median_ms(lambda: tsvd.fit(X3))
    tr_ms, T = host_median_ms(lambda: tsvd.transform(X3))
    inv_ms, back = host_median_ms(lambda: tsvd.inverse_transform(T))
    c = {"fit_ms": fit_ms, "transform_ms": tr_ms, "inverse_ms": inv_ms,
         "singular_vals_rel_err": rel_err(tsvd.singular_values_, s64[:k]),
         "explained_var_rel_err": rel_err(
             tsvd.explained_variance_,
             (X64 @ tsvd.components_.double().T).var(0, correction=0))}
    check(c["singular_vals_rel_err"] <= 1e-4
          and c["explained_var_rel_err"] <= 1e-4
          and bool(torch.isfinite(back).all()),
          f"svd (c) tsvd: {json.dumps(c)}")
    report["tsvd"] = c
    print(f"svd tsvd: {json.dumps(c)}", flush=True)
    del X3, X64, T, back, tsvd, pca
    torch.cuda.empty_cache()

    # (d) the randomized sparse SVD on a scale-20 R-MAT adjacency
    A = coo_to_csr(rmat_adjacency(res, 3, svds_scale))
    ms, (U, S, V) = host_median_ms(
        lambda: randomized_svds(res, A, SvdsConfig(n_components=k)))
    lam, _ = lanczos_compute_eigenpairs(res, A, LanczosSolverConfig(
        n_components=1, which=LANCZOS_WHICH.LA, ncv=32, max_iterations=3000,
        tolerance=1e-7, seed=0))
    d = {"ms": ms, "nnz": A.nnz, "s0": S[0].item(),
         "lanczos_top": lam[-1].item(),
         "s0_rel_err": abs(S[0].item() - lam[-1].item()) / lam[-1].item(),
         "u_orth_err": orthonormal_err(U), "v_orth_err": orthonormal_err(V),
         "descending": bool((S[:-1] >= S[1:]).all()),
         **svds_split(res, A, A, k)}
    check(d["s0_rel_err"] <= 0.01 and d["u_orth_err"] <= 1e-4
          and d["v_orth_err"] <= 1e-4 and d["descending"]
          and bool(torch.isfinite(S).all()),
          f"svd (d) randomized_svds: {json.dumps(d)}")
    report["randomized_svds"] = d
    print(f"svd randomized_svds: {json.dumps(d)}", flush=True)
    del A, U, S, V
    torch.cuda.empty_cache()

    # (e) the MST of a scale-18 R-MAT graph with seeded uniform weights
    n = 1 << mst_scale
    src, dst = rmat_rectangular_gen(res, 4, 16 << mst_scale, mst_scale,
                                    mst_scale)
    lo, hi = torch.minimum(src, dst).long(), torch.maximum(src, dst).long()
    key = torch.unique(lo[lo != hi] * n + hi[lo != hi])
    lo, hi = key // n, key % n
    gen = torch.Generator(device=res.device)
    gen.manual_seed(5)
    w = torch.rand(key.numel(), device=res.device, generator=gen) + 1e-3
    G = COOMatrix(torch.cat([lo, hi]).int(), torch.cat([hi, lo]).int(),
                  torch.cat([w, w]), (n, n))
    ms, out = host_median_ms(lambda: mst(res, G))
    sp = coo_matrix((w.double().cpu().numpy(),
                     (lo.cpu().numpy(), hi.cpu().numpy())), shape=(n, n))
    ref_total = float(minimum_spanning_tree(sp.tocsr()).sum())
    n_comp = int(connected_components(sp.tocsr(), directed=False)[0])
    total = out.mst.weights.double().sum().item()
    e = {"ms": ms, "vertices": n, "edges": int(key.numel()),
         "mst_edges": out.mst.n_edges, "components": n_comp,
         "total_weight": total, "scipy_total_weight": ref_total,
         "weight_rel_err": abs(total - ref_total) / ref_total}
    check(e["weight_rel_err"] <= 1e-5 and e["mst_edges"] == n - n_comp,
          f"svd (e) mst: {json.dumps(e)}")
    report["mst"] = e
    print(f"svd mst: {json.dumps(e)}", flush=True)
    print(json.dumps({"svd": report}), flush=True)
    return report


GUARD_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
GUARD_MS = {"K1_p1": 1.892, "K1_p3": 3.172, "K2_p1": 2.644, "K2_p3": 3.215,
            # the slot forms and K9 alone at value_histogram's 12.8 M
            # values: the slower of the final tree's two runs in
            # port_scripts/ab_slot_k9.py's call
            "slot_p1": 2.255, "slot_p3": 3.267, "slot_minonly": 1.846,
            "slot_dchunk_p1": 6.663, "slot_dchunk_p3": 12.709,
            "K9_value_histogram": 0.02249,
            "K6b": 0.1755, "K6c_V16": 6.551, "K6c_V128": 30.538,
            # K1 dchunk: the passing run of this script on its code's git
            # archive; K5 alone (``kernel_ms``: its wrapper's time follows
            # host load by 10% and more), the slower of the final tree's
            # two runs in port_scripts/ab_dchunk_k5.py's call
            "K1_dchunk_p1": 6.364, "K1_dchunk_p3": 13.323,
            "K5_p32": 0.960, "K5_p128": 3.494, "K5_4bit_p32": 0.579,
            "K5_4bit_p128": 1.982,
            # K4 alone (scan + merge, ``kernel_ms``) and K7's CSR wrapper
            # (CUDA events, B column-major), the slower of the final
            # tree's two runs in port_scripts/ab_k4_k7.py's call
            "K4_p32": 1.196, "K4_p128": 4.208, "K4_q8_p64": 1.791,
            "K7": 8.830}
GUARD_SLACK = 1.10
GUARD_NOTE = 1.05


def speed_guard(card: str, entries) -> dict:
    """This run's times of the kernels of ``GUARD_MS`` against their
    recorded ones: fails where one is more than ``GUARD_SLACK`` times
    slower on the card they were recorded on (elsewhere only printed),
    and names those more than ``GUARD_NOTE`` times slower."""
    by = {e["name"]: e for e in entries}
    k1, k2 = by["fused_l2_group_topk_packed"], by[
        "fused_l2_group_topk_packed_q8"]
    slot, k6c = by["fused_l2_slot_topk"], by["spmm_tiled"]
    now = {"K1_p1": k1["ms"], "K1_p3": k1["p3"]["ms"], "K2_p1": k2["ms"],
           "K2_p3": k2["p3"]["ms"], "slot_p1": slot["ms"],
           "slot_p3": slot["p3"]["ms"],
           "slot_minonly": slot["min_only"]["ms"],
           "K6b": by["spmv_pair_tiled"]["ms"], "K6c_V16": k6c["ms"],
           "K6c_V128": k6c["V128"]["ms"]}
    wide = by["fused_l2_group_topk_packed_dchunk"]
    now.update(K1_dchunk_p1=wide["ms"], K1_dchunk_p3=wide["p3"]["ms"])
    sw = by["fused_l2_slot_topk_dchunk"]
    now.update(slot_dchunk_p1=sw["ms"], slot_dchunk_p3=sw["p3"]["ms"],
               K9_value_histogram=by["histogram_blocked"][
                   "value_histogram"]["kernel_ms"])
    for name, tag in (("pq_scan_list_major", "K5"),
                      ("pq_scan_list_major_4bit", "K5_4bit")):
        now[f"{tag}_p32"] = by[name]["kernel_ms"]
        now[f"{tag}_p128"] = by[name]["p128"]["kernel_ms"]
    k4, k4q = by["fine_scan_list_major"], by["fine_scan_list_major_q8"]
    now.update(K4_p32=k4["kernel_ms"], K4_p128=k4["p128"]["kernel_ms"],
               K4_q8_p64=k4q["kernel_ms"], K7=by["sddmm_tiled"]["ms"])
    unmeasured = [k for k in GUARD_MS if now[k] is None]
    check(not unmeasured, f"speed guard: no trace of {KERNEL_MS_TRIES} "
          f"held a record of {unmeasured}; profiler misses "
          f"{PROFILER_MISSES}")
    ratio = {k: now[k] / GUARD_MS[k] for k in GUARD_MS}
    held = card.strip() == GUARD_CARD
    out = {"card": card.strip(), "held": held, "ms": now,
           "recorded_ms": GUARD_MS, "ratio": ratio,
           "profiler_misses": PROFILER_MISSES,
           "profiler_leads_ms": PROFILER_LEADS,
           f"past_{GUARD_NOTE}": [k for k, r in ratio.items()
                                  if r > GUARD_NOTE]}
    print(json.dumps({"speed_guard": out}), flush=True)
    if held:
        slow = {k: r for k, r in ratio.items() if r > GUARD_SLACK}
        check(not slow, f"kernels slower than their recorded times by more "
              f"than {GUARD_SLACK}x: {slow}")
    return out


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
    from raft_tpu_torch.ops import select_slotted as k3
    from raft_tpu_torch.ops import unexpanded as k8
    from raft_tpu_torch.random import make_blobs

    t_start = time.perf_counter()
    phase_s, t_phase = {}, [t_start]

    def phase_end(name: str):
        now = time.perf_counter()
        phase_s[name] = now - t_phase[0]
        t_phase[0] = now

    # ---- phase 1: device and build ----
    card = gpu_name_power()
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda})", flush=True)
    t0 = time.perf_counter()
    _build.build_all(["fused_l2_packed_sm90", "fused_l2_topk", "fine_scan",
                      "pq_scan", "spmv",
                      "sddmm", "unexpanded", "histogram", "select_slotted"])
    k1._launcher()
    k1._launcher_q8()
    k1._launcher_dchunk()
    k1._launcher_group()
    k1._launcher_slot(False)
    k1._launcher_slot(True)
    k3._launcher()
    k4._launcher()
    k5._launcher()
    _build.load("spmv")
    _build.load("sddmm")
    k8._launcher()
    k9._launcher()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.BUILD_SECONDS})", flush=True)
    for name, log in _build.BUILD_LOG.items():
        ptxas_report(name, log)
    # the wgmma kernels (K1, K2, K1's d-chunked and slot forms): every
    # instance built without a spill; the fold's SASS instructions a score
    # (fold_issue_ms beside bound_ms)
    packed_regs = ptxas_packed(_build.BUILD_LOG.get("fused_l2_packed_sm90",
                                                    ""))
    if "fused_l2_packed_sm90" in _build.BUILD_LOG:   # (not when reloaded)
        check(len(packed_regs) == PACKED_INSTANCES and all(
            r.get("spill_bytes") == 0 for r in packed_regs.values()),
            f"the packed kernel's instances spill or are missing: "
            f"{packed_regs}")
    check(not hasattr(_build.load("fused_l2_topk"),
                      "fused_l2_slot_topk_launch"),
          "fused_l2_topk.cu still exports a slot form")
    fold_ops = sass_fold_ops()
    print(json.dumps({"packed_ptxas": packed_regs,
                      "packed_sass_fold_ops": fold_ops}), flush=True)
    print(json.dumps({"k4_k7_ptxas": ptxas_fatal(_build.BUILD_LOG)}),
          flush=True)
    phase_end("build")

    # ---- phase 2: K1 and K2 against their twins ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    twins = {}
    for d_twin in (128, 512):
        twins.update(k1_k2_twins(gen, d=d_twin))
    # K1's d-chunked form: resident and streamed queries, every cluster
    twins.update(dchunk_twins_all(gen))
    # K1 and K2 once more, with ±inf and NaN planted; then K1's slot forms
    nonfinite = nonfinite_k1_k2(gen)
    nonfinite.update(nonfinite_slot(gen))
    nonfinite["inf_row_knn"] = inf_row_knn(gen)
    phase_end("twins")

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
        inst = f"p{index.passes}{'_pair' if pair else ''}"
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by, "library_ms": library_ms,
               "max_abs_err": err,
               "fold_issue_ms": fold_issue_ms(
                   fold_ops[inst]["per_score"], N_QUERIES, Mi),
               "ptxas": packed_regs.get(inst)}
        if index.passes == 1:
            entry = {"name": "fused_l2_group_topk_packed", "route": "cuda",
                     "source": "raft_tpu_torch/ops/csrc/"
                               "fused_l2_packed_sm90.cu",
                     "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:1269",
                     "launches": sum(launches[n] for n in ("p1", "p3",
                                                           "p1_f32")),
                     **row, "library_note": MATMUL_NOTE}
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
        inst = f"p{index.passes}{'_pair' if pair else ''}_q8"
        row = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": bound_by, "library_ms": lib_ms,
               "max_abs_err": err, "tie_slots": n_diff,
               "launches_per_batch": launches[f"int8_p{index.passes}"],
               "fold_issue_ms": fold_issue_ms(
                   fold_ops[inst]["per_score"], N_QUERIES, M8),
               "ptxas": packed_regs.get(inst)}
        if index.passes == 1:
            k2_entry = {
                "name": "fused_l2_group_topk_packed_q8", "route": "cuda",
                "source": "raft_tpu_torch/ops/csrc/fused_l2_packed_sm90.cu",
                "replaces": "raft_tpu/ops/fused_l2_topk_pallas.py:1465",
                "launches": launches["int8_p1"] + launches["int8_p3"],
                **row, "library_note": MATMUL_NOTE}
        else:
            k2_entry["p3"] = row
        print(f"K2 at the main path, passes={index.passes} pair={pair}: "
              f"{json.dumps(row)}", flush=True)
    torch.cuda.synchronize()

    for name, (index, certify) in runs.items():
        br = profile_run(lambda: distance.knn(res, index, Qx, k=K,
                                              certify=certify))
        print(json.dumps({"profile": name, **br}), flush=True)
    del idx8_1, idx8_3, runs, index, args
    torch.cuda.empty_cache()
    # ---- the reference's K1 stage ladder on these operands ----
    ladder, slot_entry = k1_ladder(idx1, idx3, Qx)
    del X, Qx, idx1, idx3, o_vals, o_ids
    torch.cuda.empty_cache()
    phase_end("main_path")

    # ---- phase 10 (run here, on a fresh index): serving ----
    serving, serve_launches = serving_phase(res)
    entry["serving_launches"] = serve_launches["brute_bf16"]
    k2_entry["serving_launches"] = serve_launches["brute_int8"]
    torch.cuda.empty_cache()
    phase_end("serving")

    # ---- phases 4–6: K4 against its twin, IVF-Flat, then IVF-PQ ----
    data = ann_data(res, N_INDEX, N_QUERIES)
    kept = {}
    ivf, k4_entries = ivf_phase(res, N_INDEX, N_QUERIES, IVF_LISTS,
                                data=data, keep=kept)
    torch.cuda.empty_cache()
    phase_end("ivf")
    ivf_pq, k5_entries = pq_phase(res, data, IVF_LISTS, keep=kept)
    torch.cuda.empty_cache()
    phase_end("ivf_pq")

    # ---- phase 15 (run here, on phase 5's and 6's indexes): mutable ----
    mutable, mut_launches = mutable_phase(res, kept["ivf_flat"],
                                          kept["ivf_pq"], data)
    entry["mutable_launches"] = mut_launches["K1"]
    k2_entry["mutable_launches"] = mut_launches["K2"]
    k5_entries[0]["mutable_launches"] = mut_launches["K5"]
    del data, kept
    torch.cuda.empty_cache()
    phase_end("mutable")

    # ---- phases 7–9: the spectral path ----
    spectral, sparse_entries = spectral_phase(res)
    torch.cuda.empty_cache()
    phase_end("spectral")

    # ---- phase 11: pairwise distances and stats ----
    pairwise_stats, k89_entries = pairwise_stats_phase(res)
    torch.cuda.empty_cache()
    phase_end("pairwise_stats")

    # ---- phase 12: select_k and K3 ----
    select, k3_entry = select_k_phase(res)
    torch.cuda.empty_cache()
    phase_end("select_k")

    # ---- phase 13: wide and unpacked brute-force KNN ----
    wide, wide_entries = wide_knn_phase(res)
    torch.cuda.empty_cache()
    phase_end("wide_knn")

    # ---- phase 16: the SVD family, BASELINE config 3 whole ----
    svd = svd_phase(res)
    torch.cuda.empty_cache()
    phase_end("svd")

    # ---- phase 14: the summary ----
    print(json.dumps({"nonfinite_k1_k2": nonfinite}), flush=True)
    print(json.dumps({"main_path": main_path}), flush=True)
    print(json.dumps({"k1_ladder": ladder}), flush=True)
    print(json.dumps({"serving": serving}), flush=True)
    print(json.dumps({"ivf": ivf}), flush=True)
    print(json.dumps({"ivf_pq": ivf_pq}), flush=True)
    print(json.dumps({"mutable": mutable}), flush=True)
    print(json.dumps({"spectral": spectral}), flush=True)
    print(json.dumps({"pairwise_stats": pairwise_stats}), flush=True)
    print(json.dumps({"select_k": select}), flush=True)
    print(json.dumps({"wide_knn": wide}), flush=True)
    print(json.dumps({"svd": svd}), flush=True)
    kernels = [entry, k2_entry, slot_entry, k3_entry, *wide_entries,
               *k4_entries, *k5_entries, *sparse_entries, *k89_entries]
    speed_guard(card, kernels)
    print(json.dumps({"phase_s": phase_s}), flush=True)
    print(f"wall: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
