// K1's packed forms and its int8-database form K2 for Hopper (sm_90a): the
// fused expanded-L2 contraction and the packed group top-2 / 3rd-min fold,
// on wgmma fed by TMA through an mbarrier ring. Bound to Python through
// plain C entry points.
//
// Replaces raft_tpu/ops/fused_l2_topk_pallas.py:fused_l2_group_topk_packed
// (:1269; its database-major forms _packed_db :1425 and _packed_dbuf :1444
// compute the same outputs in another TPU grid order) — K1 — its
// wide-feature form fused_l2_group_topk_packed_dchunk (:1294), and
// fused_l2_group_topk_packed_db_q8 / _dbuf_q8 (:1465, :1491) — K2.
//
// What it computes (the reference's packed forms' function, bit for bit in
// what it promises). For every query q and database row n
// (rows padded to whole tiles of T; padded rows carry 2^125 in yyh):
//     c[q, n] = (yyh[n] - x[q]·y[n]) + xxh[q]            (= d2/2 for l2)
// with x·y a bf16 contraction accumulated in f32: passes=1 is
// bf16(x)·y_hi; passes=3 adds bf16(x)·y_lo + bf16(x - bf16(x))·y_hi. K2
// streams int8 codes q8, one scale per group G: the codes (|q| <= 127)
// are widened exactly to bf16, and the d-sum bf16(x)·q8 (+ the x-lo
// product at passes=3) is multiplied by scale[G] once, rounded on its own
// (__fmul_rn). A bucket is (lane = n % 128, group of g tiles); row n's
// code is its chunk index within the group, written into the low `pbits`
// mantissa bits. Per bucket the fold keeps a1 <= a2, the two smallest
// packed values, and a3, the third smallest, by the reference's 5-op
// min/max network in chunk order; `pair` first min-combines chunks 2i and
// 2i+1 (the loser goes to a3, the winner carries code 2i, +1 when it came
// from the odd chunk). Every min/max is PTX min.NaN / max.NaN, so a NaN
// (a ±inf score with code bits OR'd in) reaches a3 and fails the query's
// certificate, as the reference's jnp.minimum/maximum do.
//
// Precision contract. Both factors of every product are bf16 rounded to
// nearest, so each product is exact in f32, and wgmma accumulates in f32
// (the arithmetic knn_fused._err_bound_coeff / _err_bound_coeff_p1 are
// written for). No TF32, and K2 does not use the int8 tensor cores: they
// would need the query quantized too, which the certificate does not
// cover.
//
// Bound on this card. At the main path's shape (2048 queries × ~1M rows ×
// 128) K1 does 2·Q·M·d = 5.3e11 bf16 FLOP at passes=1 (×3 at passes=3, K2
// ×2): 0.531 ms at the 989 TFLOP/s bf16 peak, against 0.26 GB of y (K2
// 0.13 GB). The fold is ~8 FP32/ALU instructions a score (two adds, the
// pack's LOP3 and the five min/max; K2 adds the scale's FMUL; pair turns
// two scores' 16 into 15): 2.1e9 scores × 8 ≈ 1.6e10 instructions, ~0.5
// ms at the 33.45e12/s issue rate. The tensor cores and the fold are
// near-equal, so the design overlaps them, and keeps the re-reads of y
// from L2 down.
//
// Design. A block owns 128 queries (QB; 64 where the resident query block
// would not leave room for four ring stages, d·passes large) × one half
// (64 lanes) of each 128-row chunk of one group: blockIdx = (query block,
// group, lane half). Every output slot is written once, by one thread.
// Each block thus reads half of its group's rows, and the rows of a group
// are re-read from L2 by Q/128 query blocks (Q/64 with 64-query blocks):
// 4.2 GB of L2 traffic at p1 on the main path instead of 8.4.
//   - 384 threads: two consumer warpgroups (queries 0–63 and 64–127 of the
//     block) and one producer warpgroup. K1: the producer's first thread
//     issues the TMA loads of the ring: a stage is one k-slice of 64
//     features × the 64 rows of a chunk half, 128-byte swizzled (y_hi, and
//     y_lo at passes=3), and on a chunk's last k-slice the 64 yyh values
//     (a bulk copy). Stages cycle through full/empty mbarrier pairs; the
//     tensor maps are built on the host per launch and passed as
//     __grid_constant__ parameters.
//   - K2: TMA brings 64 × 64 int8 slices into a 4-stage int8 ring; the
//     producer warpgroup's 128 threads widen each into the bf16 ring's
//     swizzled slice (a PRMT, two ANDs and one bf16x2 subtract per pair of
//     codes, exact: bf16(0x4300 | b & 0x7f) − bf16(0x4300 | b & 0x80) =
//     b), so the consumers see K1's ring; the warpgroup's thread 0
//     reissues an int8 stage's TMA once all 128 have read it (a named
//     barrier). 128 queries a block halve the widening a query against 64.
//   - The query block is rounded to bf16 hi (and lo) once and written,
//     swizzled, into shared memory, where it stays: wgmma's A.
//   - Consumers run wgmma.mma_async m64n64k16 bf16 → f32, A and B from
//     shared memory. A thread's accumulator slots are fixed (query, lane)
//     pairs for every chunk (2 queries × 16 lanes), so its 32 buckets' a1,
//     a2, a3 (and the even chunk's scores under pair) live in registers
//     across the whole group: 32 accumulators + 96–128 fold registers.
//   - Overlap. Two accumulator sets: the consumer issues the first two
//     k-slices of chunk c+1's wgmma (the whole chunk at d = 128) before
//     folding chunk c, and waits with wgmma.wait_group, so the fold runs
//     while the tensor cores work. The stage holding chunk c's yyh
//     is released after the fold; every other stage as soon as the wgmma
//     that read it is complete.
//   - The producer runs with 40 registers, the consumers with 232
//     (setmaxnreg).
//
// The d-chunked form (d > 512 on the path: wide_knn's 1000 queries × 1M ×
// 1024 after padding). Its products, 2·Q·M·d = 2.05e12 FLOP at passes=1,
// take 1.944 ms at the bf16 peak, and the fold runs once per d/64 = 16
// k-slices, so what bounds it is feeding the tensor cores: at 64 queries ×
// 128 rows a tile, streaming both operands moves (1/64 + 1/128)·Q·M·d·2 ≈
// 48 GB from L2 into shared memory at passes=1 (×2 at passes=3), ~24 TB/s
// at the tensor bound, several times what L2 delivers. The design cuts
// that traffic:
//   - blockIdx = (64-query block, group): both consumer warpgroups share
//     the block's A (64 queries) and take the two lane halves of every
//     chunk, so a block folds whole chunks and each y row reaches it once.
//   - Where x_arrays·d·128 bytes leave room for 4 ring stages (passes=1
//     to d = 1024) the block's queries stay resident (one TMA load of
//     x_hi, and x_lo), else their 64-row k-slices stream beside y's.
//   - Clusters of ncta consecutive query blocks of one group (ncta = 1 or
//     2, picked on the host by pick_wide_geo) share y: each block's
//     producer loads 128/ncta rows of every y slice and multicasts them
//     to all, so the group's rows leave L2 Q/(64·ncta) times instead of
//     Q/64. A stage is refilled only when every block's 8 consumer warps
//     have arrived on the loading block's empty barrier (each warp
//     arrives on all of them).
//   Modelled at wide_knn's shape, passes=1 resident with ncta = 2: y 2.05
//   GB × 16/2 = 16.4 GB, x and yyh 0.13 GB; passes=3 streamed: y 4.1 GB ×
//   8 = 32.8 GB plus x 32.8 GB (16 KB a block a step: x_hi and x_lo are
//   re-read once a chunk), against ~96 GB before.
//   The consumer loop (issue, fold, release) is the resident form's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHalf = 64;           // lanes of a chunk a block takes
constexpr int kKS = 64;             // features a k-slice (128 B of bf16)
constexpr int kThreads = 384;       // 2 consumer warpgroups + 1 producer
constexpr int kSlice = kHalf * kKS * 2;    // bytes of one bf16 slice
constexpr int kQSlice = kHalf * kKS;       // bytes of one int8 slice
constexpr int kYY = kHalf * 4;             // bytes of a chunk half's yyh
constexpr int kQRing = 4;           // int8 stages (K2)
constexpr int kMaxStages = 12;
constexpr int kPre = 2;             // k-slices of the next chunk in flight
                                    // while a chunk folds (d >= 128)
constexpr int kConverters = 128;    // K2: the producer warpgroup
constexpr float kPackPad = 4.2535295865117308e37f;   // 2^125

struct Args {
  const float* x;         // [Q, d] f32
  const float* yyh;       // [M] f32
  const float* xxh;       // [Q] f32
  const float* scale;     // [M / (g·T)] f32 (K2)
  float* a1;
  float* a2;
  float* a3;
  int Q, M, d, T, g, pbits;
};

// the launch geometry the host picks: queries a block and ring stages
struct Geo {
  int QB, NS;
};

// shared memory, from a 1024-byte aligned base: the query block (x_arrays
// × d/64 tiles of QB rows × 128 B), the bf16 ring (NS × y_arrays slices),
// its yyh slots, (K2) the int8 ring and its yyh slots, the barriers
struct Layout {
  uint32_t a, ring, yy, q, qyy, bar, total;
  __host__ __device__ Layout(int QB, int NS, int d, int x_arrays,
                             int y_arrays, bool q8) {
    a = 0;
    ring = static_cast<uint32_t>(x_arrays * QB * d * 2);
    yy = ring + NS * y_arrays * kSlice;
    q = yy + NS * kYY;
    qyy = q + (q8 ? kQRing * kQSlice : 0);
    bar = qyy + (q8 ? kQRing * kYY : 0);
    total = bar + 8 * (2 * NS + kQRing);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
// one arrival where `pred` holds (a predicated instruction: no branch, so
// the code around the wgmma stays warp-uniform for the compiler)
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}
// wait for the completion of the phase of parity `parity`. The loop lives
// in the asm (the compiler sees no divergent branch before a wgmma); each
// try suspends the thread for at most ~1 µs, and a ring that stalls for
// 2^24 tries (~17 s) traps, so the launch fails instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 n;\nmov.u32 n, 0;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1, 1000;\n"
      "@p bra.uni DONE;\n"
      "add.u32 n, n, 1;\n"
      "setp.gt.u32 p, n, 16777216;\n"
      "@p trap;\n"
      "bra.uni LAB_WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---- TMA ----
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
               : "=r"(v.x), "=r"(v.y)
               : "r"(a));
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- thread block clusters (the d-chunked form) ----
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster arrives and waits
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the address of this block's shared word `addr` in block `rank` of the
// cluster
__device__ __forceinline__ uint32_t map_cta(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// one arrival on a cluster barrier address where `pred` holds
__device__ __forceinline__ void mbar_arrive_remote_if(uint32_t bar,
                                                      bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(static_cast<int>(pred))
      : "memory");
}
// a TMA load written at the same offset into every block of `mask`, each
// block's barrier at `bar`'s offset counting its bytes
__device__ __forceinline__ void tma_2d_multicast(uint32_t dst,
                                                 const CUtensorMap* map,
                                                 int c0, int c1, uint32_t bar,
                                                 uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"(mask)
      : "memory");
}

// ---- wgmma ----
// a K-major operand in 128-byte swizzled rows (TMA's SWIZZLE_128B): 8-row
// groups 1024 B apart; a step of 16 features adds 32 B to the start
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator registers across the
// asynchronous wgmma boundary
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A·B, m64n64k16, bf16 → f32, both operands K-major in shared
// memory; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// ---- the fold (fused_l2_topk.cu's, unchanged) ----
__device__ __forceinline__ float pack(float c, uint32_t keep, int code) {
  return __int_as_float((__float_as_int(c) & keep) | code);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
// _merge_chunk_top2_packed: with a1 <= a2, the round-1 loser either stays
// >= a2 or becomes the new 2nd; the round-2 loser is the 3rd smallest
__device__ __forceinline__ void merge(float cp, float& a1, float& a2,
                                      float& a3) {
  float b1 = max_nan(a1, cp);
  a1 = min_nan(a1, cp);
  float b2 = max_nan(a2, b1);
  a2 = min_nan(a2, b1);
  a3 = min_nan(a3, b2);
}

// four int8 codes (one 32-bit word, bytes b0..b3) → two bf16x2 words,
// exactly: bf16(0x4300 | b & 0x7f) − bf16(0x4300 | b & 0x80) is 128 + r −
// 128 = r for b >= 0 and 128 + r − 256 = b for b < 0 (r = b & 0x7f). One
// PRMT puts two codes under 0x43 high bytes, one AND each makes the two
// operands: 4 ALU instructions and a subtract per pair of codes
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  const uint32_t z0 = __byte_perm(w, 0x43434343u, 0x4140);   // 43 b1 43 b0
  const uint32_t z1 = __byte_perm(w, 0x43434343u, 0x4342);   // 43 b3 43 b2
  const uint32_t x0 = z0 & 0xFF7FFF7Fu, y0 = z0 & 0xFF80FF80u;
  const uint32_t x1 = z1 & 0xFF7FFF7Fu, y1 = z1 & 0xFF80FF80u;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(lo) : "r"(x0), "r"(y0));
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(hi) : "r"(x1), "r"(y1));
}

// the forms one Consumer serves: the resident packed kernel (K1, K2), and
// the d-chunked one with its query block resident or streamed
enum Mode : int { kResident = 0, kWideRes = 1, kWideStream = 2 };

// bytes of a d-chunked stage: a 128-row y slice a y array (the block's
// whole chunk), then where x streams the 64-row x slices
constexpr int kWSlice = 2 * kSlice;        // 128 rows × 64 features bf16
constexpr int kWYY = 2 * kYY;              // a chunk's 128 yyh values

// A consumer warpgroup. Resident packed form: its 64 queries of the
// block against the chunk halves of the ring. d-chunked form: the block's
// 64 queries against its lane half (wg) of each chunk. Either way the fold
// state of its 64 × 64 buckets (32 a thread) lives in registers.
// acc[c & 1] takes chunk c.
template <int PASSES, bool PAIR, bool Q8, int MODE = kResident>
struct Consumer {
  static constexpr int x_arrays = PASSES == 3 ? 2 : 1;
  static constexpr int y_arrays = (PASSES == 3 && !Q8) ? 2 : 1;
  static constexpr int y_slice = MODE == kResident ? kSlice : kWSlice;
  static constexpr int stage_bytes =
      y_arrays * y_slice + (MODE == kWideStream ? x_arrays * kSlice : 0);
  static constexpr int yy_bytes = MODE == kResident ? kYY : kWYY;
  uint32_t a_hi, a_lo, ring, yy, full0, empty0, empty_r;
  int NS, ksl, tile_bytes, lane, lq, n_chunks, ncta;
  // d-chunked form: this warpgroup's lane half of a stage's y slice and
  // of its yyh values
  uint32_t b_off, yy_off;
  uint32_t keep;
  float gscale, xh[2];
  // steps (chunk, k-slice) counted without a division: the next one to
  // issue (its stage, phase and k-slice), the next one to release (its
  // stage), the held one (a chunk's last step, whose stage keeps the
  // chunk's yyh until the fold) and the last step issued of a chunk
  int iss, iss_st, iss_ph, iss_kk, rel, rel_st, held, held_st;
  int last, last_st;
  float acc[2][32], a1[32], a2[32], a3[32], ce[32];

  // issue the next step's wgmma into acc[B]; the caller commits
  template <int B>
  __device__ __forceinline__ void issue() {
    const int st = iss_st, kk = iss_kk;
    mbar_wait(full0 + 8 * st, iss_ph);
    uint64_t dah, dal;
    uint32_t b;
    if constexpr (MODE == kResident) {
      dah = desc_sw128(a_hi + kk * tile_bytes);
      dal = desc_sw128(a_lo + kk * tile_bytes);
      b = ring + st * stage_bytes;
    } else {
      const uint32_t stage = ring + st * stage_bytes;
      // A: the resident query block's k-slice, or the stage's x slices
      const uint32_t ah = MODE == kWideStream ? stage + y_arrays * y_slice
                                              : a_hi + kk * tile_bytes;
      dah = desc_sw128(ah);
      dal = desc_sw128(MODE == kWideStream ? ah + kSlice
                                           : a_lo + kk * tile_bytes);
      b = stage + b_off;
    }
    const uint64_t dbh = desc_sw128(b);
    const uint64_t dbl = desc_sw128(b + (Q8 ? 0 : y_slice));
    fence_acc(acc[B]);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_m64n64(acc[B], dah + 2 * k, dbh + 2 * k, (kk | k) != 0);
    if (PASSES == 3) {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_m64n64(acc[B], dal + 2 * k, dbh + 2 * k, 1);
      if (!Q8) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_m64n64(acc[B], dah + 2 * k, dbl + 2 * k, 1);
      }
    }
    if (kk == ksl - 1) {
      last = iss;
      last_st = st;
    }
    ++iss;
    iss_kk = kk + 1 == ksl ? 0 : kk + 1;
    iss_st = st + 1 == NS ? 0 : st + 1;
    iss_ph ^= st + 1 == NS;
  }

  // one arrival a warp on stage st's empty barrier where `pred`: the
  // block's own, or (d-chunked) every block's of the cluster, whose loads
  // all write into this stage — lane r arrives on block r's
  __device__ __forceinline__ void release(int st, bool pred) {
    if constexpr (MODE == kResident)
      mbar_arrive_if(empty0 + 8 * st, pred & (lane == 0));
    else
      mbar_arrive_remote_if(empty_r + 8 * st, pred & (lane < ncta));
  }

  // release every complete step below `upto` but the held one (its yyh is
  // read by the fold)
  __device__ __forceinline__ void release_upto(int upto) {
    for (; rel < upto; ++rel) {
      release(rel_st, rel != held);
      rel_st = rel_st + 1 == NS ? 0 : rel_st + 1;
    }
  }

  // fold chunk c from acc[B] (its yyh in the held stage's slot); under
  // pair an even chunk only keeps its scores for its odd partner
  template <int B>
  __device__ __forceinline__ void fold(int c) {
    const uint32_t yy_s = yy + held_st * yy_bytes +
                          (MODE == kResident ? 0u : yy_off) + 8 * lq;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint2 yb = lds64(yy_s + 32 * j);
      const float2 yv = make_float2(__uint_as_float(yb.x),
                                    __uint_as_float(yb.y));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        const float y = (e & 1) ? yv.y : yv.x;
        // K2: the group scale multiplies the finished d-sum, rounded on
        // its own (no fused multiply-add), as the twin computes it
        const float dot = Q8 ? __fmul_rn(acc[B][i], gscale) : acc[B][i];
        const float cv = __fadd_rn(y - dot, xh[e >> 1]);
        if (PAIR && B == 0) {
          // pinned here: left to the scheduler, these reads of acc[0]
          // drift among the next wgmma and ptxas serialises the pipeline
          ce[i] = cv;
          asm volatile("" : "+f"(ce[i]));
        } else if (PAIR) {
          const float c0 = ce[i];
          const float mn = min_nan(c0, cv);
          a3[i] = min_nan(a3[i], max_nan(c0, cv));
          const int code = (mn == cv) ? c : c - 1;
          merge(pack(mn, keep, code), a1[i], a2[i], a3[i]);
        } else {
          merge(pack(cv, keep, c), a1[i], a2[i], a3[i]);
        }
      }
    }
  }

  // chunk c is issued (its last step held): issue the first kPre k-slices
  // of chunk c+1 into the other accumulators, wait for chunk c (every
  // group but those), fold it while they run, release its held stage, then
  // issue the rest of chunk c+1. Each issue is committed at once, with no
  // branch between (ptxas would close the group early and count an empty
  // one), and every wait count is a constant, so ptxas sees which
  // accumulators are done and keeps the wgmma asynchronous
  template <int B>
  __device__ __forceinline__ void chunk(int c) {
    const bool more = c + 1 < n_chunks;
    if (more) {
      issue<1 - B>();
      wgmma_commit();
      issue<1 - B>();
      wgmma_commit();
      wgmma_wait<kPre>();
      release_upto(iss - kPre);
    } else {
      wgmma_wait<0>();
      release_upto(iss);
    }
    fence_acc(acc[B]);
    fold<B>(c);
    __syncwarp();
    release(held_st, true);
    if (more) {
      for (int t = kPre; t < ksl; ++t) {
        issue<1 - B>();
        wgmma_commit();
        wgmma_wait<1>();
        release_upto(iss - 1);
      }
      held = last;
      held_st = last_st;
    }
  }

  // the mainloop and the store of this warpgroup's bucket slots: queries
  // q_base + its 64 rows of A, output columns col_base + its 64 lanes;
  // setup(*this) sets the form's ring and operands once lane is known
  template <class Setup>
  __device__ __forceinline__ void run(const Args& p, int cw, int q_base,
                                      int col_base, int grp, Setup setup) {
    const int warp = cw >> 5;
    lane = cw & 31;
    lq = lane & 3;
    setup(*this);
    keep = ~((1u << p.pbits) - 1u);
    gscale = Q8 ? p.scale[grp] : 1.f;
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      const int q = q_base + warp * 16 + (lane >> 2) + 8 * hq;
      xh[hq] = q < p.Q ? p.xxh[q] : 0.f;
    }
    // (acc is not initialised: each chunk's first wgmma overwrites it, and
    // a zero the register allocator rematerialises beside a wgmma in
    // flight would serialise the pipeline)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      a1[i] = a2[i] = a3[i] = kPackPad;
      ce[i] = 0.f;
    }
    iss = iss_st = iss_ph = iss_kk = rel = rel_st = 0;
    held = -1;
    for (int t = 0; t < ksl; ++t) {
      issue<0>();
      wgmma_commit();
      if (t > 0) {
        wgmma_wait<1>();
        release_upto(iss - 1);
      }
    }
    held = last;
    held_st = last_st;
    for (int c = 0; c < n_chunks; c += 2) {
      chunk<0>(c);
      if (c + 1 < n_chunks) chunk<1>(c + 1);
    }

    // ---- every bucket slot of this warpgroup is written once ----
    const int S = gridDim.y * 128;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = col_base + 8 * j + 2 * lq;
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int q = q_base + warp * 16 + (lane >> 2) + 8 * hq;
        if (q < p.Q) {
          const long o = static_cast<long>(q) * S + col;
          const int i = 4 * j + 2 * hq;
          *reinterpret_cast<float2*>(p.a1 + o) =
              make_float2(a1[i], a1[i + 1]);
          *reinterpret_cast<float2*>(p.a2 + o) =
              make_float2(a2[i], a2[i + 1]);
          *reinterpret_cast<float2*>(p.a3 + o) =
              make_float2(a3[i], a3[i + 1]);
        }
      }
    }
  }
};

template <int PASSES, bool PAIR, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
packed_sm90_kernel(const __grid_constant__ CUtensorMap tm_hi,
                   const __grid_constant__ CUtensorMap tm_lo, const Args p,
                   const Geo geo) {
  constexpr int x_arrays = PASSES == 3 ? 2 : 1;
  constexpr int y_arrays = (PASSES == 3 && !Q8) ? 2 : 1;
  constexpr int stage_bytes = y_arrays * kSlice;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);

  const int QB = geo.QB, NS = geo.NS;
  const int d = p.d, ksl = d / kKS;
  const Layout L(QB, NS, d, x_arrays, y_arrays, Q8);
  const uint32_t full0 = base + L.bar, empty0 = full0 + 8 * NS;
  const uint32_t qfull0 = empty0 + 8 * NS;
  const int n_wg = QB / 64;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int grp = blockIdx.y, h = blockIdx.z;
  const int n_ch = p.T / 128;
  const int n_tiles = p.M / p.T;
  const int n_chunks = min(p.g, n_tiles - grp * p.g) * n_ch;
  const int n_steps = n_chunks * ksl;
  const int row0 = grp * p.g * p.T + h * kHalf;   // + c·128 for chunk c

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, Q8 ? kConverters / 32 : 1);
      mbar_init(empty0 + 8 * s, 4 * n_wg);
    }
    if (Q8)
      for (int s = 0; s < kQRing; ++s) mbar_init(qfull0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // ---- the query block, rounded to bf16 hi (and lo) once, swizzled:
  // feature k of row r sits in tile k / 64 at r·128 + ((k/8 % 8) ^ (r %
  // 8))·16 + (k % 8)·2 ----
  const int tile_bytes = QB * 128;
  for (int i = tid; i < QB * (d / 8); i += kThreads) {
    const int r = i / (d / 8), k8 = i - r * (d / 8);
    const int q = q0 + r;
    float v[8];
    if (q < p.Q) {
      const float4* src =
          reinterpret_cast<const float4*>(p.x + static_cast<long>(q) * d) +
          2 * k8;
      const float4 u0 = src[0], u1 = src[1];
      v[0] = u0.x; v[1] = u0.y; v[2] = u0.z; v[3] = u0.w;
      v[4] = u1.x; v[5] = u1.y; v[6] = u1.z; v[7] = u1.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
    uint32_t whi[4], wlo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16 h0 = __float2bfloat16_rn(v[2 * j]);
      const __nv_bfloat16 h1 = __float2bfloat16_rn(v[2 * j + 1]);
      const __nv_bfloat16 l0 =
          __float2bfloat16_rn(v[2 * j] - __bfloat162float(h0));
      const __nv_bfloat16 l1 =
          __float2bfloat16_rn(v[2 * j + 1] - __bfloat162float(h1));
      whi[j] = __bfloat16_as_ushort(h0) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
      wlo[j] = __bfloat16_as_ushort(l0) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(l1)) << 16);
    }
    const int off = (k8 >> 3) * tile_bytes + r * 128 +
                    (((k8 & 7) ^ (r & 7)) << 4);
    *reinterpret_cast<uint4*>(sbase + L.a + off) =
        make_uint4(whi[0], whi[1], whi[2], whi[3]);
    if (PASSES == 3)
      *reinterpret_cast<uint4*>(sbase + L.a + ksl * tile_bytes + off) =
          make_uint4(wlo[0], wlo[1], wlo[2], wlo[3]);
  }
  fence_async_shared();
  __syncthreads();

  // the warpgroup index, warp-uniform for the compiler (a shuffle), so it
  // does not see the wgmma paths as divergent
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == 2) {
    // ================= producer warpgroup =================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (!Q8) {
      if (tid == 256) {
        // step s = (chunk c, k-slice kk) into stage st of phase ph,
        // counted without a division
        int c = 0, kk = 0, st = 0, ph = 0;
        for (int s = 0; s < n_steps; ++s) {
          const bool last = kk == ksl - 1;
          const int row = row0 + c * 128;
          if (s >= NS) mbar_wait(empty0 + 8 * st, ph ^ 1);
          const uint32_t fb = full0 + 8 * st;
          mbar_expect_tx(fb, stage_bytes + (last ? kYY : 0));
          const uint32_t dst = base + L.ring + st * stage_bytes;
          tma_2d(dst, &tm_hi, kk * kKS, row, fb);
          if (PASSES == 3) tma_2d(dst + kSlice, &tm_lo, kk * kKS, row, fb);
          if (last) bulk_copy(base + L.yy + st * kYY, p.yyh + row, kYY, fb);
          c += last;
          kk = last ? 0 : kk + 1;
          ph ^= st + 1 == NS;
          st = st + 1 == NS ? 0 : st + 1;
        }
      }
    } else {
      // ---- K2: the whole warpgroup widens each int8 slice into the bf16
      // ring; its thread 0 keeps the int8 ring's TMA loads kQRing steps
      // ahead, reissuing into a stage once all 128 have read it ----
      const int ct = tid - 256;
      auto load_q8 = [&](int s) {
        const int c = s / ksl, kk = s - c * ksl;
        const int row = row0 + c * 128, si = s & (kQRing - 1);
        const uint32_t fb = qfull0 + 8 * si;
        mbar_expect_tx(fb, kQSlice + (kk == ksl - 1 ? kYY : 0));
        tma_2d(base + L.q + si * kQSlice, &tm_hi, kk * kKS, row, fb);
        if (kk == ksl - 1)
          bulk_copy(base + L.qyy + si * kYY, p.yyh + row, kYY, fb);
      };
      if (ct == 0)
        for (int s = 0; s < kQRing && s < n_steps; ++s) load_q8(s);
      int kk = 0, st = 0, ph = 0, si = 0, qph = 0;
      for (int s = 0; s < n_steps; ++s) {
        mbar_wait(qfull0 + 8 * si, qph);
        if (s >= NS) mbar_wait(empty0 + 8 * st, ph ^ 1);
        const uint32_t qs = base + L.q + si * kQSlice;
        const uint32_t bs = base + L.ring + st * stage_bytes;
        // 512 units of 8 codes: row u / 8, features (u % 8)·8, one
        // 16-byte chunk of the swizzled bf16 row; a thread's 4 units are
        // loaded together, then widened and stored
        constexpr int kUnits = kHalf * 8 / kConverters;
        uint2 w[kUnits];
#pragma unroll
        for (int j = 0; j < kUnits; ++j) {
          const int u = ct + j * kConverters;
          w[j] = lds64(qs + (u >> 3) * kKS + (u & 7) * 8);
        }
#pragma unroll
        for (int j = 0; j < kUnits; ++j) {
          const int u = ct + j * kConverters, r = u >> 3;
          uint4 o;
          widen4(w[j].x, o.x, o.y);
          widen4(w[j].y, o.z, o.w);
          sts128(bs + r * 128 + (((u & 7) ^ (r & 7)) << 4), o);
        }
        if (kk == ksl - 1 && ct < kYY / 16)
          sts128(base + L.yy + st * kYY + ct * 16,
                 lds128(base + L.qyy + si * kYY + ct * 16));
        fence_async_shared();
        __syncwarp();
        mbar_arrive_if(full0 + 8 * st, (ct & 31) == 0);   // one a warp
        // every converter has read int8 stage si: reload it
        asm volatile("bar.sync 1, %0;\n" ::"n"(kConverters) : "memory");
        if (ct == 0 && s + kQRing < n_steps) load_q8(s + kQRing);
        kk = kk + 1 == ksl ? 0 : kk + 1;
        ph ^= st + 1 == NS;
        st = st + 1 == NS ? 0 : st + 1;
        qph ^= si == kQRing - 1;
        si = (si + 1) & (kQRing - 1);
      }
    }
    return;
  }

  // ================= consumer warpgroups =================
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (wg >= n_wg) return;          // a 64-query block uses one
  using Cons = Consumer<PASSES, PAIR, Q8>;
  Cons cons;
  cons.run(p, tid & 127, q0 + wg * 64, grp * 128 + h * kHalf, grp,
           [&](Cons& c) {
             c.NS = NS;
             c.ksl = ksl;
             c.n_chunks = n_chunks;
             c.tile_bytes = tile_bytes;
             c.full0 = full0;
             c.empty0 = empty0;
             c.ring = base + L.ring;
             c.yy = base + L.yy;
             // this warpgroup's 64 rows of each A tile
             c.a_hi = base + L.a + wg * 64 * 128;
             c.a_lo = c.a_hi + ksl * tile_bytes;
           });
}

// ---- the d-chunked form ----
// shared memory from a 1024-byte aligned base: the resident query block
// (XRES: x_arrays × d/64 tiles of 64 rows × 128 B), the ring (NS stages),
// its yyh slots (a chunk's 128 values), the barriers (full, empty, x)
struct WideLayout {
  uint32_t a, ring, yy, bar, total;
  __host__ __device__ WideLayout(int NS, int d, int passes, bool xres) {
    const int x_arrays = passes == 3 ? 2 : 1;
    const int stage = x_arrays * kWSlice + (xres ? 0 : x_arrays * kSlice);
    a = 0;
    ring = xres ? static_cast<uint32_t>(x_arrays * d * 128) : 0u;
    yy = ring + NS * stage;
    bar = yy + NS * kWYY;
    total = bar + 8 * (2 * NS + 1);
  }
};

// the d-chunked geometry the host picked (pick_wide_geo): ring stages,
// the cluster (consecutive query blocks of one group that share y), and
// whether the query block is resident
struct WideGeo {
  int NS, ncta, xres;
};

// The d-chunked form (reference _packed_dchunk): K1's contract for any d.
// A block owns 64 queries × one whole group (blockIdx = (query block,
// group)); its two consumer warpgroups take the two lane halves of each
// chunk against the same A. XRES keeps the block's queries resident
// (x_hi, and x_lo at passes=3, loaded once by TMA); otherwise their
// 64-row k-slices stream through the ring beside y's. The blocks of a
// cluster are consecutive query blocks of one group: each block's
// producer loads 1/ncta of every y slice and multicasts it to all of
// them, so the cluster reads the group's rows from L2 once, not ncta
// times; a stage is refilled only after every block's consumers released
// it (each consumer warp arrives on every block's empty barrier).
template <int PASSES, bool PAIR, bool XRES>
__global__ void __launch_bounds__(kThreads, 1)
wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_yhi,
                 const __grid_constant__ CUtensorMap tm_ylo,
                 const __grid_constant__ CUtensorMap tm_xhi,
                 const __grid_constant__ CUtensorMap tm_xlo, const Args p,
                 const WideGeo geo) {
  constexpr int MODE = XRES ? kWideRes : kWideStream;
  using Cons = Consumer<PASSES, PAIR, false, MODE>;
  constexpr int x_arrays = Cons::x_arrays;
  constexpr int y_arrays = Cons::y_arrays;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int NS = geo.NS, ncta = geo.ncta;
  const int d = p.d, ksl = d / kKS;
  const WideLayout L(NS, d, PASSES, XRES);
  const uint32_t full0 = base + L.bar, empty0 = full0 + 8 * NS;
  const uint32_t xfull = empty0 + 8 * NS;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * 64;
  // the x rows it loads (a block that only completes a cluster re-reads
  // the last real block's)
  const int qx = min(q0, (p.Q + 63) / 64 * 64 - 64);
  const int grp = blockIdx.y;
  const int n_ch = p.T / 128;
  const int n_tiles = p.M / p.T;
  const int n_chunks = min(p.g, n_tiles - grp * p.g) * n_ch;
  const int n_steps = n_chunks * ksl;
  const int row0 = grp * p.g * p.T;          // + c·128 for chunk c

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8 * ncta);     // 8 consumer warps a block
    }
    mbar_init(xfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any block loads into them
  cluster_sync();

  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == 2) {
    // ================= producer warpgroup =================
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 256) {
      const int rank = static_cast<int>(cluster_rank());
      const int part = 128 / ncta;            // y rows this block loads
      const uint16_t mask = static_cast<uint16_t>((1u << ncta) - 1u);
      constexpr int y_bytes = y_arrays * kWSlice;
      constexpr int stage_bytes = Cons::stage_bytes;
      if (XRES) {
        mbar_expect_tx(xfull, x_arrays * d * 128);
        for (int kk = 0; kk < ksl; ++kk) {
          tma_2d(base + L.a + kk * kSlice, &tm_xhi, kk * kKS, qx, xfull);
          if (PASSES == 3)
            tma_2d(base + L.a + (ksl + kk) * kSlice, &tm_xlo, kk * kKS, qx,
                   xfull);
        }
      }
      int c = 0, kk = 0, st = 0, ph = 0;
      for (int s = 0; s < n_steps; ++s) {
        const bool last = kk == ksl - 1;
        const int row = row0 + c * 128;
        if (s >= NS) mbar_wait(empty0 + 8 * st, ph ^ 1);
        const uint32_t fb = full0 + 8 * st;
        mbar_expect_tx(fb, y_bytes + (XRES ? 0 : x_arrays * kSlice) +
                               (last ? kWYY : 0));
        const uint32_t dst = base + L.ring + st * stage_bytes;
        const uint32_t mine = dst + rank * part * 128;
        tma_2d_multicast(mine, &tm_yhi, kk * kKS, row + rank * part, fb,
                         mask);
        if (PASSES == 3)
          tma_2d_multicast(mine + kWSlice, &tm_ylo, kk * kKS,
                           row + rank * part, fb, mask);
        if (!XRES) {
          tma_2d(dst + y_bytes, &tm_xhi, kk * kKS, qx, fb);
          if (PASSES == 3)
            tma_2d(dst + y_bytes + kSlice, &tm_xlo, kk * kKS, qx, fb);
        }
        if (last) bulk_copy(base + L.yy + st * kWYY, p.yyh + row, kWYY, fb);
        c += last;
        kk = last ? 0 : kk + 1;
        ph ^= st + 1 == NS;
        st = st + 1 == NS ? 0 : st + 1;
      }
    }
  } else {
    // ================= consumer warpgroups =================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    if (XRES) mbar_wait(xfull, 0);
    Cons cons;
    cons.run(p, tid & 127, q0, grp * 128 + wg * kHalf, grp, [&](Cons& c) {
      c.NS = NS;
      c.ksl = ksl;
      c.n_chunks = n_chunks;
      c.tile_bytes = kSlice;                  // 64 query rows × 128 B
      c.full0 = full0;
      c.empty0 = empty0;
      c.ncta = ncta;
      c.empty_r = map_cta(empty0, c.lane < ncta ? c.lane : 0);
      c.ring = base + L.ring;
      c.yy = base + L.yy;
      c.a_hi = base + L.a;
      c.a_lo = c.a_hi + ksl * kSlice;
      c.b_off = wg * kSlice;                  // rows 64·wg of the slice
      c.yy_off = wg * kYY;
    });
  }
  // no block leaves while another may still arrive on its barriers
  __syncwarp();
  cluster_sync();
}

// ---- host side ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime (the
// library links no -lcuda)
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) ==
            cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// [rows, d] row-major, boxes of 64 features × box_rows rows
bool make_map(CUtensorMap* m, const void* ptr, int rows, int d, bool q8,
              int box_rows = kHalf) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const int esize = q8 ? 1 : 2;
  cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                        static_cast<cuuint64_t>(rows)};
  cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * esize};
  cuuint32_t box[2] = {kKS, static_cast<cuuint32_t>(box_rows)};
  cuuint32_t estr[2] = {1, 1};
  return enc(m, q8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
             2, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             q8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the geometry: 128 queries a block where four ring stages still fit
// beside the resident query block, else 64; as many stages as fit, at
// most kMaxStages (a consumer holds at most kPre + 1, the rest let the
// producer run ahead)
bool pick_geo(int d, int passes, bool q8, int limit, Geo* g) {
  const int x_arrays = passes == 3 ? 2 : 1;
  const int y_arrays = (passes == 3 && !q8) ? 2 : 1;
  if (d % 128 || d > 512) return false;
  for (int QB = 128; QB >= 64; QB -= 64) {
    int NS = kMaxStages;
    while (NS > kPre + 1 &&
           Layout(QB, NS, d, x_arrays, y_arrays, q8).total + 1024 >
               static_cast<uint32_t>(limit))
      --NS;
    if (NS > kPre + 1) {
      g->QB = QB;
      g->NS = NS;
      return true;
    }
  }
  return false;
}

template <int PASSES, bool PAIR, bool Q8>
int launch(const Args& a, const void* y_hi, const void* y_lo,
           cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  Geo geo;
  if (!pick_geo(a.d, PASSES, Q8, limit, &geo))
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(a.yyh) % 16 ||
      reinterpret_cast<uintptr_t>(a.x) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap tm_hi, tm_lo;
  if (!make_map(&tm_hi, y_hi, a.M, a.d, Q8) ||
      !make_map(&tm_lo, y_lo, a.M, a.d, Q8))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int x_arrays = PASSES == 3 ? 2 : 1;
  constexpr int y_arrays = (PASSES == 3 && !Q8) ? 2 : 1;
  const size_t smem =
      Layout(geo.QB, geo.NS, a.d, x_arrays, y_arrays, Q8).total + 1024;
  auto kern = packed_sm90_kernel<PASSES, PAIR, Q8>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int n_groups = (a.M / a.T + a.g - 1) / a.g;
  dim3 grid((a.Q + geo.QB - 1) / geo.QB, n_groups, 2);
  kern<<<grid, kThreads, smem, stream>>>(tm_hi, tm_lo, a, geo);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q8>
int dispatch(const Args& a, const void* y_hi, const void* y_lo, int passes,
             int pair, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (passes == 3 && pair) return launch<3, true, Q8>(a, y_hi, y_lo, st);
  if (passes == 3) return launch<3, false, Q8>(a, y_hi, y_lo, st);
  if (pair) return launch<1, true, Q8>(a, y_hi, y_lo, st);
  return launch<1, false, Q8>(a, y_hi, y_lo, st);
}

// the d-chunked geometry: the block's 64 queries stay resident (read from
// L2 once a block, not once a chunk) where that leaves room for kPre + 2
// ring stages (passes=1 to d = 1024, passes=3 to d = 256), else they
// stream beside y; as many stages as fit, at most kMaxStages. Clusters of
// 2 consecutive query blocks share every y slice, halving y's L2 reads,
// where the blocks that only complete the last cluster add at most 1/8 of
// the query blocks; else one block a cluster. (Clusters of 4 read less
// but were slower at wide_knn's shape, every stage waiting on the slowest
// of four blocks: port_scripts/sweep_dchunk_geometry.py.)
bool pick_wide_geo(int Q, int d, int passes, int limit, WideGeo* g) {
  if (d % 128) return false;
  const int blocks = (Q + 63) / 64;
  for (int xres = 1; xres >= 0; --xres) {
    int NS = kMaxStages;
    while (NS > kPre + 1 && WideLayout(NS, d, passes, xres).total + 1024 >
                                static_cast<uint32_t>(limit))
      --NS;
    if (NS > kPre + 1) {
      g->NS = NS;
      g->xres = xres;
      g->ncta = blocks >= 2 && (blocks + 1) / 2 * 16 <= blocks * 9 ? 2 : 1;
      return true;
    }
  }
  return false;
}

int smem_limit() {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return limit;
}

// The d-chunked form at geometry geo. x_hi/x_lo are [Qp, d] bf16, Qp = Q
// rounded up to 64.
template <int PASSES, bool PAIR, bool XRES>
int launch_wide(const Args& a, const void* x_hi, const void* x_lo,
                const void* y_hi, const void* y_lo, const WideGeo& geo,
                cudaStream_t stream) {
  const int ncta = geo.ncta;
  const size_t smem = WideLayout(geo.NS, a.d, PASSES, XRES).total + 1024;
  if (reinterpret_cast<uintptr_t>(a.yyh) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int Qp = (a.Q + 63) / 64 * 64;
  CUtensorMap tm_yhi, tm_ylo, tm_xhi, tm_xlo;
  if (!make_map(&tm_yhi, y_hi, a.M, a.d, false, 128 / ncta) ||
      !make_map(&tm_ylo, y_lo, a.M, a.d, false, 128 / ncta) ||
      !make_map(&tm_xhi, x_hi, Qp, a.d, false) ||
      !make_map(&tm_xlo, x_lo, Qp, a.d, false))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = wide_sm90_kernel<PASSES, PAIR, XRES>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int n_groups = (a.M / a.T + a.g - 1) / a.g;
  // whole clusters: a query block past Qp loads the last real block's x
  // and stores nothing
  const int n_qb = ((Qp / 64) + ncta - 1) / ncta * ncta;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_qb, n_groups, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncta;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kern, tm_yhi, tm_ylo, tm_xhi, tm_xlo, a, geo);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_wide(const Args& a, const void* x_hi, const void* x_lo,
                  const void* y_hi, const void* y_lo, int passes, int pair,
                  void* stream) {
  WideGeo geo;
  if (!pick_wide_geo(a.Q, a.d, passes, smem_limit(), &geo))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define WIDE(P, PR, XR)                                                   \
  if (passes == P && (pair != 0) == PR && (geo.xres != 0) == XR)          \
    return launch_wide<P, PR, XR>(a, x_hi, x_lo, y_hi, y_lo, geo, st);
  WIDE(1, false, true) WIDE(1, false, false) WIDE(1, true, true)
  WIDE(1, true, false) WIDE(3, false, true) WIDE(3, false, false)
  WIDE(3, true, true) WIDE(3, true, false)
#undef WIDE
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* x, const void* scale, const void* yyh,
               const void* xxh, void* a1, void* a2, void* a3, int Q, int M,
               int d, int T, int g, int pbits) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.yyh = static_cast<const float*>(yyh);
  a.xxh = static_cast<const float*>(xxh);
  a.scale = static_cast<const float*>(scale);
  a.a1 = static_cast<float*>(a1);
  a.a2 = static_cast<float*>(a2);
  a.a3 = static_cast<float*>(a3);
  a.Q = Q; a.M = M; a.d = d; a.T = T; a.g = g; a.pbits = pbits;
  return a;
}

}  // namespace

// C entry points (loaded with ctypes). Return cudaGetLastError() after the
// launch (0 = success), or an error code when no geometry fits or an
// operand is not 16-byte aligned.
//
// K1. Shapes: x [Q, d] f32, y_hi/y_lo [M, d] bf16 (y_lo unused at
// passes=1), yyh [M] f32, xxh [Q] f32, a1/a2/a3 [Q, ceil(M/T/g)·128] f32;
// d % 128 == 0 and d <= 512, T % 128 == 0, M % T == 0.
extern "C" int fused_l2_group_topk_packed_launch(
    const void* x, const void* y_hi, const void* y_lo, const void* yyh,
    const void* xxh, void* a1, void* a2, void* a3, int Q, int M, int d,
    int T, int g, int passes, int pair, int pbits, void* stream) {
  const Args a = make_args(x, nullptr, yyh, xxh, a1, a2, a3, Q, M, d, T, g,
                           pbits);
  return dispatch<false>(a, y_hi, y_lo, passes, pair, stream);
}

// K2. Shapes: x [Q, d] f32, y_q [M, d] int8, scale [M/(g·T)] f32 (one per
// group), yyh [M] f32 (the dequantized rows' half-norms), xxh [Q] f32,
// a1/a2/a3 [Q, (M/T/g)·128] f32; d % 128 == 0 and d <= 512, T % 128 ==
// 0, M % (g·T) == 0.
extern "C" int fused_l2_group_topk_packed_q8_launch(
    const void* x, const void* y_q, const void* scale, const void* yyh,
    const void* xxh, void* a1, void* a2, void* a3, int Q, int M, int d,
    int T, int g, int passes, int pair, int pbits, void* stream) {
  const Args a = make_args(x, scale, yyh, xxh, a1, a2, a3, Q, M, d, T, g,
                           pbits);
  return dispatch<true>(a, y_q, y_q, passes, pair, stream);
}

// K1, d-chunked (wide features): x_hi/x_lo [ceil(Q/64)·64, d] bf16 (the
// split of x, zero rows past Q; x_lo unused at passes=1), y_hi/y_lo [M, d]
// bf16 (y_lo unused at passes=1), yyh [M] f32, xxh [Q] f32, a1/a2/a3 [Q,
// ceil(M/T/g)·128] f32; d % 128 == 0, T % 128 == 0, M % T == 0.
extern "C" int fused_l2_group_topk_packed_dchunk_launch(
    const void* x_hi, const void* x_lo, const void* y_hi, const void* y_lo,
    const void* yyh, const void* xxh, void* a1, void* a2, void* a3, int Q,
    int M, int d, int T, int g, int passes, int pair, int pbits,
    void* stream) {
  const Args a = make_args(nullptr, nullptr, yyh, xxh, a1, a2, a3, Q, M, d,
                           T, g, pbits);
  return dispatch_wide(a, x_hi, x_lo, y_hi, y_lo, passes, pair, stream);
}

// the geometry the launch above takes for Q queries of d features on the
// current device: out = (xres, stages, cluster)
extern "C" int fused_l2_group_topk_packed_dchunk_geometry(int Q, int d,
                                                          int passes,
                                                          int* out) {
  WideGeo geo;
  if (!pick_wide_geo(Q, d, passes, smem_limit(), &geo))
    return static_cast<int>(cudaErrorInvalidValue);
  out[0] = geo.xres;
  out[1] = geo.NS;
  out[2] = geo.ncta;
  return 0;
}
