// Fused expanded-L2 contraction + packed group top-2 / 3rd-min fold (K1,
// and its int8-database form K2) for Hopper (sm_90a), bound to Python
// through plain C entry points.
//
// Replaces raft_tpu/ops/fused_l2_topk_pallas.py:fused_l2_group_topk_packed
// (and its database-major forms _packed_db / _packed_dbuf, which compute
// the same outputs in another TPU grid order) — K1 — and
// fused_l2_group_topk_packed_db_q8 / _dbuf_q8 — K2.
//
// What it computes. For every query q and database row n (rows padded to
// whole tiles of T; padded rows carry the finite 2^125 sentinel in yyh):
//     c[q, n] = (yyh[n] - x[q]·y[n]) + xxh[q]            (= d2/2 for l2)
// with x·y a bf16 contraction accumulated in f32: passes=1 is
// bf16(x)·y_hi; passes=3 adds bf16(x)·y_lo + bf16(x - bf16(x))·y_hi.
// K2 streams int8 codes q8 instead, one symmetric scale per group G:
//     c[q, n] = (yyh[n] - scale[G]·(bf16(x)·q8[n] (+ bf16(x - bf16(x))·q8[n]
//               at passes=3))) + xxh[q]
// The codes (|q| <= 127) are exact in bf16, so there is no y_lo; the
// scale multiplies the whole f32 d-sum once (never per element), and yyh
// holds the dequantized rows' half-norms, so c is d2(x, ŷ)/2.
// A bucket is (lane = n % 128, group of g consecutive tiles); group G owns
// output columns [G·128, (G+1)·128). Row n sits in chunk
// (n - G·g·T) / 128 of its group, and its code is that chunk index
// (= tile_offset·T/128 + chunk). The code replaces the low `pbits`
// mantissa bits of c, so one f32 carries value and id, and the fold is the
// reference's 5-op min/max network (_merge_chunk_top2_packed) run in chunk
// order: a1 ≤ a2 are the bucket's two smallest packed values, a3 the
// third smallest. With `pair` (knn_fused sets it at passes=1) chunks 2i
// and 2i+1 are first min-combined: the loser goes straight into a3 and
// the winner carries code 2i (+1 when it came from the odd chunk). K2's
// outputs have K1's layout bit for bit, so the decode and the
// certificate downstream are the same.
//
// Precision contract. Both factors of every product are bf16 rounded to
// nearest (__float2bfloat16_rn), so each product is exact in f32, and the
// tensor cores accumulate in f32 — the arithmetic the certificate's error
// bounds (knn_fused._err_bound_coeff / _err_bound_coeff_p1) are written
// for. TF32 would keep only 10 mantissa bits of each f32 factor and is
// not used anywhere here. K2 does not use the int8 tensor cores
// (mma.sync m16n8k32.s8): they need the query quantized too, which is
// another score function, one the certificate's error bounds
// (_err_bound_coeff*, widened by the quantization bound Eq of the rows
// only) do not cover. Its codes are widened to bf16 in shared memory and
// run through K1's bf16 mma.sync.
//
// Bound on this card. At the main path's shape (2048 queries × ~1M rows ×
// 128) K1 does 2·Q·M·d = 5.3e11 bf16 FLOP at passes=1 (×3 at passes=3;
// K2 ×2) against 0.26 GB (×2) of y (K2: 0.13 GB) and 0.1 GB of outputs:
// both are bound by the tensor cores, not by HBM.
//
// Design (simple first): one thread block owns (64 queries, one whole
// group), so every output slot is written exactly once — no atomics, no
// second pass, deterministic. The query block is converted to bf16 hi(/lo)
// once and stays in shared memory. The group's rows stream through a
// 2-stage cp.async ring in [128 rows × 128 features] slices; 8 warps
// (4 along queries × 2 along the 128 lanes) run mma.sync m16n8k16 bf16
// with f32 accumulators. A thread's accumulator positions are the same
// (query, lane) pairs for every chunk, so the fold state lives in
// registers and the distance tile never leaves the SM. Blocks of one
// group run side by side (query block is the fast grid index), so the
// group's rows are read from HBM about once and re-read from L2. K2's
// ring holds int8 slices (half of bf16's bytes); each slice is widened
// into one bf16 slice in shared memory (exact) before ldmatrix, and the
// group's scale is read once per block. wgmma, TMA and a persistent
// schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;     // bucket lane classes = rows per chunk
constexpr int kBQ = 64;         // queries per block
constexpr int kThreads = 256;   // 8 warps: 4 (queries) × 2 (lanes)
constexpr int kKS = 128;        // features per staged slice
constexpr int kYStride = kKS + 8;   // bf16 row stride of a y slice (+16 B
                                    // so ldmatrix rows hit distinct banks)
constexpr int kQStride = kKS + 16;  // byte row stride of an int8 slice
constexpr int kQStage = kLanes * kQStride;   // bytes of one int8 stage
constexpr float kPackPad = 4.2535295865117308e37f;   // 2^125

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1, uint32_t& r2,
                                        uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float pack(float c, uint32_t keep, int code) {
  return __int_as_float((__float_as_int(c) & keep) | code);
}

// _merge_chunk_top2_packed: with a1 ≤ a2, the round-1 loser either stays
// ≥ a2 or becomes the new 2nd; the round-2 loser is the 3rd smallest.
__device__ __forceinline__ void merge(float cp, float& a1, float& a2,
                                      float& a3) {
  float b1 = fmaxf(a1, cp);
  a1 = fminf(a1, cp);
  float b2 = fmaxf(a2, b1);
  a2 = fminf(a2, b1);
  a3 = fminf(a3, b2);
}

template <int PASSES, bool PAIR, bool Q8>
__global__ void __launch_bounds__(kThreads, 1)
fused_l2_group_topk_packed_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ y_hi,
    const __nv_bfloat16* __restrict__ y_lo, const int8_t* __restrict__ y_q,
    const float* __restrict__ scale, const float* __restrict__ yyh,
    const float* __restrict__ xxh, float* __restrict__ a1_out,
    float* __restrict__ a2_out, float* __restrict__ a3_out, int Q, int M,
    int d, int T, int g, int pbits, int n_stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int xstride = d + 8;
  __nv_bfloat16* xs_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs_lo = xs_hi + kBQ * xstride;            // PASSES == 3
  __nv_bfloat16* ys = xs_hi + (PASSES == 3 ? 2 : 1) * kBQ * xstride;
  // bf16 ring (K1: y_hi, and y_lo at passes=3) or, for K2, one widened
  // bf16 slice followed by the int8 ring
  const int y_arrays = (PASSES == 3 && !Q8) ? 2 : 1;
  const int stage_elems = y_arrays * kLanes * kYStride;
  int8_t* qring = reinterpret_cast<int8_t*>(ys + kLanes * kYStride);
  float* yyh_s = Q8 ? reinterpret_cast<float*>(qring + n_stages * kQStage)
                    : reinterpret_cast<float*>(ys + n_stages * stage_elems);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wq = warp >> 1;       // 16-query slab of this warp
  const int wn = warp & 1;        // 64-lane half of this warp
  const int q0 = blockIdx.x * kBQ;
  const int grp = blockIdx.y;
  const int n_ch = T / kLanes;
  const int n_tiles = M / T;
  const int tiles = min(g, n_tiles - grp * g);
  const int n_chunks = tiles * n_ch;
  const int ksl = d / kKS;
  const int steps = n_chunks * ksl;
  const long row0 = static_cast<long>(grp) * g * T;
  const float gscale = Q8 ? scale[grp] : 1.f;

  // ---- the query block, rounded to bf16 hi (and lo) once ----
  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, k = i - r * d;
    const float v = (q0 + r < Q) ? x[static_cast<long>(q0 + r) * d + k]
                                 : 0.f;
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    xs_hi[r * xstride + k] = hi;
    if (PASSES == 3)
      xs_lo[r * xstride + k] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }

  // ---- stage loader: step s = (chunk s / ksl, feature slice s % ksl) ----
  auto load_step = [&](int s) {
    const int c = s / ksl, kk = s - c * ksl;
    const long rbase = row0 + static_cast<long>(c) * kLanes;
    if constexpr (Q8) {
      // 128 rows × 128 int8 = 1024 16-byte pieces
      int8_t* dst = qring + (s % n_stages) * kQStage;
      for (int p = tid; p < kLanes * (kKS / 16); p += kThreads) {
        const int r = p >> 3, seg = p & 7;
        cp_async16(smem_u32(dst + r * kQStride + seg * 16),
                   y_q + (rbase + r) * d + kk * kKS + seg * 16);
      }
    } else {
      __nv_bfloat16* dst = ys + (s % n_stages) * stage_elems;
      // 128 rows × 128 bf16 = 2048 16-byte pieces per array
      for (int p = tid; p < kLanes * (kKS / 8); p += kThreads) {
        const int r = p >> 4, seg = p & 15;
        const long goff = (rbase + r) * d + kk * kKS + seg * 8;
        cp_async16(smem_u32(dst + r * kYStride + seg * 8), y_hi + goff);
        if (PASSES == 3)
          cp_async16(
              smem_u32(dst + kLanes * kYStride + r * kYStride + seg * 8),
              y_lo + goff);
      }
    }
    if (kk == ksl - 1 && tid < kLanes / 4)
      cp_async16(smem_u32(yyh_s + (s % n_stages) * kLanes + tid * 4),
                 yyh + rbase + tid * 4);
    cp_async_commit();
  };

  const uint32_t keep = ~((1u << pbits) - 1u);
  float xh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int q = q0 + wq * 16 + gid + 8 * h;
    xh[h] = (q < Q) ? xxh[q] : 0.f;
  }

  float acc[8][4], a1[8][4], a2[8][4], a3[8][4];
  float c_even[8][4];   // PAIR: the even chunk's values (dead otherwise)
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[t][i] = 0.f;
      a1[t][i] = a2[t][i] = a3[t][i] = kPackPad;
    }

  load_step(0);
  for (int s = 0; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (n_stages == 2 && more) {
      load_step(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if constexpr (Q8) {
      // widen the int8 slice into the bf16 slice (exact: |q| <= 127)
      const int8_t* qs = qring + (s % n_stages) * kQStage;
      for (int p = tid; p < kLanes * (kKS / 16); p += kThreads) {
        const int r = p >> 3, seg = p & 7;
        const int4 raw =
            *reinterpret_cast<const int4*>(qs + r * kQStride + seg * 16);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
        __align__(16) __nv_bfloat162 w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          w[j] = __floats2bfloat162_rn(static_cast<float>(b[2 * j]),
                                       static_cast<float>(b[2 * j + 1]));
        int4* out = reinterpret_cast<int4*>(ys + r * kYStride + seg * 16);
        out[0] = reinterpret_cast<const int4*>(w)[0];
        out[1] = reinterpret_cast<const int4*>(w)[1];
      }
      __syncthreads();
    }

    const int c = s / ksl, kk = s - c * ksl;
    const __nv_bfloat16* ys_hi = Q8 ? ys : ys + (s % n_stages) * stage_elems;
    const __nv_bfloat16* ys_lo = ys_hi + kLanes * kYStride;
#pragma unroll
    for (int k16 = 0; k16 < kKS / 16; ++k16) {
      // A: 16 queries × 16 features of this warp's slab
      const int arow = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int acol = kk * kKS + k16 * 16 + (lane >> 4) * 8;
      uint32_t ahi[4], alo[4];
      ldsm_x4(smem_u32(xs_hi + arow * xstride + acol), ahi[0], ahi[1],
              ahi[2], ahi[3]);
      if (PASSES == 3)
        ldsm_x4(smem_u32(xs_lo + arow * xstride + acol), alo[0], alo[1],
                alo[2], alo[3]);
#pragma unroll
      for (int tp = 0; tp < 4; ++tp) {
        // B: two 8-row n-tiles × 16 features (rows are y rows = lanes)
        const int brow = wn * 64 + tp * 16 + (lane & 7) + (lane >> 4) * 8;
        const int bcol = k16 * 16 + ((lane >> 3) & 1) * 8;
        uint32_t b[4];
        ldsm_x4(smem_u32(ys_hi + brow * kYStride + bcol), b[0], b[1], b[2],
                b[3]);
        mma_bf16(acc[2 * tp], ahi, b[0], b[1]);
        mma_bf16(acc[2 * tp + 1], ahi, b[2], b[3]);
        if (PASSES == 3) {
          mma_bf16(acc[2 * tp], alo, b[0], b[1]);
          mma_bf16(acc[2 * tp + 1], alo, b[2], b[3]);
          if (!Q8) {
            ldsm_x4(smem_u32(ys_lo + brow * kYStride + bcol), b[0], b[1],
                    b[2], b[3]);
            mma_bf16(acc[2 * tp], ahi, b[0], b[1]);
            mma_bf16(acc[2 * tp + 1], ahi, b[2], b[3]);
          }
        }
      }
    }

    if (kk == ksl - 1) {
      // ---- fold chunk c of the group into the bucket registers ----
      const float* yy = yyh_s + (s % n_stages) * kLanes;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int ln = wn * 64 + t * 8 + tig * 2;
        const float y0 = yy[ln], y1 = yy[ln + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // K2: the group scale multiplies the finished d-sum, rounded
          // on its own (no fused multiply-add), as the twin computes it
          const float dot = Q8 ? __fmul_rn(acc[t][i], gscale) : acc[t][i];
          const float cv = __fadd_rn(((i & 1) ? y1 : y0) - dot, xh[i >> 1]);
          acc[t][i] = 0.f;
          if (PAIR) {
            if ((c & 1) == 0) {
              c_even[t][i] = cv;
            } else {
              const float c0 = c_even[t][i];
              const float mn = fminf(c0, cv);
              a3[t][i] = fminf(a3[t][i], fmaxf(c0, cv));
              const int code = (mn == cv) ? c : c - 1;
              merge(pack(mn, keep, code), a1[t][i], a2[t][i], a3[t][i]);
            }
          } else {
            merge(pack(cv, keep, c), a1[t][i], a2[t][i], a3[t][i]);
          }
        }
      }
    }
    __syncthreads();
    if (n_stages == 1 && more) load_step(s + 1);
  }

  // ---- every bucket slot of this (query block, group) is written once ----
  const int S = gridDim.y * kLanes;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = grp * kLanes + wn * 64 + t * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wq * 16 + gid + 8 * h;
      if (q < Q) {
        const long o = static_cast<long>(q) * S + col;
        *reinterpret_cast<float2*>(a1_out + o) =
            make_float2(a1[t][2 * h], a1[t][2 * h + 1]);
        *reinterpret_cast<float2*>(a2_out + o) =
            make_float2(a2[t][2 * h], a2[t][2 * h + 1]);
        *reinterpret_cast<float2*>(a3_out + o) =
            make_float2(a3[t][2 * h], a3[t][2 * h + 1]);
      }
    }
  }
}

size_t smem_bytes(int d, int passes, int n_stages, bool q8) {
  const int x_arrays = passes == 3 ? 2 : 1;
  const size_t xs = static_cast<size_t>(x_arrays) * kBQ * (d + 8) * 2;
  if (q8)
    return xs + static_cast<size_t>(kLanes) * kYStride * 2 +
           static_cast<size_t>(n_stages) * (kQStage + kLanes * 4);
  return xs + static_cast<size_t>(n_stages) *
                  (x_arrays * kLanes * kYStride * 2 + kLanes * 4);
}

template <int PASSES, bool PAIR, bool Q8>
int launch(const float* x, const __nv_bfloat16* y_hi,
           const __nv_bfloat16* y_lo, const int8_t* y_q, const float* scale,
           const float* yyh, const float* xxh, float* a1, float* a2,
           float* a3, int Q, int M, int d, int T, int g, int pbits,
           cudaStream_t stream) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int n_stages = 2;
  if (smem_bytes(d, PASSES, 2, Q8) > static_cast<size_t>(limit))
    n_stages = 1;
  const size_t smem = smem_bytes(d, PASSES, n_stages, Q8);
  auto kern = fused_l2_group_topk_packed_kernel<PASSES, PAIR, Q8>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int n_groups = (M / T + g - 1) / g;
  dim3 grid((Q + kBQ - 1) / kBQ, n_groups);
  kern<<<grid, kThreads, smem, stream>>>(x, y_hi, y_lo, y_q, scale, yyh, xxh,
                                         a1, a2, a3, Q, M, d, T, g, pbits,
                                         n_stages);
  return static_cast<int>(cudaGetLastError());
}

template <bool Q8>
int dispatch(const void* x, const void* y_hi, const void* y_lo,
             const void* y_q, const void* scale, const void* yyh,
             const void* xxh, void* a1, void* a2, void* a3, int Q, int M,
             int d, int T, int g, int passes, int pair, int pbits,
             void* stream) {
  const float* xf = static_cast<const float*>(x);
  const __nv_bfloat16* yh = static_cast<const __nv_bfloat16*>(y_hi);
  const __nv_bfloat16* yl = static_cast<const __nv_bfloat16*>(y_lo);
  const int8_t* yq = static_cast<const int8_t*>(y_q);
  const float* sc = static_cast<const float*>(scale);
  const float* yy = static_cast<const float*>(yyh);
  const float* xx = static_cast<const float*>(xxh);
  float* o1 = static_cast<float*>(a1);
  float* o2 = static_cast<float*>(a2);
  float* o3 = static_cast<float*>(a3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (passes == 3 && pair)
    return launch<3, true, Q8>(xf, yh, yl, yq, sc, yy, xx, o1, o2, o3, Q, M,
                               d, T, g, pbits, st);
  if (passes == 3)
    return launch<3, false, Q8>(xf, yh, yl, yq, sc, yy, xx, o1, o2, o3, Q,
                                M, d, T, g, pbits, st);
  if (pair)
    return launch<1, true, Q8>(xf, yh, yl, yq, sc, yy, xx, o1, o2, o3, Q, M,
                               d, T, g, pbits, st);
  return launch<1, false, Q8>(xf, yh, yl, yq, sc, yy, xx, o1, o2, o3, Q, M,
                              d, T, g, pbits, st);
}

}  // namespace

// C entry points (loaded with ctypes). Return cudaGetLastError() after the
// launch (0 = success).
//
// K1. Shapes: x [Q, d] f32, y_hi/y_lo [M, d] bf16 (y_lo unused at
// passes=1), yyh [M] f32, xxh [Q] f32, a1/a2/a3 [Q, ceil(M/T/g)·128] f32;
// d % 128 == 0, T % 128 == 0, M % T == 0.
extern "C" int fused_l2_group_topk_packed_launch(
    const void* x, const void* y_hi, const void* y_lo, const void* yyh,
    const void* xxh, void* a1, void* a2, void* a3, int Q, int M, int d,
    int T, int g, int passes, int pair, int pbits, void* stream) {
  return dispatch<false>(x, y_hi, y_lo, nullptr, nullptr, yyh, xxh, a1, a2,
                         a3, Q, M, d, T, g, passes, pair, pbits, stream);
}

// K2. Shapes: x [Q, d] f32, y_q [M, d] int8, scale [M/(g·T)] f32 (one per
// group), yyh [M] f32 (the dequantized rows' half-norms), xxh [Q] f32,
// a1/a2/a3 [Q, (M/T/g)·128] f32; d % 128 == 0, T % 128 == 0,
// M % (g·T) == 0.
extern "C" int fused_l2_group_topk_packed_q8_launch(
    const void* x, const void* y_q, const void* scale, const void* yyh,
    const void* xxh, void* a1, void* a2, void* a3, int Q, int M, int d,
    int T, int g, int passes, int pair, int pbits, void* stream) {
  return dispatch<true>(x, nullptr, nullptr, y_q, scale, yyh, xxh, a1, a2,
                        a3, Q, M, d, T, g, passes, pair, pbits, stream);
}
