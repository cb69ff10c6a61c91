// K1's unpacked forms for Hopper (sm_90a): the fused expanded-L2
// contraction and the unpacked group fold, one mma.sync kernel templated
// on the form, bound to Python through plain C entry points. (K1's packed
// forms, resident and d-chunked, its int8 form K2 and its slot forms are
// the wgmma kernels of fused_l2_packed_sm90.cu.)
//
// Replaces raft_tpu/ops/fused_l2_topk_pallas.py's unpacked forms
// fused_l2_group_topk (:1230) and fused_l2_group_topk_dchunk (:1254).
//
// What it computes. For every query q and database row n (rows padded to
// whole tiles of T) the half-score yyh[n] − x[q]·y[n], with x·y a bf16
// contraction accumulated in f32: passes=1 is bf16(x)·y_hi; passes=3 adds
// bf16(x)·y_lo + bf16(x - bf16(x))·y_hi. A bucket is (lane = n % 128,
// group of g consecutive tiles); group G owns output columns [G·128,
// (G+1)·128).
//
// NaN. Every min here is PTX min.NaN, as the reference's jnp.minimum and
// the twin's torch.minimum: fminf would drop a NaN entry and could
// certify a top-k without it.
//
// The unpacked form (knn_fused for g·T/128 beyond the 2^13-code
// envelope) keeps per bucket (a1, id1, a2, id2, a3) with global row ids
// tile·T + chunk·128 + lane, merged by _merge_chunk_top2's compare/select
// order with strict < (on a tie the earlier id stays), over the plain
// half-score yyh − x·y (no query norm: the caller recovers 2·a + xx).
// Padded rows carry yyh = +inf, which never wins a strict <, so a group
// of pads keeps a = +inf, id = −1. Its geometries hold few groups (one
// group at T = 512, g = 4096 on 1M rows: 16–32 blocks for 132 SMs), so
// the wrapper may cut each group's chunks into S contiguous segments,
// one block each (gridDim.z); a segment block writes a summary
// (seg_insert) that a second kernel (seg_merge_kernel) merges into the
// outputs, bit for bit the one-block fold at every S.
//
// Precision contract. Both factors of every product are bf16 rounded to
// nearest (__float2bfloat16_rn), so each product is exact in f32, and the
// tensor cores accumulate in f32 — the arithmetic the certificate's error
// bounds (knn_fused._err_bound_coeff / _err_bound_coeff_p1) are written
// for. TF32 would keep only 10 mantissa bits of each f32 factor and is
// not used anywhere here.
//
// Bound on this card. At the main path's shape (2048 queries × ~1M rows ×
// 128) K1 does 2·Q·M·d = 5.3e11 bf16 FLOP at passes=1 (×3 at passes=3)
// against 0.26 GB (×2) of y and 0.1 GB of outputs: bound by the tensor
// cores, not by HBM.
//
// Design (simple first): one thread block owns (64 queries, one whole
// group, or one segment of a split group), so every output slot (or
// partial) is written exactly once — no atomics, deterministic. The
// query block is converted to bf16 hi(/lo) once and stays in shared
// memory. The group's rows stream through a
// 2-stage cp.async ring in [128 rows × 128 features] slices; 8 warps
// (4 along queries × 2 along the 128 lanes) run mma.sync m16n8k16 bf16
// with f32 accumulators. A thread's accumulator positions are the same
// (query, lane) pairs for every chunk, so the fold state lives in
// registers and the distance tile never leaves the SM. Blocks of one
// group run side by side (query block is the fast grid index), so the
// group's rows are read from HBM about once and re-read from L2. wgmma,
// TMA and a persistent schedule (fused_l2_packed_sm90.cu's mainloop) are
// later work for these forms.
//
// Wide features (the _dchunk form, d > 512). The resident query block
// is 64·(d + 8)·2 bytes per bf16 array: at d = 960 and passes=3 that is
// 247,808 B, more than a block's 232,448. The accumulator of a (64
// queries × 128 rows) chunk already lives in registers across the
// k-slice loop, so the wide forms keep that loop and only change where
// x's k-slices come from: they stream through the cp.async ring beside
// y's (the GPU counterpart of the TPU's d-chunked VMEM accumulator, with
// no scratch). x arrives as a bf16 hi/lo copy made once a call (Q·d·4
// bytes, L2-resident), rounded exactly as the resident path rounds it.
// A stage then holds 128 y rows and 64 x rows of each array: 104,960 B
// at passes=3, two stages in 209,920 B.

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

// what a block folds its score tiles into
enum Fold : int {
  kIds = 1,       // group top-2 + 3rd-min with row ids (unpacked)
  kSeg = 4,       // a segment of a split group: its (e1, e2, i3, r) summary
};

// minima and maxima that propagate NaN, as torch.minimum/maximum do
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// _merge_chunk_top2: the unpacked compare/select order (strict <)
__device__ __forceinline__ void merge_ids(float c, int ci, float& a1,
                                          int& id1, float& a2, int& id2,
                                          float& a3) {
  const bool lt1 = c < a1;
  const float b1 = lt1 ? a1 : c;
  const int bid1 = lt1 ? id1 : ci;
  a1 = lt1 ? c : a1;
  id1 = lt1 ? ci : id1;
  const bool lt2 = b1 < a2;
  const float b2 = lt2 ? a2 : b1;
  a2 = lt2 ? b1 : a2;
  id2 = lt2 ? bid1 : id2;
  a3 = min_nan(a3, b2);
}

// the unpacked form's split groups: a segment's summary, entries in
// arrival (id) order: (e1, i1), (e2, i2) its two (value, arrival)-smallest
// (strict <), i3 the third's id where its value equals e2 (else −1), r the
// NaN-propagating min of all its other entries (the third's included)
__device__ __forceinline__ void seg_insert(float c, int ci, float& e1,
                                           int& i1, float& e2, int& i2,
                                           int& i3, float& r) {
  const bool lt1 = c < e1;
  const bool lt2 = c < e2;
  r = min_nan(r, lt2 ? e2 : c);
  i3 = lt1 ? (e1 == e2 ? i2 : -1)
           : lt2 ? -1 : (c == e2 && i3 < 0) ? ci : i3;
  i2 = lt1 ? i1 : lt2 ? ci : i2;
  e2 = lt1 ? e1 : lt2 ? c : e2;
  i1 = lt1 ? ci : i1;
  e1 = lt1 ? c : e1;
}

struct Args {
  const float* x;                     // [Q, d] f32 (resident forms)
  const __nv_bfloat16* x_hi;          // [Qp, d] bf16 (streamed forms;
  const __nv_bfloat16* x_lo;          //  Qp = Q rounded up to kBQ)
  const __nv_bfloat16* y_hi;
  const __nv_bfloat16* y_lo;
  const float* yyh;
  float* a1;
  float* a2;
  float* a3;
  int* id1;
  int* id2;
  int* id3;                           // a split group's segments
  int Q, M, d, T, g;
};

// One kernel for every form: PASSES 1/3; XS (x streamed through the
// ring: the _dchunk form); FOLD (see Fold).
template <int PASSES, bool XS, int FOLD>
__global__ void __launch_bounds__(kThreads, 1)
fused_l2_group_topk_kernel(const Args p, int n_stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d;
  const int xstride = d + 8;
  constexpr int x_arrays = PASSES == 3 ? 2 : 1;
  // bf16 ring: y_hi, and y_lo at passes=3, then for XS the x slices
  constexpr int y_arrays = x_arrays;
  constexpr int y_elems = y_arrays * kLanes * kYStride;
  constexpr int stage_elems = y_elems + (XS ? x_arrays * kBQ * kYStride : 0);
  __nv_bfloat16* xs_hi = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs_lo = xs_hi + kBQ * xstride;            // PASSES == 3
  __nv_bfloat16* ys = XS ? xs_hi : xs_hi + x_arrays * kBQ * xstride;
  float* yyh_s = reinterpret_cast<float*>(ys + n_stages * stage_elems);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wq = warp >> 1;       // 16-query slab of this warp
  const int wn = warp & 1;        // 64-lane half of this warp
  const int q0 = blockIdx.x * kBQ;
  const int grp = blockIdx.y;
  const int Q = p.Q, T = p.T, g = p.g;
  const int n_ch = T / kLanes;
  const int n_tiles = p.M / T;
  const int tiles = min(g, n_tiles - grp * g);
  const int n_chunks = tiles * n_ch;
  const int ksl = d / kKS;
  // a split group's block takes a contiguous segment of its group's
  // chunks (blockIdx.z of gridDim.z; the other forms: the whole group)
  const int seg_c0 =
      FOLD == kSeg ? static_cast<int>(static_cast<long>(n_chunks) *
                                      blockIdx.z / gridDim.z)
                   : 0;
  const int seg_c1 =
      FOLD == kSeg ? static_cast<int>(static_cast<long>(n_chunks) *
                                      (blockIdx.z + 1) / gridDim.z)
                   : n_chunks;
  const int s_begin = seg_c0 * ksl;
  const int steps = seg_c1 * ksl;
  const long row0 = static_cast<long>(grp) * g * T;

  if constexpr (!XS) {
    // ---- the query block, rounded to bf16 hi (and lo) once ----
    for (int i = tid; i < kBQ * d; i += kThreads) {
      const int r = i / d, k = i - r * d;
      const float v =
          (q0 + r < Q) ? p.x[static_cast<long>(q0 + r) * d + k] : 0.f;
      const __nv_bfloat16 hi = __float2bfloat16_rn(v);
      xs_hi[r * xstride + k] = hi;
      if (PASSES == 3)
        xs_lo[r * xstride + k] =
            __float2bfloat16_rn(v - __bfloat162float(hi));
    }
  }

  // ---- stage loader: step s = (chunk s / ksl, feature slice s % ksl) ----
  auto load_step = [&](int s) {
    const int c = s / ksl, kk = s - c * ksl;
    const long rbase = row0 + static_cast<long>(c) * kLanes;
    __nv_bfloat16* dst = ys + (s % n_stages) * stage_elems;
    // 128 rows × 128 bf16 = 2048 16-byte pieces per array
    for (int i = tid; i < kLanes * (kKS / 8); i += kThreads) {
      const int r = i >> 4, seg = i & 15;
      const long goff = (rbase + r) * d + kk * kKS + seg * 8;
      cp_async16(smem_u32(dst + r * kYStride + seg * 8), p.y_hi + goff);
      if (PASSES == 3)
        cp_async16(
            smem_u32(dst + kLanes * kYStride + r * kYStride + seg * 8),
            p.y_lo + goff);
    }
    if constexpr (XS) {
      // 64 query rows × 128 bf16 = 1024 pieces per array (x_hi/x_lo
      // are padded to whole query blocks)
      __nv_bfloat16* xdst = dst + y_elems;
      for (int i = tid; i < kBQ * (kKS / 8); i += kThreads) {
        const int r = i >> 4, seg = i & 15;
        const long goff =
            static_cast<long>(q0 + r) * d + kk * kKS + seg * 8;
        cp_async16(smem_u32(xdst + r * kYStride + seg * 8),
                   p.x_hi + goff);
        if (PASSES == 3)
          cp_async16(
              smem_u32(xdst + kBQ * kYStride + r * kYStride + seg * 8),
              p.x_lo + goff);
      }
    }
    if (kk == ksl - 1 && tid < kLanes / 4)
      cp_async16(smem_u32(yyh_s + (s % n_stages) * kLanes + tid * 4),
                 p.yyh + rbase + tid * 4);
    cp_async_commit();
  };

  const float init = __int_as_float(0x7f800000);
  float acc[8][4], a1[8][4], a2[8][4], a3[8][4];
  int id1[8][4], id2[8][4];
  int id3[8][4];              // kSeg only
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[t][i] = 0.f;
      a1[t][i] = a2[t][i] = a3[t][i] = init;
      id1[t][i] = id2[t][i] = id3[t][i] = -1;
    }

  if (s_begin < steps) load_step(s_begin);   // an empty segment loads none
  for (int s = s_begin; s < steps; ++s) {
    const bool more = s + 1 < steps;
    if (n_stages == 2 && more) {
      load_step(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const int c = s / ksl, kk = s - c * ksl;
    const __nv_bfloat16* ys_hi = ys + (s % n_stages) * stage_elems;
    const __nv_bfloat16* ys_lo = ys_hi + kLanes * kYStride;
    // A operand: the resident block (column kk·128 of the row), or this
    // step's streamed slice
    const __nv_bfloat16* xa_hi = XS ? ys_hi + y_elems : xs_hi;
    const __nv_bfloat16* xa_lo = XS ? xa_hi + kBQ * kYStride : xs_lo;
    const int astride = XS ? kYStride : xstride;
    const int acol0 = XS ? 0 : kk * kKS;
#pragma unroll
    for (int k16 = 0; k16 < kKS / 16; ++k16) {
      // A: 16 queries × 16 features of this warp's slab
      const int arow = wq * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int acol = acol0 + k16 * 16 + (lane >> 4) * 8;
      uint32_t ahi[4], alo[4];
      ldsm_x4(smem_u32(xa_hi + arow * astride + acol), ahi[0], ahi[1],
              ahi[2], ahi[3]);
      if (PASSES == 3)
        ldsm_x4(smem_u32(xa_lo + arow * astride + acol), alo[0], alo[1],
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
          ldsm_x4(smem_u32(ys_lo + brow * kYStride + bcol), b[0], b[1],
                  b[2], b[3]);
          mma_bf16(acc[2 * tp], ahi, b[0], b[1]);
          mma_bf16(acc[2 * tp + 1], ahi, b[2], b[3]);
        }
      }
    }

    if (kk == ksl - 1) {
      // ---- fold chunk c of the group into the bucket registers ----
      // (one branch a chunk, outside the unrolled loops)
      const float* yy = yyh_s + (s % n_stages) * kLanes;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int ln = wn * 64 + t * 8 + tig * 2;
        const float y0 = yy[ln], y1 = yy[ln + 1];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // the plain half-score and its global row id
          const float cv = ((i & 1) ? y1 : y0) - acc[t][i];
          acc[t][i] = 0.f;
          const int ci = static_cast<int>(row0) + c * kLanes + ln + (i & 1);
          if constexpr (FOLD == kSeg)
            seg_insert(cv, ci, a1[t][i], id1[t][i], a2[t][i], id2[t][i],
                       id3[t][i], a3[t][i]);
          else
            merge_ids(cv, ci, a1[t][i], id1[t][i], a2[t][i], id2[t][i],
                      a3[t][i]);
        }
      }
    }
    __syncthreads();
    if (n_stages == 1 && more) load_step(s + 1);
  }

  // ---- every bucket slot of this (query block, group) is written once
  // (a split group: into its segment's partial [gridDim.z, Q, S]) ----
  const int S = gridDim.y * kLanes;
  const long seg_off =
      FOLD == kSeg ? static_cast<long>(blockIdx.z) * Q * S : 0;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int col = grp * kLanes + wn * 64 + t * 8 + tig * 2;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wq * 16 + gid + 8 * h;
      if (q < Q) {
        const long o = seg_off + static_cast<long>(q) * S + col;
        *reinterpret_cast<float2*>(p.a1 + o) =
            make_float2(a1[t][2 * h], a1[t][2 * h + 1]);
        *reinterpret_cast<float2*>(p.a2 + o) =
            make_float2(a2[t][2 * h], a2[t][2 * h + 1]);
        *reinterpret_cast<float2*>(p.a3 + o) =
            make_float2(a3[t][2 * h], a3[t][2 * h + 1]);
        *reinterpret_cast<int2*>(p.id1 + o) =
            make_int2(id1[t][2 * h], id1[t][2 * h + 1]);
        *reinterpret_cast<int2*>(p.id2 + o) =
            make_int2(id2[t][2 * h], id2[t][2 * h + 1]);
        if constexpr (FOLD == kSeg)
          *reinterpret_cast<int2*>(p.id3 + o) =
              make_int2(id3[t][2 * h], id3[t][2 * h + 1]);
      }
    }
  }
}

// the unpacked form's split groups: merge the segments' summaries [segs,
// n] (n = Q·S; see seg_insert) into the sequential fold's state. That
// fold's ids depend only on the first two arrivals of the smallest value
// and of the second smallest and on their order, and each such entry is
// one of a segment's candidates (e1, i1), (e2, i2) and, where i3 ≥ 0,
// (e2, i3). So merge_ids over each segment's candidates in id (arrival)
// order, segment after segment, gives the fold's (a1, id1, a2, id2) bit
// for bit, and a3 is that run's a3 NaN-min every segment's r.
__global__ void seg_merge_kernel(const float* __restrict__ pe1,
                                 const int* __restrict__ pi1,
                                 const float* __restrict__ pe2,
                                 const int* __restrict__ pi2,
                                 const int* __restrict__ pi3,
                                 const float* __restrict__ pr,
                                 float* __restrict__ a1, int* __restrict__ id1,
                                 float* __restrict__ a2, int* __restrict__ id2,
                                 float* __restrict__ a3, int segs, long n) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float inf = __int_as_float(0x7f800000);
  float b1 = inf, b2 = inf, b3 = inf;
  int j1 = -1, j2 = -1;
  for (int sg = 0; sg < segs; ++sg) {
    const long o = sg * n + i;
    const int t3 = pi3[o];
    float v[3] = {pe1[o], pe2[o], inf};
    int id[3] = {pi1[o], pi2[o], 0x7fffffff};
    if (t3 >= 0) {
      v[2] = v[1];
      id[2] = t3;
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {          // sort the three by id
      const int p = k == 1 ? 1 : 0;
      if (id[p + 1] < id[p]) {
        const float tv = v[p];
        v[p] = v[p + 1];
        v[p + 1] = tv;
        const int ti = id[p];
        id[p] = id[p + 1];
        id[p + 1] = ti;
      }
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) merge_ids(v[k], id[k], b1, j1, b2, j2, b3);
    b3 = min_nan(b3, pr[o]);
  }
  a1[i] = b1;
  id1[i] = j1;
  a2[i] = b2;
  id2[i] = j2;
  a3[i] = b3;
}

size_t smem_bytes(int d, int passes, int n_stages, bool xs) {
  const size_t x_arrays = passes == 3 ? 2 : 1;
  const size_t xs_bytes = xs ? 0 : x_arrays * kBQ * (d + 8) * 2;
  const size_t stage_rows =
      x_arrays * kLanes + (xs ? x_arrays * kBQ : 0);   // y_arrays = x_arrays
  return xs_bytes +
         static_cast<size_t>(n_stages) * (stage_rows * kYStride * 2 +
                                          kLanes * 4);
}

template <int PASSES, bool XS, int FOLD>
int launch(const Args& a, cudaStream_t stream, int segs = 1) {
  int dev = 0, limit = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  int n_stages = 2;
  if (smem_bytes(a.d, PASSES, 2, XS) > static_cast<size_t>(limit))
    n_stages = 1;
  const size_t smem = smem_bytes(a.d, PASSES, n_stages, XS);
  auto kern = fused_l2_group_topk_kernel<PASSES, XS, FOLD>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  const int n_groups = (a.M / a.T + a.g - 1) / a.g;
  dim3 grid((a.Q + kBQ - 1) / kBQ, n_groups, segs);
  kern<<<grid, kThreads, smem, stream>>>(a, n_stages);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const void* x, const void* x_hi, const void* x_lo,
               const void* y_hi, const void* y_lo, const void* yyh, void* a1,
               void* a2, void* a3, void* id1, void* id2, int Q, int M, int d,
               int T, int g) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.x_hi = static_cast<const __nv_bfloat16*>(x_hi);
  a.x_lo = static_cast<const __nv_bfloat16*>(x_lo);
  a.y_hi = static_cast<const __nv_bfloat16*>(y_hi);
  a.y_lo = static_cast<const __nv_bfloat16*>(y_lo);
  a.yyh = static_cast<const float*>(yyh);
  a.a1 = static_cast<float*>(a1);
  a.a2 = static_cast<float*>(a2);
  a.a3 = static_cast<float*>(a3);
  a.id1 = static_cast<int*>(id1);
  a.id2 = static_cast<int*>(id2);
  a.id3 = nullptr;
  a.Q = Q; a.M = M; a.d = d; a.T = T; a.g = g;
  return a;
}

}  // namespace

// C entry points (loaded with ctypes). Return cudaGetLastError() after the
// launch (0 = success).
//
// K1, unpacked: a1/a2/a3 [Q, ceil(M/T/g)·128] f32, id1/id2 the same shape
// int32; yyh carries +inf on padded rows. xs = 0 reads x [Q, d] f32
// (resident, the single-shot form); xs = 1 reads x_hi/x_lo [ceil(Q/64)·64,
// d] bf16 (the split of x, zero rows past Q). segs = 1: one block a (query block, group)
// folds the group and writes the outputs. segs > 1: each group's chunks
// are cut into segs contiguous segments, one block each, which write
// their summaries into part (6 arrays [segs, Q, ceil(M/T/g)·128]: e1, i1,
// e2, i2, i3, r; ids int32), and a second kernel merges them into the
// outputs.
extern "C" int fused_l2_group_topk_launch(
    const void* x, const void* x_hi, const void* x_lo, const void* y_hi,
    const void* y_lo, const void* yyh, void* a1, void* id1, void* a2,
    void* id2, void* a3, void* part, int Q, int M, int d, int T, int g,
    int passes, int xs, int segs, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (segs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (segs == 1) {
    const Args a = make_args(x, x_hi, x_lo, y_hi, y_lo, yyh, a1, a2, a3,
                             id1, id2, Q, M, d, T, g);
    if (xs)
      return passes == 3 ? launch<3, true, kIds>(a, st)
                         : launch<1, true, kIds>(a, st);
    return passes == 3 ? launch<3, false, kIds>(a, st)
                       : launch<1, false, kIds>(a, st);
  }
  const long n = static_cast<long>(Q) * ((M / T + g - 1) / g) * kLanes;
  float* pf = static_cast<float*>(part);
  int* pi = static_cast<int*>(part);
  Args a = make_args(x, x_hi, x_lo, y_hi, y_lo, yyh, pf, pf + 2 * segs * n,
                     pf + 5 * segs * n, pi + segs * n, pi + 3 * segs * n, Q,
                     M, d, T, g);
  a.id3 = pi + 4 * segs * n;
  int err;
  if (xs)
    err = passes == 3 ? launch<3, true, kSeg>(a, st, segs)
                      : launch<1, true, kSeg>(a, st, segs);
  else
    err = passes == 3 ? launch<3, false, kSeg>(a, st, segs)
                      : launch<1, false, kSeg>(a, st, segs);
  if (err) return err;
  seg_merge_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
      pf, pi + segs * n, pf + 2 * segs * n, pi + 3 * segs * n,
      pi + 4 * segs * n, pf + 5 * segs * n, static_cast<float*>(a1),
      static_cast<int*>(id1), static_cast<float*>(a2),
      static_cast<int*>(id2), static_cast<float*>(a3), segs, n);
  return static_cast<int>(cudaGetLastError());
}
