// List-major IVF fine scan (K4) for Hopper (sm_90a), f32 and int8 slabs,
// bound to Python through a plain C entry point.
//
// Replaces raft_tpu/ops/fine_scan_pallas.py:fine_scan_list_major and
// fine_scan_list_major_q8 (the _list_kernel_body contract).
//
// What it computes. Schedule entry j = (start, lsize, off, lid): the list's
// rows are window columns [off, off+lsize) of the window start..start+Wk.
// Every query whose probe table holds lid is scored against each of them,
//     d2 = xx[q] + (yy − 2·x·y)                 (f32 slab)
//     d2 = xx[q] + (s²·Σyq² − 2·s·Σx·yq)        (int8 slab, list scale s)
// and each score folds into the query's 128 slots, slot = column % 128,
// as the top-2 (value, global slab row) and a running 3rd-min, with strict
// < (the earlier row wins a tie). Untouched slots read (+inf, −1).
//
// Precision. Every sum is an f32 fma chain over the d features (no tensor
// cores, no TF32): |Δ(x·y)| ≤ d·2⁻²⁴·‖x‖‖y‖ and |Δ‖y‖²| ≤ d·2⁻²⁴·‖y‖², so
// |Δd2| ≤ (2d + 4)·2⁻²⁴·(‖x‖ + ‖y‖)², inside the caller's certificate
// envelope (2⁻¹³ + d·2⁻²²)·(‖x‖ + max‖y‖)² (ann/ivf_flat.py). int8 codes
// are exact in f32 and, for d ≤ 1024, so is Σyq² (≤ 127²·d < 2²⁴); the
// scale multiplies the finished sums, never a widened copy of the slab.
//
// Bound on this card. Each probed list is read once per batch and every
// (query, probed row) pair costs 2·d flops: at the IVF path's shape
// (2048 queries, 1M × 128 rows in 1024 lists, P = 32..128) that is
// 16–65 GFLOP against 0.1–0.5 GB, so it is bound by arithmetic. This first
// kernel runs it on the f32 cores (67 TFLOP/s), not the tensor cores the
// bound is counted at; a bf16×3 mma.sync form is later work.
//
// Design (simple first). The probe table is inverted on the device before
// the launch (ops/fine_scan.py:_members): for entry j, the member table
// lists the (query, probe column) pairs that probe it, so no block scores
// a query that does not probe the list (a query-tile walk would score
// ~20× more pairs on clustered data) and each list is read from HBM once
// per batch. A block owns (entry j, every kSplit-th batch of 32 members):
// it stages the members' query rows in shared memory, then streams the
// list's live 128-row chunks in 32-feature slices through shared memory;
// 8 warps × 32 lanes each hold 4 queries × 4 columns, so a thread's
// accumulators are the same (query, slot) pairs in every chunk and the
// fold state lives in registers. Each (query, probe column) pair gets its
// own 128-slot partial pool in global memory; a second kernel merges a
// query's partials in ascending entry order, which is the reference's
// fold order, so the two agree even at exact ties. The top-2 + 3rd-min
// merge is associative; no atomics, deterministic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;     // pool slots = window columns per chunk
constexpr int kBQ = 32;         // member queries per pass of a block
constexpr int kXS = kBQ + 4;    // smem stride of a staged feature (16-B rows)
constexpr int kKS = 32;         // features per staged slab slice
constexpr int kYS = kLanes + 1; // smem stride of a staged slice feature
constexpr int kThreads = 256;   // 8 warps: warp w holds queries 4w..4w+3
constexpr int kSplit = 4;       // blocks sharing one entry's member batches

__device__ __forceinline__ void fold(float c, int ci, float& a1, int& i1,
                                     float& a2, int& i2, float& a3) {
  const bool lt1 = c < a1, lt2 = c < a2, lt3 = c < a3;
  a3 = lt2 ? a2 : (lt3 ? c : a3);
  a2 = lt1 ? a1 : (lt2 ? c : a2);
  i2 = lt1 ? i1 : (lt2 ? ci : i2);
  a1 = lt1 ? c : a1;
  i1 = lt1 ? ci : i1;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int8_t v) {
  return static_cast<float>(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fine_scan_kernel(const int* __restrict__ sched,
                 const float* __restrict__ scale_l,
                 const float* __restrict__ x, const float* __restrict__ xx,
                 const T* __restrict__ slab, const int* __restrict__ seg,
                 const int* __restrict__ member, float* __restrict__ pa1,
                 int* __restrict__ pi1, float* __restrict__ pa2,
                 int* __restrict__ pi2, float* __restrict__ pa3, int Pp,
                 int d, int R, int Lp, int Wk) {
  extern __shared__ __align__(16) float smem[];
  const int dp = (d + kKS - 1) / kKS * kKS;
  float* xs = smem;                       // [dp][kXS]: member queries
  float* ys = smem + dp * kXS;            // [kKS][kYS]: one slab slice

  const int j = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int start = sched[j], lsize = sched[Lp + j], off = sched[2 * Lp + j];
  // live window columns: the list's rows, inside the window and the slab
  const int c_lo = max(max(off, 0), -start);
  const int c_hi = min(min(off + lsize, Wk), R - start);
  const int ch_lo = c_lo / kLanes;
  const int ch_hi = c_hi > c_lo ? (c_hi + kLanes - 1) / kLanes : ch_lo;
  const float sc = scale_l != nullptr ? scale_l[j] : 1.f;
  const int m0 = seg[j], m1 = seg[j + 1];

  for (int b = m0 + blockIdx.y * kBQ; b < m1; b += gridDim.y * kBQ) {
    const int nm = min(kBQ, m1 - b);
    for (int i = tid; i < kBQ * dp; i += kThreads) {
      const int qi = i / dp, k = i - qi * dp;
      float v = 0.f;
      if (qi < nm && k < d)
        v = x[static_cast<long>(member[b + qi] / Pp) * d + k];
      xs[k * kXS + qi] = v;
    }
    float xq[4];
    float a1[4][4], a2[4][4], a3[4][4];
    int i1[4][4], i2[4][4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int qi = warp * 4 + h;
      xq[h] = qi < nm ? xx[member[b + qi] / Pp] : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        a1[h][c] = a2[h][c] = a3[h][c] = INFINITY;
        i1[h][c] = i2[h][c] = -1;
      }
    }
    __syncthreads();

    for (int ch = ch_lo; ch < ch_hi; ++ch) {
      const long row0 = static_cast<long>(start) + ch * kLanes;
      float acc[4][4], yy[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        yy[c] = 0.f;
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[h][c] = 0.f;
      }
      for (int k0 = 0; k0 < dp; k0 += kKS) {
        // 128 rows × 32 features, read along features (coalesced) and
        // stored transposed; rows outside the slab read as zero
        for (int p = tid; p < kLanes * kKS; p += kThreads) {
          const int r = p / kKS, kk = p - r * kKS;
          const long row = row0 + r;
          float v = 0.f;
          if (row >= 0 && row < R && k0 + kk < d)
            v = to_f32(slab[row * d + k0 + kk]);
          ys[kk * kYS + r] = v;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kKS; ++kk) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xs + (k0 + kk) * kXS + warp * 4);
          const float xh[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float yv = ys[kk * kYS + lane + 32 * c];
            yy[c] = fmaf(yv, yv, yy[c]);
#pragma unroll
            for (int h = 0; h < 4; ++h) acc[h][c] = fmaf(xh[h], yv, acc[h][c]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = ch * kLanes + lane + 32 * c;
        const bool live = col >= c_lo && col < c_hi;
        const int row = start + col;
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float r = scale_l != nullptr
                              ? (sc * sc) * yy[c] - 2.f * sc * acc[h][c]
                              : yy[c] - 2.f * acc[h][c];
          const float d2 = live ? xq[h] + r : INFINITY;
          fold(d2, row, a1[h][c], i1[h][c], a2[h][c], i2[h][c], a3[h][c]);
        }
      }
    }

    // this entry's partial pool of each member (query, probe column)
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int qi = warp * 4 + h;
      if (qi < nm) {
        const long o = static_cast<long>(member[b + qi]) * kLanes;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long s = o + lane + 32 * c;
          pa1[s] = a1[h][c];
          pi1[s] = i1[h][c];
          pa2[s] = a2[h][c];
          pi2[s] = i2[h][c];
          pa3[s] = a3[h][c];
        }
      }
    }
    __syncthreads();     // xs is staged again by the next batch
  }
}

// One thread per (query, slot): the query's partial pools folded in
// ascending schedule-entry order (js holds the entries, −1 = none).
__global__ void merge_kernel(const int* __restrict__ js,
                             const float* __restrict__ pa1,
                             const int* __restrict__ pi1,
                             const float* __restrict__ pa2,
                             const int* __restrict__ pi2,
                             const float* __restrict__ pa3,
                             float* __restrict__ a1o, int* __restrict__ i1o,
                             float* __restrict__ a2o, int* __restrict__ i2o,
                             float* __restrict__ a3o, int Pp) {
  const int q = blockIdx.x, slot = threadIdx.x;
  float a1 = INFINITY, a2 = INFINITY, a3 = INFINITY;
  int i1 = -1, i2 = -1;
  for (int p = 0; p < Pp; ++p) {
    const long part = static_cast<long>(q) * Pp + p;
    if (js[part] < 0) continue;
    const long o = part * kLanes + slot;
    fold(pa1[o], pi1[o], a1, i1, a2, i2, a3);
    fold(pa2[o], pi2[o], a1, i1, a2, i2, a3);
    a3 = fminf(a3, pa3[o]);
  }
  const long o = static_cast<long>(q) * kLanes + slot;
  a1o[o] = a1;
  i1o[o] = i1;
  a2o[o] = a2;
  i2o[o] = i2;
  a3o[o] = a3;
}

template <typename T>
int launch(const int* sched, const float* scale_l, const float* x,
           const float* xx, const T* slab, const int* seg, const int* member,
           const int* js, float* pa1, int* pi1, float* pa2, int* pi2,
           float* pa3, float* a1, int* i1, float* a2, int* i2, float* a3,
           int nqp, int Pp, int d, int R, int Lp, int Wk,
           cudaStream_t stream) {
  const int dp = (d + kKS - 1) / kKS * kKS;
  const size_t smem = static_cast<size_t>(dp * kXS + kKS * kYS) * 4;
  auto kern = fine_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (Lp > 0) {
    kern<<<dim3(Lp, kSplit), kThreads, smem, stream>>>(
        sched, scale_l, x, xx, slab, seg, member, pa1, pi1, pa2, pi2, pa3,
        Pp, d, R, Lp, Wk);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (nqp > 0)
    merge_kernel<<<nqp, kLanes, 0, stream>>>(js, pa1, pi1, pa2, pi2, pa3, a1,
                                             i1, a2, i2, a3, Pp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). sched [4, Lp] i32; scale_l [Lp] f32
// (int8 slab) or null (f32 slab); x [nqp, d] f32; xx [nqp] f32; slab
// [R, d] f32 or int8; seg [Lp+1], member [nqp·Pp] and js [nqp, Pp] i32 from
// the inverted probe table; five partial pools [nqp·Pp, 128] and five
// outputs [nqp, 128] (f32, i32, f32, i32, f32); d ≤ 1024. Returns
// cudaGetLastError() after the launches (0 = success).
extern "C" int fine_scan_list_major_launch(
    const void* sched, const void* scale_l, const void* x, const void* xx,
    const void* slab, const void* seg, const void* member, const void* js,
    void* pa1, void* pi1, void* pa2, void* pi2, void* pa3, void* a1,
    void* i1, void* a2, void* i2, void* a3, int nqp, int Pp, int d, int R,
    int Lp, int Wk, int q8, void* stream) {
  const int* sc = static_cast<const int*>(sched);
  const float* sl = static_cast<const float*>(scale_l);
  const float* xf = static_cast<const float*>(x);
  const float* xxf = static_cast<const float*>(xx);
  const int* sg = static_cast<const int*>(seg);
  const int* mb = static_cast<const int*>(member);
  const int* jj = static_cast<const int*>(js);
  float* p1 = static_cast<float*>(pa1);
  int* q1 = static_cast<int*>(pi1);
  float* p2 = static_cast<float*>(pa2);
  int* q2 = static_cast<int*>(pi2);
  float* p3 = static_cast<float*>(pa3);
  float* o1 = static_cast<float*>(a1);
  int* n1 = static_cast<int*>(i1);
  float* o2 = static_cast<float*>(a2);
  int* n2 = static_cast<int*>(i2);
  float* o3 = static_cast<float*>(a3);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q8)
    return launch<int8_t>(sc, sl, xf, xxf, static_cast<const int8_t*>(slab),
                          sg, mb, jj, p1, q1, p2, q2, p3, o1, n1, o2, n2, o3,
                          nqp, Pp, d, R, Lp, Wk, st);
  return launch<float>(sc, nullptr, xf, xxf, static_cast<const float*>(slab),
                       sg, mb, jj, p1, q1, p2, q2, p3, o1, n1, o2, n2, o3,
                       nqp, Pp, d, R, Lp, Wk, st);
}
