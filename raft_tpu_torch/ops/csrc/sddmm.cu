// Sampled dense-dense product (K7) for Hopper (sm_90a), bound to Python
// through a plain C entry point.
//
// Replaces raft_tpu/ops/sddmm_pallas.py:sddmm_tiled over the TiledPairs
// layout of sparse/tiled.py.
//
// What it computes. For every entry i of a sparsity structure, the dot
// product
//     out[o] = Σ_k A[row(i), k] · Bt[cols[i], k],   o = dst ? dst[i] : i,
// of a row of A [m, d] and a row of Bt = Bᵀ [n, d], in the structure's own
// entry order. The structure comes in CSR form (indptr [m + 1], cols: the
// entry's row is found from indptr, no expanded row array is read) or as
// entry arrays (rows, cols, and an optional dst that lets a caller run the
// entries in another order, as chip_smoke.py times the layout's tile
// order, and still write each result to its entry).
//
// Precision. Each of 8 lanes sums its d/8 products in one f32 fma chain,
// then three shuffle additions: |Δ| ≤ (d + 2)·2⁻²⁴·Σ_k |a_k·b_k|. No
// reduced-precision product. The reference forms the dense block on the
// MXU at bf16×3 (≈ 2⁻¹⁶ relative).
//
// Bound on this card. Each entry needs 2·d flops and its two operand rows;
// read once, A and B are (m + n)·d·4 bytes, and the structure's least form
// (CSR) with the output nnz·8 + (m + 1)·4 bytes, so the work is bound by
// memory. What a gather design cannot avoid is one B row an entry:
// nnz·d·4 bytes from L2, from HBM where the column's row has left L2
// (port_scripts/probe_k7.py separates the two).
//
// What held the first design (8 lanes an entry reading both rows, one
// entry a step) back, by port_scripts/probe_k7.py at spectral_g22's
// structure on an H100 80GB HBM3 at 700 W (PERF.md): folding the columns
// into L2 took 12.0 → 9.9 ms, so HBM misses were a fifth of it; d = 16
// took 8.1 ms for a quarter of the bytes, so each entry's chain of
// dependent loads (index, then the rows) set the floor, and at d = 256
// L2 → SM bytes did.
//
// Design. Work items are runs of consecutive entries: a warp takes 256
// entries of the structure's order, split into four runs of 64, one per
// group of 8 lanes, so every item has the same work whatever the rows'
// degrees (a row of high degree spans several items) and a run crosses
// few row boundaries. A group steps 8 entries at a time: lane l loads
// entry i + l's column (and row) index, one coalesced load, the indices
// are passed round by shuffles, and the group issues the B rows of 8
// entries (fewer above d = 64) before it uses any, so each step waits on
// one round of latency instead of 8. It holds its current row of A in
// registers (d/8 floats a lane) and reloads it only where the row changes:
// A is read about once a row instead of once an entry, halving L2 → SM
// bytes. A reduce-scatter (7 shuffles for 8 entries) leaves each lane one
// entry's sum, so the 8 results are stored side by side. In CSR form a
// warp finds its first row by a 32-ary search of indptr; a group keeps 8
// row boundaries, one a lane, and each lane counts those at or below its
// entry (8 shuffles), loading the next 8 only when its entries pass them:
// no chain of dependent loads a step. The registers of A are a
// template instance per d ≤ 32, 64, 128, 256, 512 (float4s a lane NA = 1,
// 2, 4, 8, 16).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 8;                 // lanes per entry
constexpr int kRun = 64;                  // entries a group takes
constexpr int kWarpEntries = 4 * kRun;    // entries a warp takes

// c ? a : b as one selp on registers: written as a C++ select of two
// array elements, the compiler may select their address instead and move
// the array to local memory (ptxas then reports a stack frame and spills)
__device__ __forceinline__ float sel(bool c, float a, float b) {
  float r;
  asm("{\n .reg .pred p;\n setp.ne.b32 p, %3, 0;\n"
      " selp.f32 %0, %1, %2, p;\n}\n"
      : "=f"(r)
      : "f"(a), "f"(b), "r"(static_cast<int>(c)));
  return r;
}

template <int NA, bool kCsr>
__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const float4* __restrict__ A, const float4* __restrict__ Bt,
             const int* __restrict__ indptr, const int* __restrict__ rows,
             const int* __restrict__ cols, const int* __restrict__ dst,
             float* __restrict__ out, long long nnz, int m, int d4) {
  // B rows a lane holds at once: 8 entries' for d ≤ 64, fewer above
  // (≤ 8 float4s, so no instance spills)
  constexpr int kB = NA <= 2 ? kLanes : NA == 4 ? 2 : 1;
  constexpr unsigned kAll = 0xffffffffu;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (warp * kWarpEntries >= nnz) return;           // warp-uniform
  const int lane = threadIdx.x & 31, sub = lane % kLanes;
  const long long e0 = warp * kWarpEntries + (lane / kLanes) * kRun;
  const long long e1 = e0 + kRun < nnz ? e0 + kRun : nnz;
  // CSR: the warp's first row, by a 32-ary search of indptr (32 loads
  // side by side a round: 5 rounds at scale 22, not 22 dependent loads);
  // then each group keeps 8 row boundaries indptr[base + 1 + j], one a
  // lane, and reloads them only once its entries pass all 8
  int base = 0, bj = 0;
  if (kCsr) {
    const long long ew = warp * kWarpEntries;
    int lo = 0, hi = m;                 // indptr[lo] ≤ ew < indptr[hi]
    while (hi - lo > 1) {
      const int step = (hi - lo + 31) / 32;
      const int p = lo + step * (lane + 1);
      const bool le = p < hi && __ldg(&indptr[p]) <= ew;
      lo += step * __popc(__ballot_sync(kAll, le));
      hi = min(hi, lo + step);
    }
    base = lo;
    bj = __ldg(&indptr[min(base + 1 + sub, m)]);
  }
  float4 a[NA];
  int cur = -1;
  // every group runs kRun / 8 steps of 8 entries, lane `sub` loading the
  // index of entry i0 + sub, so whole warps reach the shuffles together
  for (long long i0 = e0; i0 < e0 + kRun; i0 += kLanes) {
    const long long i = i0 + sub;
    const bool real = i < e1;
    bool bad = false;               // CSR: an entry past indptr[m]
    int r = 0, c = 0;
    if (real) {
      if (!kCsr) r = __ldg(&rows[i]);
      c = __ldg(&cols[i]);
    }
    if (kCsr && e0 < e1) {
      // each lane counts the cached boundaries at or below its entry (a
      // lane past the run takes the run's last entry); a new set of 8
      // only where the group's last entry lies past all of them. Once the
      // set reaches indptr[m], an entry past it lies in no row (indptr[m]
      // < nnz, a malformed structure): it gets NaN and the loop ends
      const unsigned grp = 0xffu << (lane & ~(kLanes - 1));
      const long long ii = real ? i : e1 - 1;
      bool done = false;
      for (;;) {
        int cnt = 0;
#pragma unroll
        for (int j = 0; j < kLanes; ++j)
          cnt += __shfl_sync(grp, bj, j, kLanes) <= ii ? 1 : 0;
        if (!done && (cnt < kLanes || base + kLanes >= m)) {
          bad = cnt == kLanes;
          r = bad ? 0 : base + cnt;
          done = true;
        }
        if (__shfl_sync(grp, static_cast<int>(done), kLanes - 1, kLanes))
          break;
        base += kLanes;
        bj = __ldg(&indptr[min(base + 1 + sub, m)]);
      }
    }
    float acc[kLanes];
#pragma unroll
    for (int u0 = 0; u0 < kLanes; u0 += kB) {
      // the B rows of kB entries in flight before any is used
      float4 b[kB][NA];
      int ru[kB];
#pragma unroll
      for (int v = 0; v < kB; ++v) {
        const int cu = __shfl_sync(kAll, c, u0 + v, kLanes);
        ru[v] = __shfl_sync(kAll, r, u0 + v, kLanes);
        const float4* bp = Bt + static_cast<long long>(cu) * d4;
#pragma unroll
        for (int t = 0; t < NA; ++t)
          if (sub + kLanes * t < d4) b[v][t] = __ldg(&bp[sub + kLanes * t]);
      }
#pragma unroll
      for (int v = 0; v < kB; ++v) {
        if (ru[v] != cur) {                         // group-uniform
          cur = ru[v];
          const float4* ar = A + static_cast<long long>(cur) * d4;
#pragma unroll
          for (int t = 0; t < NA; ++t)
            if (sub + kLanes * t < d4) a[t] = __ldg(&ar[sub + kLanes * t]);
        }
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < NA; ++t) {
          if (sub + kLanes * t < d4) {
            s = fmaf(a[t].x, b[v][t].x, s);
            s = fmaf(a[t].y, b[v][t].y, s);
            s = fmaf(a[t].z, b[v][t].z, s);
            s = fmaf(a[t].w, b[v][t].w, s);
          }
        }
        acc[u0 + v] = s;
      }
    }
    // reduce-scatter over the group's 8 lanes: lane `sub` ends with the
    // sum of entry i0 + sub (a tree of three additions an entry)
    float h4[4], h2[2];
    const bool b4 = sub & 4, b2 = sub & 2, b1 = sub & 1;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      h4[q] = sel(b4, acc[q + 4], acc[q]) +
              __shfl_xor_sync(kAll, sel(b4, acc[q], acc[q + 4]), 4);
#pragma unroll
    for (int q = 0; q < 2; ++q)
      h2[q] = sel(b2, h4[q + 2], h4[q]) +
              __shfl_xor_sync(kAll, sel(b2, h4[q], h4[q + 2]), 2);
    const float tot = sel(b1, h2[1], h2[0]) +
                      __shfl_xor_sync(kAll, sel(b1, h2[0], h2[1]), 1);
    if (real)
      out[dst ? __ldg(&dst[i]) : i] = bad ? __int_as_float(0x7fc00000) : tot;
  }
}

template <bool kCsr>
int launch(const void* A, const void* Bt, const void* indptr,
           const void* rows, const void* cols, const void* dst, void* out,
           long long nnz, int m, int d4, void* stream) {
  if (nnz <= 0) return static_cast<int>(cudaGetLastError());
  const long long warps = (nnz + kWarpEntries - 1) / kWarpEntries;
  const int blocks = static_cast<int>((warps * 32 + kThreads - 1) / kThreads);
  const float4* a = static_cast<const float4*>(A);
  const float4* b = static_cast<const float4*>(Bt);
  const int* ip = static_cast<const int*>(indptr);
  const int* r = static_cast<const int*>(rows);
  const int* c = static_cast<const int*>(cols);
  const int* o = static_cast<const int*>(dst);
  float* y = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K7_LAUNCH(NA)                                                    \
  sddmm_kernel<NA, kCsr><<<blocks, kThreads, 0, st>>>(a, b, ip, r, c, o, \
                                                       y, nnz, m, d4)
  if (d4 <= 8) K7_LAUNCH(1);
  else if (d4 <= 16) K7_LAUNCH(2);
  else if (d4 <= 32) K7_LAUNCH(4);
  else if (d4 <= 64) K7_LAUNCH(8);
  else if (d4 <= 128) K7_LAUNCH(16);
  else return static_cast<int>(cudaErrorInvalidValue);
#undef K7_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (loaded with ctypes). A [m, 4·d4] and Bt [n, 4·d4]
// contiguous f32 (16-byte rows, d4 ≤ 128); out [nnz] f32, every entry
// written once. Launch nothing for nnz = 0. Return cudaGetLastError()
// after the launch (0 = success).
//
// Entry form: rows, cols and dst (may be null) [nnz] int32.
extern "C" int sddmm_launch(const void* A, const void* Bt, const void* rows,
                            const void* cols, const void* dst, void* out,
                            long long nnz, int d4, void* stream) {
  return launch<false>(A, Bt, nullptr, rows, cols, dst, out, nnz, 0, d4,
                       stream);
}

// CSR form: indptr [m + 1] and cols [nnz] int32 (m ≥ 1), results in
// entry order; an entry at or past indptr[m] (a structure holding fewer
// entries than cols) gets NaN.
extern "C" int sddmm_csr_launch(const void* A, const void* Bt,
                                const void* indptr, const void* cols,
                                void* out, long long nnz, int m, int d4,
                                void* stream) {
  return launch<true>(A, Bt, indptr, nullptr, cols, nullptr, out, nnz, m,
                      d4, stream);
}
