// Blocked histogram (K9) for Hopper (sm_90a), bound to Python through a
// plain C entry point.
//
// Replaces raft_tpu/ops/histogram_pallas.py:histogram_blocked (:47,
// pallas_call at :61).
//
// What it computes. counts[b, c] = |{r : bins[r, c] = b}| for bins
// [n, batch] int32 row-major and b in [0, n_bins); entries outside that
// range are ignored. The output [n_bins, batch] int32 must be zeroed by
// the caller. Integer atomics are exact, so the result is the same in
// every run and equal to any other way of counting.
//
// Bound on this card. Each entry is read once (n·batch·4 bytes at 3.35
// TB/s) and costs a few integer instructions: the bytes bound it.
//
// Design (the reference's smem strategy, cpp/include/raft/stats/detail/
// histogram.cuh). The TPU kept the [n_bins, batch] output block resident
// in VMEM across a sequential row grid and folded one-hot compares into
// it. Here a grid of (row blocks × column slabs) runs in parallel: each
// block zeroes n_bins × slab int32 counters in shared memory (a slab is
// as many columns as fit in 48 KB, so any batch is served with n_bins ≤
// 12288), counts its rows with shared atomics, and adds each nonzero
// counter to the output with one global atomicAdd. Where the counters
// are few (batch 1: one column of n_bins), every warp of a block gets a
// copy of its own, so that a skewed distribution contends within a warp
// only. A thread keeps 8 loads in flight; a warp reads consecutive
// entries of the [rows × slab] sub-block, a contiguous range when the
// slab is the whole row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;
constexpr int kSmemInts = 12288;          // 48 KB of counters a block

__global__ void __launch_bounds__(kThreads)
histogram_kernel(const int* __restrict__ bins, int* __restrict__ out,
                 long long n, int batch, int n_bins, int slab, int slabs,
                 int copies, long long rows_per_block) {
  extern __shared__ int counts[];         // [copies][n_bins][slab]
  const int per_copy = n_bins * slab;
  int* mine = counts + (threadIdx.x / 32 % copies) * per_copy;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = r0 + rows_per_block < n ? r0 + rows_per_block : n;

  // a grid row walks slabs blockIdx.y, + gridDim.y, ... (gridDim.y is
  // at most 65535, so a batch of more slabs is still served)
  for (int s = blockIdx.y; s < slabs; s += gridDim.y) {
    const int c0 = s * slab;
    const int width = batch - c0 < slab ? batch - c0 : slab;
    for (int i = threadIdx.x; i < copies * per_copy; i += kThreads)
      counts[i] = 0;
    __syncthreads();

    // the launcher keeps a block's sub-block under 2^31 entries
    const unsigned total = r0 < r1 ? static_cast<unsigned>((r1 - r0) * width)
                                   : 0u;
    const unsigned w = static_cast<unsigned>(width);
    const int* base = bins + r0 * batch + c0;
    for (unsigned e0 = threadIdx.x; e0 < total; e0 += kThreads * kUnroll) {
      int v[kUnroll], c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned e = e0 + u * kThreads;
        v[u] = -1;
        c[u] = 0;
        if (e < total) {
          const unsigned r = e / w;
          c[u] = static_cast<int>(e - r * w);
          v[u] = __ldg(&base[static_cast<long long>(r) * batch + c[u]]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (static_cast<unsigned>(v[u]) < static_cast<unsigned>(n_bins))
          atomicAdd(&mine[v[u] * slab + c[u]], 1);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n_bins * width; i += kThreads) {
      const int b = i / width, c = i - b * width;
      int t = 0;
      for (int k = 0; k < copies; ++k)
        t += counts[k * per_copy + b * slab + c];
      if (t) atomicAdd(&out[static_cast<long long>(b) * batch + c0 + c], t);
    }
    __syncthreads();                      // before the next slab's zeroing
  }
}

}  // namespace

// C entry point (loaded with ctypes). bins [n, batch] contiguous int32;
// out [n_bins, batch] int32, zeroed by the caller. n, batch ≥ 1 and
// 1 ≤ n_bins ≤ 12288 (the wrapper answers the empty cases and refuses
// larger n_bins). Returns cudaGetLastError() after the launch (0 =
// success).
extern "C" int histogram_launch(const void* bins, void* out, long long n,
                                int batch, int n_bins, void* stream) {
  if (n_bins < 1 || n_bins > kSmemInts)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int slab_max = kSmemInts / n_bins;
  const int slab = batch < slab_max ? batch : slab_max;
  const int fit = kSmemInts / (n_bins * slab);
  const int copies = fit < kWarps ? fit : kWarps;
  const long long slabs = (batch + slab - 1) / slab;
  // about four blocks an SM, each with at least 8192 entries, and none
  // with 2^30 or more (its counter index is 32-bit)
  const long long entries = n * slab;
  long long row_blocks = (entries + 8191) / 8192;
  const long long cap = (4LL * sms + slabs - 1) / slabs;
  if (row_blocks > cap) row_blocks = cap;
  const long long floor_blocks = (entries >> 30) + 1;
  if (row_blocks < floor_blocks) row_blocks = floor_blocks;
  const long long rows_per_block = (n + row_blocks - 1) / row_blocks;
  row_blocks = (n + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(slabs < 65535 ? slabs : 65535));
  const size_t smem = sizeof(int) * copies * n_bins * slab;
  histogram_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bins), static_cast<int*>(out), n, batch,
      n_bins, slab, static_cast<int>(slabs), copies, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}
