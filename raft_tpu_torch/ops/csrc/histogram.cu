// Blocked histogram (K9) for Hopper (sm_90a), bound to Python through a
// plain C entry point.
//
// Replaces raft_tpu/ops/histogram_pallas.py:histogram_blocked (:47,
// pallas_call at :61).
//
// What it computes. counts[b, c] = |{r : bins[r, c] = b}| for bins
// [n, batch] int32 row-major and b in [0, n_bins); entries outside that
// range are ignored. The entry zeroes the output [n_bins, batch] int32 on
// the stream before the kernel runs. Integer counts are exact, so the
// result is the same in every run and equal to any other way of counting.
//
// Bound on this card. Each entry is read once (n·batch·4 bytes at 3.35
// TB/s) and costs a few integer instructions: the bytes bound it.
//
// Two forms, chosen by the counters a block keeps, n_bins × batch
// (histogram_form; ops.histogram.k9_form is the same rule in Python):
//
// - Few counters (at most kLaneCounters: value_histogram's 64 bins of one
//   column, the stats path's 16 labels), the small-counter form
//   (histogram_lanes_kernel). With one copy a warp, the 32 lanes of a warp
//   whose values fall in one bin serialise on its shared-memory atomic;
//   here every lane keeps counters of its own, laid out [counter][lane],
//   so lane l always hits bank l and increments with a plain load and
//   store, no atomic. The rows are whole ([rows × batch] is contiguous),
//   read as 16-byte loads, four in flight a thread. At the block's end each
//   warp sums its lanes' counters (lane l reads lane (j + l) % 32's j-th
//   time round, no bank conflict), and one thread a counter sums the warps
//   and adds the total to the output with one global atomicAdd a block.
//
// - Otherwise the reference's smem strategy (cpp/include/raft/stats/
//   detail/histogram.cuh; histogram_kernel). The TPU kept the [n_bins,
//   batch] output block resident in VMEM across a sequential row grid and
//   folded one-hot compares into it. Here a grid of (row blocks × column
//   slabs) runs in parallel: each block zeroes n_bins × slab int32
//   counters in shared memory (a slab is as many columns as fit in 48 KB,
//   so any batch is served with n_bins ≤ 12288), counts its rows with
//   shared atomics, and adds each nonzero counter to the output with one
//   global atomicAdd. Where a slab's counters leave room, every warp of a
//   block gets a copy of its own, so that a skewed distribution contends
//   within a warp only. A thread keeps 8 loads in flight; a warp reads
//   consecutive entries of the [rows × slab] sub-block, a contiguous range
//   when the slab is the whole row.
//
// The caller passes the card's SM count (read once a device), so a launch
// makes no device query.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;
constexpr int kSmemInts = 12288;          // 48 KB of counters a block
// the small-counter form: counters a lane keeps (8 warps × 32 lanes × 64 ×
// 4 B = 64 KB a block, three blocks an SM), 16-byte loads in flight a
// thread, and the least entries a block takes
constexpr int kLaneCounters = 64;
constexpr int kVec = 4;
constexpr int kBlockEntries = 4096;

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

// one entry (flat index e, column e % batch) into this lane's counters
template <bool ONE_COL>
__device__ __forceinline__ void count_one(int* lane_ctr, int v, long long e,
                                          int batch, int n_bins) {
  if (static_cast<unsigned>(v) < static_cast<unsigned>(n_bins)) {
    const int c = ONE_COL ? 0 : static_cast<int>(e % batch);
    lane_ctr[(v * batch + c) * 32] += 1;
  }
}

// The small-counter form over the flat entries [0, total) of bins (whole
// rows: entry e is in column e % batch). Entries [0, head) precede the
// first 16-byte boundary; from head on, block b takes the 4-entry units
// [b·per_block, (b+1)·per_block) of the n4 whole units, and block 0 the
// < 4 entries past them too. ONE_COL: batch == 1.
template <bool ONE_COL>
__global__ void __launch_bounds__(kThreads)
histogram_lanes_kernel(const int* __restrict__ bins, int* __restrict__ out,
                       long long total, int batch, int n_bins, int head,
                       long long per_block) {
  extern __shared__ int lanes[];          // [warp][counter][lane]
  __shared__ int sums[kWarps][kLaneCounters];
  const int C = n_bins * batch;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* warp_ctr = lanes + warp * C * 32;
  int* lane_ctr = warp_ctr + lane;
  for (int i = tid; i < kWarps * C * 8; i += kThreads)
    reinterpret_cast<int4*>(lanes)[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const long long n4 = (total - head) / kVec;
  const long long u0 = static_cast<long long>(blockIdx.x) * per_block;
  const long long u1 = u0 + per_block < n4 ? u0 + per_block : n4;
  const int4* body = reinterpret_cast<const int4*>(bins + head);
  for (long long u = u0 + tid; u < u1; u += kThreads * kVec) {
    int4 w[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      w[k] = u + k * kThreads < u1 ? __ldg(&body[u + k * kThreads])
                                   : make_int4(-1, -1, -1, -1);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const long long e = head + (u + k * kThreads) * kVec;
      count_one<ONE_COL>(lane_ctr, w[k].x, e, batch, n_bins);
      count_one<ONE_COL>(lane_ctr, w[k].y, e + 1, batch, n_bins);
      count_one<ONE_COL>(lane_ctr, w[k].z, e + 2, batch, n_bins);
      count_one<ONE_COL>(lane_ctr, w[k].w, e + 3, batch, n_bins);
    }
  }
  if (blockIdx.x == 0 && tid < kVec) {
    // the entries before the first 16-byte boundary and past the last one
    if (tid < head) count_one<ONE_COL>(lane_ctr, bins[tid], tid, batch,
                                       n_bins);
    const long long e = head + n4 * kVec + tid;
    if (e < total) count_one<ONE_COL>(lane_ctr, bins[e], e, batch, n_bins);
  }
  __syncthreads();

  // each warp sums its lanes' counters: round j, lane l reads counter k's
  // slot of lane (j + l) % 32, bank (j + l) % 32
  for (int k = lane; k < C; k += 32) {
    int t = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) t += warp_ctr[k * 32 + ((j + lane) & 31)];
    sums[warp][k] = t;
  }
  __syncthreads();
  if (tid < C) {
    int t = 0;
#pragma unroll
    for (int w8 = 0; w8 < kWarps; ++w8) t += sums[w8][tid];
    if (t) atomicAdd(&out[tid], t);       // [n_bins, batch] flat: v·batch + c
  }
}

// 1 where the small-counter form takes (n, batch, n_bins), else 0 (the
// rule of ops.histogram.k9_form)
int lanes_form(long long n_bins, long long batch) {
  return n_bins * batch <= kLaneCounters ? 1 : 0;
}

int launch_lanes(const int* bins, int* out, long long n, int batch,
                 int n_bins, int n_sm, cudaStream_t stream) {
  // the 64 KB of lane counters need the opt-in above 48 KB, set once a
  // device
  static uint64_t attr_set = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  const size_t smem = sizeof(int) * kWarps * 32 * kLaneCounters;
  if (dev < 64 && !(attr_set >> dev & 1)) {
    cudaFuncSetAttribute(histogram_lanes_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    cudaFuncSetAttribute(histogram_lanes_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    attr_set |= uint64_t{1} << dev;
  }
  const long long total = n * batch;
  const int head = static_cast<int>(
      ((16 - reinterpret_cast<uintptr_t>(bins) % 16) % 16) / 4);
  const long long n4 = total > head ? (total - head) / kVec : 0;
  // one wave of three blocks an SM, each with at least kBlockEntries
  long long blocks = (n4 * kVec + kBlockEntries - 1) / kBlockEntries;
  if (blocks > 3LL * n_sm) blocks = 3LL * n_sm;
  if (blocks < 1) blocks = 1;
  const long long per_block = (n4 + blocks - 1) / blocks;
  const int hd = total < head ? static_cast<int>(total) : head;
  const int C = n_bins * batch;
  const size_t used = sizeof(int) * kWarps * 32 * C;
  if (batch == 1)
    histogram_lanes_kernel<true>
        <<<static_cast<unsigned>(blocks), kThreads, used, stream>>>(
            bins, out, total, batch, n_bins, hd, per_block);
  else
    histogram_lanes_kernel<false>
        <<<static_cast<unsigned>(blocks), kThreads, used, stream>>>(
            bins, out, total, batch, n_bins, hd, per_block);
  return static_cast<int>(cudaGetLastError());
}

int launch_blocked(const int* bins, int* out, long long n, int batch,
                   int n_bins, int n_sm, cudaStream_t stream) {
  const int slab_max = kSmemInts / n_bins;
  const int slab = batch < slab_max ? batch : slab_max;
  const int fit = kSmemInts / (n_bins * slab);
  const int copies = fit < kWarps ? fit : kWarps;
  const long long slabs = (batch + slab - 1) / slab;
  // about four blocks an SM, each with at least 8192 entries, and none
  // with 2^30 or more (its counter index is 32-bit)
  const long long entries = n * slab;
  long long row_blocks = (entries + 8191) / 8192;
  const long long cap = (4LL * n_sm + slabs - 1) / slabs;
  if (row_blocks > cap) row_blocks = cap;
  const long long floor_blocks = (entries >> 30) + 1;
  if (row_blocks < floor_blocks) row_blocks = floor_blocks;
  const long long rows_per_block = (n + row_blocks - 1) / row_blocks;
  row_blocks = (n + rows_per_block - 1) / rows_per_block;
  const dim3 grid(static_cast<unsigned>(row_blocks),
                  static_cast<unsigned>(slabs < 65535 ? slabs : 65535));
  const size_t smem = sizeof(int) * copies * n_bins * slab;
  histogram_kernel<<<grid, kThreads, smem, stream>>>(
      bins, out, n, batch, n_bins, slab, static_cast<int>(slabs), copies,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (loaded with ctypes).
//
// bins [n, batch] contiguous int32; out [n_bins, batch] int32, which this
// entry zeroes on the stream (cudaMemsetAsync) before the kernel. n,
// batch ≥ 1 and 1 ≤ n_bins ≤ 12288 (the wrapper answers the empty cases
// and refuses larger n_bins); n_sm the card's SM count. Returns
// cudaGetLastError() after the launch (0 = success).
extern "C" int histogram_launch(const void* bins, void* out, long long n,
                                int batch, int n_bins, int n_sm,
                                void* stream) {
  if (n_bins < 1 || n_bins > kSmemInts || n < 1 || batch < 1 || n_sm < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaMemsetAsync(
      out, 0, sizeof(int) * static_cast<size_t>(n_bins) * batch, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int* b = static_cast<const int*>(bins);
  int* o = static_cast<int*>(out);
  return lanes_form(n_bins, batch)
             ? launch_lanes(b, o, n, batch, n_bins, n_sm, st)
             : launch_blocked(b, o, n, batch, n_bins, n_sm, st);
}

// the form histogram_launch takes for n_bins bins of batch columns: 1 the
// small-counter form, 0 the shared-atomic one
extern "C" int histogram_form(int batch, int n_bins) {
  return lanes_form(n_bins, batch);
}
