// Exact Jonker–Volgenant tail of the linear assignment solver for Hopper
// (sm_90a), bound to Python through a plain C entry point.
//
// Replaces no TPU kernel. The reference's exact tail
// (raft_tpu/solver/linear_assignment.py:_jv_solve, :152-229) is a jitted
// while_loop: n augmentations, each a Dijkstra over the columns whose next
// step depends on the last (stop on reaching a free column). In PyTorch
// operations that is one host read a step, about n² of them; here the whole
// solve is one launch, the control flow kept on the card.
//
// What it computes, exactly as _jv_solve does in f32 (the twin
// ops.lap_jv.lap_jv_solve_ref repeats it step for step): for each instance b of
// cost [batch, n, n] f32 row-major, the min-cost assignment by n shortest
// augmenting paths from the virtual column n, and the row duals u. Each
// step: cur = (cost[i_row] − u[i_row]) − v over the columns; unused columns
// keep min(minv, cur) and its predecessor; the block's argmin of minv over
// the unused columns (used ones count as 3e38, the first index among equal
// values, as jnp.argmin) gives j1 and delta; used columns' rows gain delta,
// their v lose it, unused columns' minv lose it. Every operation is one f32
// add, subtract or compare in the reference's order, so kernel, twin and
// reference give the same bits.
//
// Design. One thread block an instance, 1024 threads, thread t owning
// columns t, t + 1024, ... (at most 8). u [n], v [n], minv [n], way [n],
// p [n + 1] (column → row, p[n] the row being augmented) and used [n] sit
// in dynamic shared memory: 21 bytes a column, 172 KB at the envelope's
// n = 8192, within a block's 227 KB. A column's v, minv, way and used are
// written only by its owner, so a step needs three barriers: after the
// warps' argmins, after the block's, and after the dual updates. The argmin
// is a warp-shuffle reduction of (value, column) pairs, then one over the
// warps. The cost rows are read from global memory, coalesced. Thread 0
// backtracks each augmenting path.
//
// Bound on this card. The tail is latency bound: a step costs three block
// barriers and two shuffle reductions whatever n is, and the steps run one
// after another. The bytes it must move (the cost matrix once, n² · 4) and
// its operations (a few per column a step) are no useful bound; the work
// the data needs is Σ over augmentations of (steps × n) column updates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 8192;
constexpr int kColsPerThread = kMaxN / kThreads;
constexpr float kInf = 3e38f;

struct ArgMin {
  float v;
  int j;
};

__device__ __forceinline__ ArgMin better_of(ArgMin a, ArgMin b) {
  // the smaller value; among equal values the smaller column (jnp.argmin)
  return (b.v < a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}

__device__ __forceinline__ ArgMin warp_argmin(ArgMin a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMin o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.j = __shfl_xor_sync(0xffffffffu, a.j, off);
    a = better_of(a, o);
  }
  return a;
}

__global__ void __launch_bounds__(kThreads, 1)
lap_jv_kernel(const float* __restrict__ cost, int n,
              int* __restrict__ assign, float* __restrict__ u_out,
              long long* __restrict__ steps_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* u = reinterpret_cast<float*>(smem);
  float* v = u + n;
  float* minv = v + n;
  int* way = reinterpret_cast<int*>(minv + n);
  int* p = way + n;                                   // [n + 1]
  unsigned char* used = reinterpret_cast<unsigned char*>(p + n + 1);
  __shared__ float warp_v[kWarps];
  __shared__ int warp_j[kWarps];
  __shared__ float s_delta;
  __shared__ int s_j1;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* C = cost + static_cast<long long>(blockIdx.x) * n * n;
  long long steps = 0;                                // counted by thread 0

  for (int j = tid; j < n; j += kThreads) {
    u[j] = 0.0f;
    v[j] = 0.0f;
    p[j] = -1;
  }
  if (tid == 0) p[n] = -1;
  __syncthreads();

  for (int i0 = 0; i0 < n; ++i0) {
    for (int j = tid; j < n; j += kThreads) {
      minv[j] = kInf;
      way[j] = n;
      used[j] = 0;
    }
    if (tid == 0) p[n] = i0;
    __syncthreads();
    int j0 = n;                                       // the virtual column
    while (true) {
      const int i_row = p[j0];
      if (i_row < 0) break;                           // a free column
      ++steps;
      const float ui = u[i_row];
      const float* crow = C + static_cast<long long>(i_row) * n;
      ArgMin best{kInf, n};
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) {
        const int j = tid + k * kThreads;
        if (j < n) {
          if (j == j0) used[j] = 1;
          float cand = kInf;
          if (!used[j]) {
            const float cur = (crow[j] - ui) - v[j];
            if (cur < minv[j]) {
              minv[j] = cur;
              way[j] = j0;
            }
            cand = minv[j];
          }
          best = better_of(best, ArgMin{cand, j});
        }
      }
      best = warp_argmin(best);
      if (lane == 0) {
        warp_v[warp] = best.v;
        warp_j[warp] = best.j;
      }
      __syncthreads();
      if (warp == 0) {
        ArgMin w{warp_v[lane], warp_j[lane]};
        w = warp_argmin(w);
        if (lane == 0) {
          s_delta = w.v;
          s_j1 = w.j;
        }
      }
      __syncthreads();
      const float delta = s_delta;
      const int j1 = s_j1;
#pragma unroll
      for (int k = 0; k < kColsPerThread; ++k) {
        const int j = tid + k * kThreads;
        if (j < n) {
          if (used[j]) {
            u[p[j]] += delta;        // distinct rows: p is a matching
            v[j] -= delta;
          } else {
            minv[j] -= delta;
          }
        }
      }
      if (tid == 0) u[p[n]] += delta;   // i0, unmatched so far
      __syncthreads();
      j0 = j1;
    }
    // backtrack the augmenting path to the virtual column
    if (tid == 0) {
      while (j0 != n) {
        const int j1 = way[j0];
        p[j0] = p[j1];
        j0 = j1;
      }
    }
    __syncthreads();
  }

  int* a = assign + static_cast<long long>(blockIdx.x) * n;
  float* uo = u_out + static_cast<long long>(blockIdx.x) * n;
  for (int j = tid; j < n; j += kThreads) {
    a[p[j]] = j;
    uo[j] = u[j];
  }
  if (tid == 0 && steps_out != nullptr) steps_out[blockIdx.x] = steps;
}

}  // namespace

extern "C" {

// cost [batch, n, n] f32 → assign [batch, n] int32 (row → column), u
// [batch, n] f32 (row duals) and, when steps is not null, each instance's
// Dijkstra steps [batch] int64. Returns the launch's CUDA error code.
int lap_jv_launch(const float* cost, int batch, int n, int* assign,
                  float* u, long long* steps, cudaStream_t stream) {
  if (n < 1 || n > kMaxN || batch < 1) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(n) * 4 * 4 +
                      static_cast<size_t>(n + 1) * 4 + n;
  cudaError_t err = cudaFuncSetAttribute(
      lap_jv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  lap_jv_kernel<<<batch, kThreads, smem, stream>>>(cost, n, assign, u,
                                                   steps);
  return cudaGetLastError();
}

}  // extern "C"
