// Sampled dense-dense product (K7) for Hopper (sm_90a), bound to Python
// through a plain C entry point.
//
// Replaces raft_tpu/ops/sddmm_pallas.py:sddmm_tiled over the TiledPairs
// layout of sparse/tiled.py.
//
// What it computes. For every entry i of a sparsity structure given as
// (rows[i], cols[i]), the dot product
//     out[o] = Σ_k A[rows[i], k] · Bt[cols[i], k],   o = dst ? dst[i] : i,
// of a row of A [m, d] and a row of Bt = Bᵀ [n, d]. The wrapper passes the
// structure's own entry order (dst null); `dst` lets a caller run the
// entries in another order (chip_smoke.py times the layout's tile order
// with it) and still write each result to its entry.
//
// Precision. An f32 fma chain over d/8 terms per lane and three shuffle
// additions: |Δ| ≤ (d + 2)·2⁻²⁴·Σ_k |a_k·b_k|. The reference forms the
// dense block on the MXU at bf16×3 (≈ 2⁻¹⁶ relative).
//
// Bound on this card. Each entry needs 2·d flops and its two operand rows;
// read once, A and B are (m + n)·d·4 bytes, and the structure's least form
// (CSR) with the output nnz·8 + (m + 1)·4 bytes, so the work is bound by
// memory.
//
// Design (simple first). The TPU formed each (row tile × column tile)
// block's dense [R, C] tile A_r·B_cᵀ on the MXU and extracted the entries
// with one-hot products, R·C·d flops a chunk whatever its fill. Here the
// work is per entry: 8 lanes own one entry and read its two rows as
// float4s (d padded to a multiple of 4 by the wrapper), 32 entries in
// flight per 256-thread block, and a 3-step shuffle finishes the dot. No
// tile is staged in shared memory: the rows come through L1/L2. In CSR
// order the entries of one row are neighbours, so a block reuses its A
// rows; the B rows of the heavy columns of a skewed graph stay in L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                 // lanes per entry
constexpr int kGroups = kThreads / kLanes;

__global__ void __launch_bounds__(kThreads)
sddmm_kernel(const float4* __restrict__ A, const float4* __restrict__ Bt,
             const int* __restrict__ rows, const int* __restrict__ cols,
             const int* __restrict__ dst, float* __restrict__ out,
             long long nnz, int d4) {
  const int lane = threadIdx.x % kLanes;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  // every group of a warp runs the same trip count (the bound is rounded
  // up to whole warps), so whole warps reach the shuffles together
  const long long n_round = (nnz + kGroups - 1) / kGroups * kGroups;
  for (long long i = static_cast<long long>(blockIdx.x) * kGroups +
                     threadIdx.x / kLanes;
       i < n_round; i += stride) {
    const bool real = i < nnz;
    float acc = 0.f;
    if (real) {
      const float4* a = A + static_cast<long long>(__ldg(&rows[i])) * d4;
      const float4* b = Bt + static_cast<long long>(__ldg(&cols[i])) * d4;
      for (int k = lane; k < d4; k += kLanes) {
        const float4 p = __ldg(&a[k]);
        const float4 q = __ldg(&b[k]);
        acc = fmaf(p.x, q.x, acc);
        acc = fmaf(p.y, q.y, acc);
        acc = fmaf(p.z, q.z, acc);
        acc = fmaf(p.w, q.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (real && lane == 0) out[dst ? __ldg(&dst[i]) : i] = acc;
  }
}

}  // namespace

// C entry point (loaded with ctypes). A [m, 4·d4] and Bt [n, 4·d4]
// contiguous f32 (16-byte rows); rows, cols and dst (may be null) [nnz]
// int32; out [nnz] f32, every entry written once. Launches nothing for
// nnz = 0. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int sddmm_launch(const void* A, const void* Bt, const void* rows,
                            const void* cols, const void* dst, void* out,
                            long long nnz, int d4, void* stream) {
  if (nnz > 0) {
    const long long want = (nnz + kGroups - 1) / kGroups;
    const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
    sddmm_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(A), static_cast<const float4*>(Bt),
        static_cast<const int*>(rows), static_cast<const int*>(cols),
        static_cast<const int*>(dst), static_cast<float*>(out), nnz, d4);
  }
  return static_cast<int>(cudaGetLastError());
}
