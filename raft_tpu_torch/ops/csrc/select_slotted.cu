// Packed slotted select (K3) for Hopper (sm_90a), bound to Python through
// a plain C entry point.
//
// Replaces raft_tpu/ops/select_slotted_pallas.py:select_slot_topk_packed
// (pallas_call at :88): K1's packed group fold with the contraction taken
// out. For each row of v [B, L] f32, each group of `tpg` tiles of T
// columns and each lane class c in [0, 128), it keeps the two smallest
// and the third smallest of the packed values of the columns
// {c, c + 128, ...} of that group. A value's low `pbits` mantissa bits
// are replaced by its in-group code (tile % tpg)·(T/128) + chunk, and the
// merge is the reference's 5-op min/max network (_merge_chunk_top2_packed)
// with NaN-propagating min and max (PTX min.NaN / max.NaN): a ±inf input
// OR'd with code bits is NaN, and the certificate of select_k_slotted
// relies on that NaN reaching a3. Outputs a1/a2/a3 [B, G·128] f32,
// G = ceil(ceil(L/T)/tpg).
//
// Columns past L are the reference's _PACK_PAD padding. A padded entry
// packs to ≥ 2^125, which never changes a state that starts at 2^125 and
// only decreases (or is NaN), so the kernel skips them: no padded copy of
// v is made, and the outputs are the twin's bit for bit.
//
// Bound on this card: bytes. One pass reads B·L·4 bytes and writes
// 3·B·G·128·4; the network costs about ten operations a value, some 30×
// less than the memory time.
//
// Design (simple first): one block of 8 warps per (row, group). A thread
// owns the lane classes {lane, lane + 32, lane + 64, lane + 96}, so each
// of its four loads of a chunk is one coalesced 128-byte line for the
// warp, and warp w folds the chunks w, w + 8, ... of the group into
// registers, two chunks' loads in flight before their merges. The top-3
// network computes the three smallest of a multiset whatever the order of
// its inputs (all NaN once a NaN is in), so the eight partial states are
// merged through shared memory into the first warp's state, which is the
// twin's sequential fold exactly, and written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPer = kLanes / 32;    // lane classes a thread owns
constexpr float kPackPad = 4.2535295865117308e37f;   // 2^125

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

__device__ __forceinline__ void merge(float cp, float& a1, float& a2,
                                      float& a3) {
  const float b1 = max_nan(a1, cp);
  a1 = min_nan(a1, cp);
  const float b2 = max_nan(a2, b1);
  a2 = min_nan(a2, b1);
  a3 = min_nan(a3, b2);
}

__device__ __forceinline__ float pack(float c, uint32_t keep, int code) {
  return __int_as_float((__float_as_int(c) & keep) | code);
}

__global__ void __launch_bounds__(kThreads)
select_slot_topk_packed_kernel(const float* __restrict__ v,
                               float* __restrict__ a1_out,
                               float* __restrict__ a2_out,
                               float* __restrict__ a3_out, long L, int T,
                               int tpg, int pbits) {
  __shared__ float part[3][kWarps - 1][kLanes];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = blockIdx.x;
  const int grp = blockIdx.y;
  const int S = gridDim.y * kLanes;
  const long gbase = static_cast<long>(grp) * tpg * T;
  // chunks of the group that hold any column < L (the rest are padding)
  const int chunks = static_cast<int>(
      min(static_cast<long>(tpg) * (T / kLanes),
          (L - gbase + kLanes - 1) / kLanes));
  const float* rowp = v + row * L;
  const uint32_t keep = ~((1u << pbits) - 1u);

  float a1[kPer], a2[kPer], a3[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) a1[j] = a2[j] = a3[j] = kPackPad;

  auto load = [&](int r, float c[kPer]) {
    const long col0 = gbase + static_cast<long>(r) * kLanes + lane;
    if (gbase + static_cast<long>(r + 1) * kLanes <= L) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) c[j] = __ldcs(rowp + col0 + 32 * j);
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const long col = col0 + 32 * j;
        c[j] = col < L ? __ldcs(rowp + col) : kPackPad;
      }
    }
  };

  int r = warp;
  for (; r + kWarps < chunks; r += 2 * kWarps) {
    float c0[kPer], c1[kPer];
    load(r, c0);
    load(r + kWarps, c1);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      merge(pack(c0[j], keep, r), a1[j], a2[j], a3[j]);
      merge(pack(c1[j], keep, r + kWarps), a1[j], a2[j], a3[j]);
    }
  }
  if (r < chunks) {
    float c0[kPer];
    load(r, c0);
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      merge(pack(c0[j], keep, r), a1[j], a2[j], a3[j]);
  }

  // ---- the eight partial states into the first warp's ----
  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int l = lane + 32 * j;
      part[0][warp - 1][l] = a1[j];
      part[1][warp - 1][l] = a2[j];
      part[2][warp - 1][l] = a3[j];
    }
  }
  __syncthreads();
  if (warp == 0) {
    for (int w = 0; w < kWarps - 1; ++w) {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int l = lane + 32 * j;
        merge(part[0][w][l], a1[j], a2[j], a3[j]);
        merge(part[1][w][l], a1[j], a2[j], a3[j]);
        merge(part[2][w][l], a1[j], a2[j], a3[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long o = row * S + static_cast<long>(grp) * kLanes + lane +
                     32 * j;
      a1_out[o] = a1[j];
      a2_out[o] = a2[j];
      a3_out[o] = a3[j];
    }
  }
}

}  // namespace

// C entry point (loaded with ctypes). Returns cudaGetLastError() after the
// launch (0 = success). v [B, L] f32 contiguous; a1/a2/a3 [B, G·128] f32
// with G = ceil(ceil(L/T)/tpg); T % 128 == 0, tpg·T/128 ≤ 2^pbits,
// B ≤ 2^31 − 1, G ≤ 65,535.
extern "C" int select_slot_topk_packed_launch(const void* v, void* a1,
                                              void* a2, void* a3, int B,
                                              long long L, int T, int tpg,
                                              int pbits, void* stream) {
  const long n_tiles = (static_cast<long>(L) + T - 1) / T;
  const int G = static_cast<int>((n_tiles + tpg - 1) / tpg);
  dim3 grid(B, G);
  select_slot_topk_packed_kernel<<<grid, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(v), static_cast<float*>(a1),
      static_cast<float*>(a2), static_cast<float*>(a3),
      static_cast<long>(L), T, tpg, pbits);
  return static_cast<int>(cudaGetLastError());
}
