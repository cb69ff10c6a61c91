// List-major IVF-PQ ADC scan (K5) for Hopper (sm_90a), 8-bit and 4-bit
// codes, bound to Python through a plain C entry point.
//
// Replaces raft_tpu/ops/pq_scan_pallas.py:pq_scan_list_major (the
// _pq_kernel_body contract).
//
// What it computes. Schedule entry j = (start, lsize, off, lid): the list's
// rows are window columns [off, off+lsize) of the window start..start+Wk.
// Every query whose probe table holds lid scores each of them by table
// lookup (asymmetric distance computation) against the reconstructed row
// ŷ = c_lid + concat_s codebook_s[code_s]:
//     adc = Σ_s lut[q, s·K + code_s]                  (s = 0..S−1, K = 2^bits)
//     d2  = ((xx[q] + ‖ŷ‖²) − 2·cdot[q, j]) − 2·adc
//     lb  = max(√max(d2, 0) − Eq_row, 0)²
// lb, the certified lower bound on the true distance (Eq_row is the row's
// recorded round-trip error), folds into the query's 128 slots, slot =
// column % 128, as the top-`depth` (value, global slab row) pairs and a
// running (depth+1)-th min, with strict < (the earlier row wins a tie).
// Untouched slots read (+inf, −1). 8-bit codes are stored biased
// (int8 = code − 128); 4-bit codes pack two to a byte, low nibble = even
// subspace.
//
// Exactness. The table sum runs in f32 from 0.0 in subspace order, and the
// score expression is written with __fadd_rn / __fsub_rn / __fmul_rn so
// that nvcc fuses nothing into an FMA; sqrtf is IEEE (no fast-math). The
// plain twin (ops/pq_scan.py:pq_scan_list_major_ref) does the same
// operations in the same order, so the two agree bit for bit on one input.
//
// Bound on this card. Per scored (query, row) pair: S table reads and adds
// plus ~10 f32 operations for the bound; per streamed row: S or S/2 code
// bytes and two 4-byte sidecars. At the IVF-PQ path's shape (2048 queries,
// 1M × 128 rows in 1024 lists, S = 32, P = 32..128) the pairs make it
// bound by operations (shared-memory lookups, not flops, in practice).
//
// Design (simple first). One block per query, 128 threads, one per slot.
// The query's table lut[q] (S·K f32: 32 KB at S = 32 and 8 bits, 64 KB at
// S = 64) is staged once in dynamic shared memory. The block walks the
// query's member entries in ascending order (the probe table inverted on
// the device before the launch, ops/fine_scan.py:_members), and thread t
// takes the live columns col ≡ t (mod 128) of each entry in increasing
// order. That is the reference's fold order for slot t, so each thread
// keeps its `depth` (value, row) pairs and its rest-min in registers
// (depth is a template parameter) and no partial pools or merge are
// needed: outputs match the reference at exact ties too. The other route,
// K4's per-(query, probe) partial pools plus a merge, needs 17·128·4 bytes
// a (query, probe) at depth 8 (2.3 GB at P = 128) and query chunking.
// Neighbouring threads take neighbouring rows, so a warp's code reads are
// contiguous; a row's codes load as whole 16-byte words when the row width
// is a multiple of 16 bytes. Lists shared by many queries are read once
// per query (from L2 at this size: the 1M-row codes slab with its sidecars
// is 40 MB).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;     // pool slots = threads of a block

template <int D>
__device__ __forceinline__ void fold(float c, int ci, float (&a)[D],
                                     int (&ix)[D], float& rest) {
  bool lt[D];
#pragma unroll
  for (int t = 0; t < D; ++t) lt[t] = c < a[t];
  rest = lt[D - 1] ? a[D - 1] : (c < rest ? c : rest);
#pragma unroll
  for (int t = D - 1; t > 0; --t) {
    a[t] = lt[t - 1] ? a[t - 1] : (lt[t] ? c : a[t]);
    ix[t] = lt[t - 1] ? ix[t - 1] : (lt[t] ? ci : ix[t]);
  }
  a[0] = lt[0] ? c : a[0];
  ix[0] = lt[0] ? ci : ix[0];
}

// One code byte (byte index b of the row) added into the table sum: one
// subspace at 8 bits (biased code), two at 4 bits (low nibble first).
template <int BITS>
__device__ __forceinline__ float add_byte(float acc, uint32_t byte, int b,
                                          const float* lut) {
  if (BITS == 8) return __fadd_rn(acc, lut[(b << 8) + (byte ^ 0x80u)]);
  acc = __fadd_rn(acc, lut[(2 * b) * 16 + (byte & 15u)]);
  return __fadd_rn(acc, lut[(2 * b + 1) * 16 + (byte >> 4)]);
}

template <int BITS>
__device__ __forceinline__ float adc_row(const uint8_t* row, const float* lut,
                                         int CB, bool vec) {
  float acc = 0.f;
  if (vec) {
    const uint4* w = reinterpret_cast<const uint4*>(row);
    for (int k = 0; k < CB / 16; ++k) {
      const uint4 v = __ldg(w + k);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc = add_byte<BITS>(acc, (words[q] >> (8 * b)) & 0xFFu,
                               16 * k + 4 * q + b, lut);
    }
  } else {
    for (int b = 0; b < CB; ++b) acc = add_byte<BITS>(acc, row[b], b, lut);
  }
  return acc;
}

template <int BITS, int D>
__global__ void __launch_bounds__(kLanes)
pq_scan_kernel(const int* __restrict__ sched, const float* __restrict__ xx,
               const int* __restrict__ js, const float* __restrict__ cdot,
               const float* __restrict__ lut,
               const uint8_t* __restrict__ codes,
               const float* __restrict__ yy, const float* __restrict__ eq,
               float* __restrict__ a_out, int* __restrict__ i_out,
               float* __restrict__ rest_out, int nqp, int Pp, int Lp, int S,
               int CB, int R, int Wk, int vec) {
  extern __shared__ __align__(16) float slut[];
  const int q = blockIdx.x, t = threadIdx.x;
  const int KS = S << BITS;
  const float* lq = lut + static_cast<long>(q) * KS;
  for (int e = t; e < KS; e += kLanes) slut[e] = lq[e];
  __syncthreads();

  float a[D], rest = INFINITY;
  int ix[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    a[d] = INFINITY;
    ix[d] = -1;
  }
  const float xq = xx[q];
  for (int p = 0; p < Pp; ++p) {
    const int j = js[static_cast<long>(q) * Pp + p];
    if (j < 0) continue;
    const int start = sched[j], lsize = sched[Lp + j], off = sched[2 * Lp + j];
    // live window columns: the list's rows, inside the window and the slab
    const int c_lo = max(max(off, 0), -start);
    const int c_hi = min(min(off + lsize, Wk), R - start);
    const float cd2 = __fmul_rn(2.f, cdot[static_cast<long>(q) * Lp + j]);
    for (int col = c_lo + ((t - c_lo) % kLanes + kLanes) % kLanes;
         col < c_hi; col += kLanes) {
      const int row = start + col;
      const float adc = adc_row<BITS>(
          codes + static_cast<long>(row) * CB, slut, CB, vec != 0);
      const float d2 = __fsub_rn(__fsub_rn(__fadd_rn(xq, yy[row]), cd2),
                                 __fmul_rn(2.f, adc));
      const float v = fmaxf(__fsub_rn(sqrtf(fmaxf(d2, 0.f)), eq[row]), 0.f);
      fold<D>(__fmul_rn(v, v), row, a, ix, rest);
    }
  }
  const long o = static_cast<long>(q) * kLanes + t;
  const long plane = static_cast<long>(nqp) * kLanes;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    a_out[d * plane + o] = a[d];
    i_out[d * plane + o] = ix[d];
  }
  rest_out[o] = rest;
}

template <int BITS, int D>
int launch(const int* sched, const float* xx, const int* js,
           const float* cdot, const float* lut, const uint8_t* codes,
           const float* yy, const float* eq, float* a_out, int* i_out,
           float* rest_out, int nqp, int Pp, int Lp, int S, int CB, int R,
           int Wk, int vec, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S << BITS) * sizeof(float);
  auto kern = pq_scan_kernel<BITS, D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (nqp > 0)
    kern<<<nqp, kLanes, smem, stream>>>(sched, xx, js, cdot, lut, codes, yy,
                                        eq, a_out, i_out, rest_out, nqp, Pp,
                                        Lp, S, CB, R, Wk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_depth(int depth, const int* sched, const float* xx, const int* js,
                 const float* cdot, const float* lut, const uint8_t* codes,
                 const float* yy, const float* eq, float* a_out, int* i_out,
                 float* rest_out, int nqp, int Pp, int Lp, int S, int CB,
                 int R, int Wk, int vec, cudaStream_t st) {
  switch (depth) {
    case 2:
      return launch<BITS, 2>(sched, xx, js, cdot, lut, codes, yy, eq, a_out,
                             i_out, rest_out, nqp, Pp, Lp, S, CB, R, Wk, vec,
                             st);
    case 4:
      return launch<BITS, 4>(sched, xx, js, cdot, lut, codes, yy, eq, a_out,
                             i_out, rest_out, nqp, Pp, Lp, S, CB, R, Wk, vec,
                             st);
    case 8:
      return launch<BITS, 8>(sched, xx, js, cdot, lut, codes, yy, eq, a_out,
                             i_out, rest_out, nqp, Pp, Lp, S, CB, R, Wk, vec,
                             st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point (loaded with ctypes). sched [4, Lp] i32; xx [nqp] f32; js
// [nqp, Pp] i32, each query's schedule entries ascending (−1 = none); cdot
// [nqp, Lp] f32; lut [nqp, S·2^bits] f32; codes [R, CB] int8 (CB = S at 8
// bits, S/2 at 4); yy and eq [R] f32; a_out [depth, nqp, 128] f32, i_out
// [depth, nqp, 128] i32, rest_out [nqp, 128] f32. vec = 1 when CB is a
// multiple of 16 and codes is 16-byte aligned. bits ∈ {4, 8}, depth ∈
// {2, 4, 8}. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int pq_scan_list_major_launch(
    const void* sched, const void* xx, const void* js, const void* cdot,
    const void* lut, const void* codes, const void* yy, const void* eq,
    void* a_out, void* i_out, void* rest_out, int nqp, int Pp, int Lp, int S,
    int CB, int R, int Wk, int bits, int depth, int vec, void* stream) {
  const int* sc = static_cast<const int*>(sched);
  const float* xf = static_cast<const float*>(xx);
  const int* jj = static_cast<const int*>(js);
  const float* cd = static_cast<const float*>(cdot);
  const float* lf = static_cast<const float*>(lut);
  const uint8_t* cb = static_cast<const uint8_t*>(codes);
  const float* yf = static_cast<const float*>(yy);
  const float* ef = static_cast<const float*>(eq);
  float* ao = static_cast<float*>(a_out);
  int* io = static_cast<int*>(i_out);
  float* ro = static_cast<float*>(rest_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8)
    return launch_depth<8>(depth, sc, xf, jj, cd, lf, cb, yf, ef, ao, io, ro,
                           nqp, Pp, Lp, S, CB, R, Wk, vec, st);
  if (bits == 4)
    return launch_depth<4>(depth, sc, xf, jj, cd, lf, cb, yf, ef, ao, io, ro,
                           nqp, Pp, Lp, S, CB, R, Wk, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
