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
// Exactness. The table sum runs in f32 from 0.0 in a fixed order of the
// row's terms that depends on its window column only (below), and the
// score expression is written with __fadd_rn / __fsub_rn / __fmul_rn so
// that nvcc fuses nothing into an FMA; sqrtf is IEEE (no fast-math). The
// plain twin (ops/pq_scan.py:pq_scan_list_major_ref, its sum
// ops/pq_scan.py:adc_sum) does the same operations in the same order, so
// the two agree bit for bit on one input. The certificate's envelope e_k
// (ann/ivf_pq.py) covers an f32 sum of the S entries in any order.
//
// Bound on this card. Per scored (query, row) pair: S table reads and adds
// plus ~10 f32 operations for the bound; per streamed row: S or S/2 code
// bytes and two 4-byte sidecars. At the IVF-PQ path's shape (2048 queries,
// 1M × 128 rows in 1024 lists, S = 32, P = 32..128) the pairs make it
// bound by operations, and in practice by the table reads and the
// instructions around each: one 4-byte shared-memory word a lane a clock,
// 32 × 132 SMs × 1.98 GHz = 8.4e12 reads/s (the "lookup ceiling"), and 4
// warp instructions an SM a clock.
//
// Design. One block per query, 128 threads, one per slot: thread t takes
// the live columns col ≡ t (mod 128) of the query's member entries in
// increasing order (the probe table inverted on the device before the
// launch, ops/fine_scan.py:_members). That is the reference's fold order
// for slot t, so each thread keeps its `depth` (value, row) pairs and its
// rest-min in registers (depth is a template parameter) and no partial
// pools or merge are needed: outputs match the reference at exact ties
// too. The table reads, and the instructions that address them, bound it:
//   - A row's terms are its code bytes: an 8-bit code, or at 4 bits a
//     pair of subspaces, whose entry in the block's table is the f32 sum
//     of the two subspaces' entries, built once a block. A 4-bit row takes
//     half the reads of one subspace a read. (4-bit rows of more than ~450
//     subspaces, whose pair table would not fit, take one nibble a term.)
//   - The table is code-major: entry c·C + col holds term col % T's value
//     for code c, C = T columns (repeated up to 32 where T is a smaller
//     power of 2), so a read's bank is its column whatever the code.
//   - Lane l takes term (i ^ m) mod T at step i, at column i ^ m, m = l
//     mod 32 (ops/pq_scan.py:adc_order): at every step the 32 lanes of a
//     warp read 32 different banks, instead of ~3.5-way conflicts of one
//     subspace's 256 entries read by 32 random codes. A row's code words
//     are permuted once (a select network, no local memory) so every step
//     extracts its term at a static index: a PRMT for a byte.
//   - Two rows in flight a thread (columns col and col + 128), and each
//     row's terms in two chains (even and odd steps, added at the end):
//     four independent chains of adds, folded in column order. The rows'
//     sidecars (‖ŷ‖², Eq) load with their codes, ahead of the sums.
//   - The code words load as whole 16-byte words (the row width 16, 32 or
//     64 bytes); neighbouring threads take neighbouring rows, so a warp's
//     loads are contiguous. Other widths read a byte at a time, in the
//     same order.
// The 32 KB table (S = 32) caps an SM at 7 blocks; lists shared by many
// queries are read once per query (from L2 at this size: the 1M-row codes
// slab with its sidecars is 40 MB).

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

// The lanes over which a row's T terms spread (ops/pq_scan.py:_order_span):
// 32 where 32 divides T or T is a power of 2, else the largest power of 2
// dividing T
__host__ __device__ constexpr int order_span(int T) {
  return (T % 32 == 0 || (T & (T - 1)) == 0) ? 32 : (T & -T);
}

// A row's code words (NW 32-bit words), permuted once so that every step
// finds its term at a static index: w'[j] = w[j ^ mw], a select network
// over the bits of mw (no local memory)
template <int NW>
__device__ __forceinline__ void load_permuted(const uint8_t* row, int mw,
                                              uint32_t (&w)[NW]) {
  const uint4* v = reinterpret_cast<const uint4*>(row);
#pragma unroll
  for (int k = 0; k < NW / 4; ++k) {
    const uint4 u = __ldg(v + k);
    w[4 * k] = u.x;
    w[4 * k + 1] = u.y;
    w[4 * k + 2] = u.z;
    w[4 * k + 3] = u.w;
  }
#pragma unroll
  for (int b = 1; b < NW; b <<= 1) {
    const bool sw = mw & b;
#pragma unroll
    for (int j = 0; j < NW; ++j)
      if (!(j & b)) {
        const uint32_t lo = w[j], hi = w[j | b];
        w[j] = sw ? hi : lo;
        w[j | b] = sw ? lo : hi;
      }
  }
}

// The table sums of two rows (r0, r1), their 16-byte code words (NV each)
// loaded whole. NIB: a term is a nibble (4-bit codes, one subspace), else
// a byte (an 8-bit code, or a 4-bit pair whose table entry is the sum of
// its two subspaces' entries). Step i takes term (i ^ m) mod T at table
// column i ^ m (C columns, the terms repeated up to 32); even and odd steps
// add into two chains a row, added at the end.
template <bool NIB, int NV>
__device__ __forceinline__ void adc_pair(const uint8_t* r0, const uint8_t* r1,
                                         const float* tab, int m,
                                         float& adc0, float& adc1) {
  constexpr int NW = 4 * NV;
  constexpr int PER = NIB ? 8 : 4;                // terms a word
  constexpr int T = PER * NW;
  constexpr int C = T < 32 ? 32 : T;
  const int mt = m & (T - 1);                     // T is 16, 32, 64 or 128
  uint32_t w0[NW], w1[NW];
  load_permuted<NW>(r0, mt / PER, w0);
  load_permuted<NW>(r1, mt / PER, w1);
  // where step i's term sits in its word: byte (i ^ mt) % 4, or the nibble
  // (i ^ mt) % 8 at bit 4·that
  uint32_t sel[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j)
    sel[j] = NIB ? 4u * ((j ^ mt) & 7) : (0x4440u | ((j ^ mt) & 3));
  float e0 = 0.f, o0 = 0.f, e1 = 0.f, o1 = 0.f;
#pragma unroll
  for (int i = 0; i < T; ++i) {
    const int col = i ^ m;
    const uint32_t a = w0[i / PER], b = w1[i / PER];
    const uint32_t c0 = NIB ? (a >> sel[i % PER]) & 15u
                            : __byte_perm(a, 0, sel[i % PER]);
    const uint32_t c1 = NIB ? (b >> sel[i % PER]) & 15u
                            : __byte_perm(b, 0, sel[i % PER]);
    if (i & 1) {
      o0 = __fadd_rn(o0, tab[c0 * C + col]);
      o1 = __fadd_rn(o1, tab[c1 * C + col]);
    } else {
      e0 = __fadd_rn(e0, tab[c0 * C + col]);
      e1 = __fadd_rn(e1, tab[c1 * C + col]);
    }
  }
  adc0 = __fadd_rn(e0, o0);
  adc1 = __fadd_rn(e1, o1);
}

// The same sum for any row width (one byte read at a time)
template <bool NIB>
__device__ __forceinline__ float adc_bytes(const uint8_t* row,
                                           const float* tab, int T, int C,
                                           int m) {
  float e = 0.f, o = 0.f;
  for (int i = 0; i < T; ++i) {
    const int col = i ^ m, term = col % T;
    const uint32_t c = NIB ? (row[term >> 1] >> (4 * (term & 1))) & 15u
                           : row[term];
    if (i & 1)
      o = __fadd_rn(o, tab[c * C + col]);
    else
      e = __fadd_rn(e, tab[c * C + col]);
  }
  return __fadd_rn(e, o);
}

// the score of one row from its table sum, folded into the slot
template <int D>
__device__ __forceinline__ void score(int row, float adc, float xq,
                                      float cd2, float yr, float er,
                                      float (&a)[D], int (&ix)[D],
                                      float& rest) {
  const float d2 = __fsub_rn(__fsub_rn(__fadd_rn(xq, yr), cd2),
                             __fmul_rn(2.f, adc));
  const float v = fmaxf(__fsub_rn(sqrtf(fmaxf(d2, 0.f)), er), 0.f);
  fold<D>(__fmul_rn(v, v), row, a, ix, rest);
}

// NIB: nibble terms (4-bit singles) or byte terms (8-bit codes or 4-bit
// pairs); NV: the row's 16-byte code words (1, 2 or 4), or 0 for the
// byte-wise path. The table: `rows` codes × C columns, code-major
struct Table {
  int bits, pairs, T, C;
};

template <bool NIB, int D, int NV>
__global__ void __launch_bounds__(kLanes)
pq_scan_kernel(const int* __restrict__ sched, const float* __restrict__ xx,
               const int* __restrict__ js, const float* __restrict__ cdot,
               const float* __restrict__ lut,
               const uint8_t* __restrict__ codes,
               const float* __restrict__ yy, const float* __restrict__ eq,
               float* __restrict__ a_out, int* __restrict__ i_out,
               float* __restrict__ rest_out, int nqp, int Pp, int Lp, int S,
               int CB, int R, int Wk, const Table tb) {
  extern __shared__ __align__(16) float tab[];
  const int q = blockIdx.x, t = threadIdx.x;
  const int K = 1 << tb.bits, T = tb.T, C = tb.C;
  const float* lq = lut + static_cast<long>(q) * S * K;
  // code-major: entry c·C + col holds term col % T's value for code c (the
  // biased byte at 8 bits, the nibble pair's byte or the nibble at 4); a
  // warp's stores fall in 32 consecutive banks
  const int n_tab = (NIB ? 16 : 256) * C;
  for (int e = t; e < n_tab; e += kLanes) {
    const int c = e / C, term = (e - c * C) % T;
    float v;
    if (tb.bits == 8)
      v = __ldg(lq + term * 256 + (c ^ 0x80));
    else if (tb.pairs)
      v = __fadd_rn(__ldg(lq + 2 * term * 16 + (c & 15)),
                    __ldg(lq + (2 * term + 1) * 16 + (c >> 4)));
    else
      v = __ldg(lq + term * 16 + c);
    tab[e] = v;
  }
  __syncthreads();

  float a[D], rest = INFINITY;
  int ix[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    a[d] = INFINITY;
    ix[d] = -1;
  }
  const float xq = xx[q];
  const int m = t & (order_span(T) - 1);
  for (int p = 0; p < Pp; ++p) {
    const int j = js[static_cast<long>(q) * Pp + p];
    if (j < 0) continue;
    const int start = sched[j], lsize = sched[Lp + j], off = sched[2 * Lp + j];
    // live window columns: the list's rows, inside the window and the slab
    const int c_lo = max(max(off, 0), -start);
    const int c_hi = min(min(off + lsize, Wk), R - start);
    const float cd2 = __fmul_rn(2.f, cdot[static_cast<long>(q) * Lp + j]);
    for (int col = c_lo + ((t - c_lo) % kLanes + kLanes) % kLanes;
         col < c_hi; col += 2 * kLanes) {
      const int row = start + col;
      const bool two = col + kLanes < c_hi;
      const int row1 = two ? row + kLanes : row;
      // the rows' sidecars load with their codes, ahead of the sums (left
      // to the compiler, these loads came after them: ~10–20% slower)
      const float y0 = __ldg(yy + row), e0 = __ldg(eq + row);
      const float y1 = __ldg(yy + row1), e1 = __ldg(eq + row1);
      float adc0, adc1;
      if constexpr (NV > 0) {
        adc_pair<NIB, NV>(codes + static_cast<long>(row) * CB,
                          codes + static_cast<long>(row1) * CB, tab, m,
                          adc0, adc1);
      } else {
        adc0 = adc_bytes<NIB>(codes + static_cast<long>(row) * CB, tab, T, C,
                              m);
        adc1 = two ? adc_bytes<NIB>(codes + static_cast<long>(row1) * CB,
                                    tab, T, C, m)
                   : 0.f;
      }
      score<D>(row, adc0, xq, cd2, y0, e0, a, ix, rest);
      if (two) score<D>(row1, adc1, xq, cd2, y1, e1, a, ix, rest);
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

struct Launch {
  const int* sched;
  const float *xx;
  const int* js;
  const float *cdot, *lut;
  const uint8_t* codes;
  const float *yy, *eq;
  float* a_out;
  int* i_out;
  float* rest_out;
  int nqp, Pp, Lp, S, CB, R, Wk;
  Table tb;
  cudaStream_t stream;
};

template <bool NIB, int D, int NV>
int launch(const Launch& l) {
  const size_t smem = static_cast<size_t>(NIB ? 16 : 256) * l.tb.C *
                      sizeof(float);
  auto kern = pq_scan_kernel<NIB, D, NV>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (l.nqp > 0)
    kern<<<l.nqp, kLanes, smem, l.stream>>>(
        l.sched, l.xx, l.js, l.cdot, l.lut, l.codes, l.yy, l.eq, l.a_out,
        l.i_out, l.rest_out, l.nqp, l.Pp, l.Lp, l.S, l.CB, l.R, l.Wk, l.tb);
  return static_cast<int>(cudaGetLastError());
}

// the row width's instance: whole 16-byte words of 1, 2 or 4 (the vector
// path's T of 16·NV bytes or 32·NV nibbles), else bytes
template <bool NIB, int D>
int launch_width(const Launch& l, int vec) {
  const int nv = vec ? l.CB / 16 : 0;
  if (nv == 1) return launch<NIB, D, 1>(l);
  if (nv == 2) return launch<NIB, D, 2>(l);
  if (nv == 4) return launch<NIB, D, 4>(l);
  return launch<NIB, D, 0>(l);
}

template <bool NIB>
int launch_depth(const Launch& l, int depth, int vec) {
  switch (depth) {
    case 2:
      return launch_width<NIB, 2>(l, vec);
    case 4:
      return launch_width<NIB, 4>(l, vec);
    case 8:
      return launch_width<NIB, 8>(l, vec);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// C entry point (loaded with ctypes). sched [4, Lp] i32; xx [nqp] f32; js
// [nqp, Pp] i32, each query's schedule entries ascending (−1 = none); cdot
// [nqp, Lp] f32; lut [nqp, S·2^bits] f32; codes [R, CB] int8 (CB = S at 8
// bits, S/2 at 4); yy and eq [R] f32; a_out [depth, nqp, 128] f32, i_out
// [depth, nqp, 128] i32, rest_out [nqp, 128] f32. bits ∈ {4, 8}, depth ∈
// {2, 4, 8}; pairs = 1 takes a 4-bit row's bytes as terms (a table of
// pair sums), terms T and table columns C as ops/pq_scan.py:table_layout
// gives them; vec = 1 when CB is a multiple of 16 and codes is 16-byte
// aligned. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int pq_scan_list_major_launch(
    const void* sched, const void* xx, const void* js, const void* cdot,
    const void* lut, const void* codes, const void* yy, const void* eq,
    void* a_out, void* i_out, void* rest_out, int nqp, int Pp, int Lp, int S,
    int CB, int R, int Wk, int bits, int depth, int pairs, int T, int C,
    int vec, void* stream) {
  Launch l;
  l.sched = static_cast<const int*>(sched);
  l.xx = static_cast<const float*>(xx);
  l.js = static_cast<const int*>(js);
  l.cdot = static_cast<const float*>(cdot);
  l.lut = static_cast<const float*>(lut);
  l.codes = static_cast<const uint8_t*>(codes);
  l.yy = static_cast<const float*>(yy);
  l.eq = static_cast<const float*>(eq);
  l.a_out = static_cast<float*>(a_out);
  l.i_out = static_cast<int*>(i_out);
  l.rest_out = static_cast<float*>(rest_out);
  l.nqp = nqp; l.Pp = Pp; l.Lp = Lp; l.S = S; l.CB = CB; l.R = R; l.Wk = Wk;
  l.tb = Table{bits, pairs, T, C};
  l.stream = static_cast<cudaStream_t>(stream);
  if (bits != 4 && bits != 8) return static_cast<int>(cudaErrorInvalidValue);
  const bool nib = bits == 4 && !pairs;
  // the vector path's terms are whole words' bytes or nibbles
  if (vec && T != (nib ? 2 : 1) * CB) return static_cast<int>(
      cudaErrorInvalidValue);
  return nib ? launch_depth<true>(l, depth, vec)
             : launch_depth<false>(l, depth, vec);
}
