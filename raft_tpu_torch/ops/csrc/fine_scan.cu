// List-major IVF fine scan (K4) for Hopper (sm_90a), f32 and int8 slabs,
// bound to Python through a plain C entry point.
//
// Replaces raft_tpu/ops/fine_scan_pallas.py:fine_scan_list_major and
// fine_scan_list_major_q8 (the _list_kernel_body contract).
//
// What it computes. Schedule entry j = (start, lsize, off, lid): the list's
// rows are window columns [off, off+lsize) of the window start..start+Wk.
// Every query whose probe table holds lid is scored against each of them
// with the reference's terms (_scores_f32 / _scores_q8):
//     s  = x_hi·y_hi + x_hi·y_lo + x_lo·y_hi     (f32 slab, bf16 hi/lo)
//     s  = x_hi·yq + x_lo·yq                      (int8 slab: codes exact)
//     yy = Σ hi(y²) + Σ lo(y²)                    (int8: Σ yq², exact)
//     d2 = xx[q] + (yy − 2·s)                     (f32 slab)
//     d2 = xx[q] + ((s·s)·yy − (2·s_l)·s)         (int8, list scale s_l)
// and each score folds into the query's 128 slots, slot = column % 128,
// as the top-2 (value, global slab row) and a running 3rd-min, with strict
// < (the earlier row wins a tie). Untouched slots read (+inf, −1).
//
// Precision. The products of bf16 values are exact; only the f32 sums
// round. The tensor cores add each k16 step's products to the accumulator
// (the bound allows truncation there, 2⁻²³ an addition), the norm is two
// f32 sums and the score two roundings, so against the exact value of the
// same terms
//     |Δd2| ≤ (5d + 8)·2⁻²⁴·(‖x‖ + ‖y‖)²                       (E_sum)
// and the plain twin (ops/fine_scan.py:_scan_ref), which sums the same
// terms in another order, stays within 2·E_sum of the kernel. The bf16
// split itself moves d2 by at most 2⁻¹⁶·(‖x‖ + ‖y‖)² from the exact f32
// score (dropped lo·lo, the lo parts' rounding, hi(y²) + lo(y²)), so the
// kernel is within (2⁻¹⁶ + (5d + 8)·2⁻²⁴)·(‖x‖ + max‖y‖)² of it: inside
// the caller's certificate envelope (2⁻¹³ + d·2⁻²²)·(‖x‖ + max‖y‖)²
// (ann/ivf_flat.py) for every d ≤ 1024. int8 codes and Σyq² (≤ 127²·d <
// 2²⁴) are exact; the scale multiplies the finished sums.
//
// Bound on this card. Each probed list is read once per batch and every
// (query, probed row) pair costs 3·2·d bf16 tensor-core operations (2·2·d
// for int8): at the IVF path's shape (2048 queries, 1M × 128 rows in 1024
// lists, P = 32..128) it is bound by those operations.
//
// Design. The probe table is inverted on the device before the launch
// (ops/fine_scan.py:_members): entry j owns the (query, probe column)
// pairs that probe it, so no block scores a query that does not probe the
// list. Work items (ops/fine_scan.py:plan_items) are (entry, batch of up
// to 32 members), issued longest first (most live 128-row chunks), so the
// largest, most-probed lists spread over the SMs and start early. A block
// of 8 warps takes an item:
//   - it gathers the members' query rows once, splits them into bf16 hi
//     and lo in shared memory, and keeps their norms;
//   - it streams the list's live chunks in 128-row × 32-feature slices
//     through a cp.async ring (3 stages of f32, 6 of int8) that refills
//     while the block computes; each slice is split (f32) or widened
//     (int8) once into a bf16 tile, its rows' norm terms summed on the way;
//   - warp w holds queries 16·(w % 2) .. +16 against slots 32·(w / 2) ..
//     +32 on mma.sync m16n8k16 (bf16 in, f32 accumulate). mma.sync, not
//     wgmma: a thread's 16 accumulators and the 16 (query, slot) fold
//     states beside them (80 registers) are the same slots in every
//     chunk, so the fold stays in registers; wgmma's 64-row warpgroup
//     tile would hold 4× the member queries a block, where most lists
//     have fewer than 64 members, and its operand layouts buy nothing at
//     a 32-column tile.
// Each (query, probe column) pair writes its own 128-slot partial pool; a
// second kernel merges a query's partials in ascending entry order, the
// reference's fold order, so the two agree even at exact ties. The top-2 +
// 3rd-min merge is associative; no atomics, deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;     // pool slots = window columns per chunk
constexpr int kBQ = 32;         // member queries per item
constexpr int kKS = 32;         // features per ring stage
constexpr int kThreads = 256;   // 8 warps: 2 query halves × 4 slot quarters
constexpr int kYS = kKS + 8;    // bf16 stride of a converted slab row

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kStages = 3;
  static constexpr int kRowBytes = kKS * 4;
  static constexpr int kSplits = 2;     // y hi and y lo
};
template <>
struct Cfg<int8_t> {
  static constexpr int kStages = 6;
  static constexpr int kRowBytes = kKS;
  static constexpr int kSplits = 1;     // the codes, exact in bf16
};

template <typename T>
struct Smem {
  int ring, ys, yy, xs, xq, total;
  __host__ __device__ explicit Smem(int dp) {
    ring = 0;
    ys = ring + Cfg<T>::kStages * kLanes * Cfg<T>::kRowBytes;
    yy = ys + 2 * Cfg<T>::kSplits * kLanes * kYS * 2;
    xs = yy + 2 * kLanes * 4;
    xq = xs + 2 * kBQ * (dp + 8) * 2;
    total = xq + kBQ * 4;
  }
};

__device__ __forceinline__ void fold(float c, int ci, float& a1, int& i1,
                                     float& a2, int& i2, float& a3) {
  const bool lt1 = c < a1, lt2 = c < a2, lt3 = c < a3;
  a3 = lt2 ? a2 : (lt3 ? c : a3);
  a2 = lt1 ? a1 : (lt2 ? c : a2);
  i2 = lt1 ? i1 : (lt2 ? ci : i2);
  a1 = lt1 ? c : a1;
  i1 = lt1 ? ci : i1;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (a, b) rounded to bf16 (nearest even) by one packed conversion, a in
// the low half; and the pair widened back to f32 exactly
__device__ __forceinline__ unsigned bf2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float2 f2(unsigned u) {
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}

// Step s of an item: rows row0 .. row0+127 (row0 = window start + chunk ·
// 128), features k0 .. k0+31, into one ring stage; rows outside the slab
// and features past d read as zero. 16-byte cp.async where the rows allow
// it (f32: d % 4 == 0; int8: d % 16 == 0; a 16-byte aligned slab), else
// plain loads (visible at the same barrier). An f32 row's eight 16-byte
// chunks are stored at chunk ^ (row & 7), so the split reads them without
// a bank conflict.
__device__ __forceinline__ void load_stage(char* st, const float* slab,
                                           long row0, int k0, int d, int R,
                                           bool vec, int tid) {
  if (vec) {
#pragma unroll
    for (int p = tid; p < kLanes * 8; p += kThreads) {
      const int r = p >> 3, c = p & 7;
      const long row = row0 + r;
      const int k = k0 + c * 4;
      const bool ok = row >= 0 && row < R && k < d;
      cp_async16(st + r * 128 + ((c ^ (r & 7)) << 4),
                 ok ? slab + row * d + k : slab, ok ? 16 : 0);
    }
  } else {
    float* s = reinterpret_cast<float*>(st);
    for (int p = tid; p < kLanes * kKS; p += kThreads) {
      const int r = p >> 5, kk = p & 31;
      const long row = row0 + r;
      const int k = k0 + kk;
      const bool ok = row >= 0 && row < R && k < d;
      s[r * 32 + ((((kk >> 2) ^ (r & 7))) << 2) + (kk & 3)] =
          ok ? slab[row * d + k] : 0.f;
    }
  }
}

__device__ __forceinline__ void load_stage(char* st, const int8_t* slab,
                                           long row0, int k0, int d, int R,
                                           bool vec, int tid) {
  if (vec) {
    const int r = tid >> 1, c = tid & 1;
    const long row = row0 + r;
    const int k = k0 + c * 16;
    const bool ok = row >= 0 && row < R && k < d;
    cp_async16(st + r * 32 + c * 16, ok ? slab + row * d + k : slab,
               ok ? 16 : 0);
  } else {
    int8_t* s = reinterpret_cast<int8_t*>(st);
    for (int p = tid; p < kLanes * kKS; p += kThreads) {
      const int r = p >> 5, kk = p & 31;
      const long row = row0 + r;
      const int k = k0 + kk;
      const bool ok = row >= 0 && row < R && k < d;
      s[r * 32 + kk] = ok ? slab[row * d + k] : static_cast<int8_t>(0);
    }
  }
}

// Thread (row r = tid / 2, half h = tid % 2) splits its 16 features of
// one ring stage into the bf16 tile(s) and adds their norm terms to nh
// (Σ hi(y²)) and nl (Σ lo(y²)), in feature order. Pairs are rounded by
// one packed conversion each.
__device__ __forceinline__ void convert(const char* st, __nv_bfloat16* yh,
                                        __nv_bfloat16* yl, float& nh,
                                        float& nl, int tid, const float*) {
  const int r = tid >> 1, h = tid & 1;
  unsigned wh[8], wl[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = (h * 4 + i) ^ (r & 7);
    const float4 f = *reinterpret_cast<const float4*>(st + r * 128 + c * 16);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float a = e ? f.z : f.x, b = e ? f.w : f.y;
      const unsigned hi = bf2(a, b);
      const float2 hf = f2(hi);
      wh[2 * i + e] = hi;
      wl[2 * i + e] = bf2(__fsub_rn(a, hf.x), __fsub_rn(b, hf.y));
      const float a2 = __fmul_rn(a, a), b2 = __fmul_rn(b, b);
      const unsigned s2 = bf2(a2, b2);
      const float2 sf = f2(s2);
      const float2 tf = f2(bf2(__fsub_rn(a2, sf.x), __fsub_rn(b2, sf.y)));
      nh = __fadd_rn(__fadd_rn(nh, sf.x), sf.y);
      nl = __fadd_rn(__fadd_rn(nl, tf.x), tf.y);
    }
  }
  uint4* dh = reinterpret_cast<uint4*>(yh + r * kYS + h * 16);
  uint4* dl = reinterpret_cast<uint4*>(yl + r * kYS + h * 16);
  dh[0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
  dh[1] = make_uint4(wh[4], wh[5], wh[6], wh[7]);
  dl[0] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
  dl[1] = make_uint4(wl[4], wl[5], wl[6], wl[7]);
}

__device__ __forceinline__ void convert(const char* st, __nv_bfloat16* yq,
                                        __nv_bfloat16*, float& nh, float&,
                                        int tid, const int8_t*) {
  const int r = tid >> 1, h = tid & 1;
  const int4 raw = *reinterpret_cast<const int4*>(st + r * 32 + h * 16);
  const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
  unsigned w[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float a = static_cast<float>(q[2 * e]);
    const float b = static_cast<float>(q[2 * e + 1]);
    nh = __fadd_rn(nh, __fmul_rn(a, a));        // exact integers
    nh = __fadd_rn(nh, __fmul_rn(b, b));
    w[e] = bf2(a, b);                           // exact in bf16
  }
  uint4* dq = reinterpret_cast<uint4*>(yq + r * kYS + h * 16);
  dq[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dq[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
fine_scan_kernel(const int* __restrict__ sched,
                 const float* __restrict__ scale_l,
                 const float* __restrict__ x, const float* __restrict__ xx,
                 const T* __restrict__ slab, const int* __restrict__ seg,
                 const int* __restrict__ member,
                 const int* __restrict__ items, float* __restrict__ pa1,
                 int* __restrict__ pi1, float* __restrict__ pa2,
                 int* __restrict__ pi2, float* __restrict__ pa3, int Pp,
                 int d, int R, int Lp, int Wk, int vec) {
  using C = Cfg<T>;
  constexpr bool kQ8 = sizeof(T) == 1;
  const int j = items[2 * blockIdx.x], p0 = items[2 * blockIdx.x + 1];
  if (j < 0) return;                       // past the plan's last item
  extern __shared__ __align__(16) char smem[];
  const int dp = (d + kKS - 1) / kKS * kKS, XS = dp + 8, nks = dp / kKS;
  const Smem<T> L(dp);
  char* ring = smem + L.ring;
  __nv_bfloat16* ys = reinterpret_cast<__nv_bfloat16*>(smem + L.ys);
  float* yyb = reinterpret_cast<float*>(smem + L.yy);
  __nv_bfloat16* xs_hi = reinterpret_cast<__nv_bfloat16*>(smem + L.xs);
  __nv_bfloat16* xs_lo = xs_hi + kBQ * XS;
  float* xq_s = reinterpret_cast<float*>(smem + L.xq);
  constexpr int kTile = kLanes * kYS;      // one bf16 tile (elements)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wq = warp & 1, wc = warp >> 1;
  const int start = sched[j], lsize = sched[Lp + j], off = sched[2 * Lp + j];
  // live window columns: the list's rows, inside the window and the slab
  const int c_lo = max(max(off, 0), -start);
  const int c_hi = min(min(off + lsize, Wk), R - start);
  const int ch_lo = c_lo / kLanes;
  const int n_ch = c_hi > c_lo ? (c_hi + kLanes - 1) / kLanes - ch_lo : 0;
  const int steps = n_ch * nks;
  const int nm = min(kBQ, seg[j + 1] - p0);
  const bool active = wq * 16 < nm;        // warp-uniform
  const float sc = kQ8 ? scale_l[j] : 1.f;
  const float sc2 = __fmul_rn(sc, sc), sc2x = __fmul_rn(2.f, sc);

  // the members' query rows, split once into bf16 hi and lo
  for (int i = tid; i < kBQ * dp; i += kThreads) {
    const int qi = i / dp, k = i - qi * dp;
    float v = 0.f;
    if (qi < nm && k < d)
      v = x[static_cast<long>(member[p0 + qi] / Pp) * d + k];
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    xs_hi[qi * XS + k] = hi;
    xs_lo[qi * XS + k] =
        __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  }
  if (tid < kBQ) xq_s[tid] = tid < nm ? xx[member[p0 + tid] / Pp] : 0.f;

  auto issue = [&](int s) {
    if (s < steps)
      load_stage(ring + (s % C::kStages) * kLanes * C::kRowBytes, slab,
                 static_cast<long>(start) + (ch_lo + s / nks) * kLanes,
                 (s % nks) * kKS, d, R, vec != 0, tid);
    cp_async_commit();
  };
  float nh = 0.f, nl = 0.f;
  // step s's slice into bf16 tile s & 1; after a chunk's last slice, its
  // rows' norms into yyb[chunk & 1]
  auto split = [&](int s) {
    if (s % nks == 0) nh = nl = 0.f;
    __nv_bfloat16* yb = ys + (s & 1) * C::kSplits * kTile;
    convert(ring + (s % C::kStages) * kLanes * C::kRowBytes, yb,
            yb + (C::kSplits - 1) * kTile, nh, nl, tid,
            static_cast<const T*>(nullptr));
    if (s % nks == nks - 1) {
      const float th = __fadd_rn(nh, __shfl_xor_sync(0xffffffffu, nh, 1));
      const float tl = __fadd_rn(nl, __shfl_xor_sync(0xffffffffu, nl, 1));
      if ((tid & 1) == 0) yyb[((s / nks) & 1) * kLanes + (tid >> 1)] =
          __fadd_rn(th, tl);
    }
  };

  float acc[4][4];
  float a1[2][8], a2[2][8], a3[2][8];
  int i1[2][8], i2[2][8];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      a1[q][c] = a2[q][c] = a3[q][c] = INFINITY;
      i1[q][c] = i2[q][c] = -1;
    }
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) issue(s);
  cp_async_wait<C::kStages - 2>();
  __syncthreads();
  const float xqa = xq_s[wq * 16 + (lane >> 2)];
  const float xqb = xq_s[wq * 16 + (lane >> 2) + 8];
  if (steps > 0) split(0);

  for (int t = 0; t < steps; ++t) {
    issue(t + C::kStages - 1);
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
    if (t + 1 < steps) split(t + 1);
    if (active) {
      const __nv_bfloat16* yb = ys + (t & 1) * C::kSplits * kTile;
      const int ks = t % nks;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int kc = ks * kKS + kk * 16;
        const int arow = (wq * 16 + (lane & 15)) * XS + kc + (lane >> 4) * 8;
        unsigned ah[4], al[4];
        ldsm_x4(ah, xs_hi + arow);
        ldsm_x4(al, xs_lo + arow);
        // B fragments of the warp's 4 n8 tiles (y hi, and y lo for f32)
        unsigned bh[2][4], bl[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int brow = (wc * 32 + np * 16 + (lane & 7) +
                            ((lane >> 4) << 3)) * kYS +
                           kk * 16 + ((lane >> 3) & 1) * 8;
          ldsm_x4(bh[np], yb + brow);
          if (!kQ8) ldsm_x4(bl[np], yb + kTile + brow);
        }
        // product-major: an accumulator's products are 4 mma apart
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(acc[n], ah, bh[n >> 1][(n & 1) * 2],
                   bh[n >> 1][(n & 1) * 2 + 1]);
        if (!kQ8) {
#pragma unroll
          for (int n = 0; n < 4; ++n)
            mma_bf16(acc[n], ah, bl[n >> 1][(n & 1) * 2],
                     bl[n >> 1][(n & 1) * 2 + 1]);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma_bf16(acc[n], al, bh[n >> 1][(n & 1) * 2],
                   bh[n >> 1][(n & 1) * 2 + 1]);
      }
      if (t % nks == nks - 1) {
        // the chunk's scores fold into the same slots as every chunk's
        const float* yyc = yyb + ((t / nks) & 1) * kLanes;
        const int ch = ch_lo + t / nks;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int slot = wc * 32 + n * 8 + (lane & 3) * 2 + e;
            const int col = ch * kLanes + slot;
            const bool live = col >= c_lo && col < c_hi;
            const float yv = yyc[slot];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float s = acc[n][2 * q + e];
              const float r =
                  kQ8 ? __fsub_rn(__fmul_rn(sc2, yv), __fmul_rn(sc2x, s))
                      : __fsub_rn(yv, __fmul_rn(2.f, s));
              const float d2 = live ? __fadd_rn(q ? xqb : xqa, r) : INFINITY;
              fold(d2, start + col, a1[q][2 * n + e], i1[q][2 * n + e],
                   a2[q][2 * n + e], i2[q][2 * n + e], a3[q][2 * n + e]);
            }
            acc[n][e] = acc[n][e + 2] = 0.f;
          }
      }
    }
  }
  cp_async_wait<0>();

  // this entry's partial pool of each member (query, probe column)
  if (active) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int qi = wq * 16 + (lane >> 2) + 8 * q;
      if (qi < nm) {
        const long o = static_cast<long>(member[p0 + qi]) * kLanes;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const long s = o + wc * 32 + n * 8 + (lane & 3) * 2 + e;
            pa1[s] = a1[q][2 * n + e];
            pi1[s] = i1[q][2 * n + e];
            pa2[s] = a2[q][2 * n + e];
            pi2[s] = i2[q][2 * n + e];
            pa3[s] = a3[q][2 * n + e];
          }
      }
    }
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
           const int* js, const int* items, int n_items, float* pa1,
           int* pi1, float* pa2, int* pi2, float* pa3, float* a1, int* i1,
           float* a2, int* i2, float* a3, int nqp, int Pp, int d, int R,
           int Lp, int Wk, cudaStream_t stream) {
  const int dp = (d + kKS - 1) / kKS * kKS;
  const int smem = Smem<T>(dp).total;
  auto kern = fine_scan_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int lanes16 = sizeof(T) == 4 ? 4 : 16;
  const int vec = d % lanes16 == 0 &&
                  reinterpret_cast<uintptr_t>(slab) % 16 == 0;
  if (n_items > 0) {
    kern<<<n_items, kThreads, smem, stream>>>(
        sched, scale_l, x, xx, slab, seg, member, items, pa1, pi1, pa2, pi2,
        pa3, Pp, d, R, Lp, Wk, vec);
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
// the inverted probe table; items [n_items, 2] i32 (entry, first member
// position; entry −1 = no item) from the work plan; five partial pools
// [nqp·Pp, 128] and five outputs [nqp, 128] (f32, i32, f32, i32, f32);
// d ≤ 1024. Returns cudaGetLastError() after the launches (0 = success).
extern "C" int fine_scan_list_major_launch(
    const void* sched, const void* scale_l, const void* x, const void* xx,
    const void* slab, const void* seg, const void* member, const void* js,
    const void* items, void* pa1, void* pi1, void* pa2, void* pi2,
    void* pa3, void* a1, void* i1, void* a2, void* i2, void* a3,
    int n_items, int nqp, int Pp, int d, int R, int Lp, int Wk, int q8,
    void* stream) {
  const int* sc = static_cast<const int*>(sched);
  const float* sl = static_cast<const float*>(scale_l);
  const float* xf = static_cast<const float*>(x);
  const float* xxf = static_cast<const float*>(xx);
  const int* sg = static_cast<const int*>(seg);
  const int* mb = static_cast<const int*>(member);
  const int* jj = static_cast<const int*>(js);
  const int* it = static_cast<const int*>(items);
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
                          sg, mb, jj, it, n_items, p1, q1, p2, q2, p3, o1,
                          n1, o2, n2, o3, nqp, Pp, d, R, Lp, Wk, st);
  return launch<float>(sc, nullptr, xf, xxf, static_cast<const float*>(slab),
                       sg, mb, jj, it, n_items, p1, q1, p2, q2, p3, o1, n1,
                       o2, n2, o3, nqp, Pp, d, R, Lp, Wk, st);
}
