// Tiled sparse matrix-vector and matrix-matrix products (K6) for Hopper
// (sm_90a), bound to Python through plain C entry points.
//
// Replaces raft_tpu/ops/spmv_pallas.py: spmv_tiled (K6a), spmv_pair_tiled
// (K6b) and spmm_tiled (K6c), over the layouts of sparse/tiled.py.
//
// What they compute. K6a: y = A·x over a TiledELL. Scatter slot s of
// chunk c (row tile chunk_row_tile[c], in-tile row row_local[c·E + s], pad
// = R) holds gather slot g = perm_rows[(c·E + s)/8]·8 + s%8, whose value is
// vals[g] and whose column is chunk_col_tile[g/E]·C + col_local[g]; the
// contribution vals[g]·x[col] adds into y[row]. K6b: the same over a
// TiledPairsSpmv, where slot s of chunk c holds its own value, row and
// column (no permutation). K6c: K6a with a dense B [n_cols, V] in place of
// x, Y [n_rows, V].
//
// Precision. f32 products and f32 sums, in an order that changes from run
// to run: K6a adds the f32 sum of each run of equal rows among a lane's
// slots (a slot's product where the run is one slot long) into a
// shared-memory row tile with shared atomics, and a row tile split over
// several work items reaches y through global atomics; K6b and K6c alike.
// No contribution array goes through device memory. Every order is a sum
// of the row's nnz_i products starting from 0: |Δy_i| ≤ (nnz_i + 2)·2⁻²⁴·
// Σ_j |a_ij·x_j| against an exact sum (nnz_i + 1 additions, one product).
//
// Bound on this card. Each nonzero costs 2·V flops and at least 8 bytes
// (value + column id), and x/B and y/Y move V·(n_cols + n_rows)·4 bytes:
// bound by memory at every V up to 512 on graphs of ~33 nonzeros a row.
// The least traffic is the CSR form's (nnz·8 + (n_rows + 1)·4 bytes plus
// x and y); the tiled layout reads ~12.5 bytes a slot and pads nnz to
// 1.1–1.8× as many slots on R-MAT graphs of scale 16 to 22.
//
// Design. The TPU ran a gather kernel, an XLA row gather (perm_rows) and
// a scatter kernel because it has no gather; here a block does all three
// and no contribution array goes through device memory.
// - K6a: the first design (one block a chunk, a thread walking slots s =
//   t, t + 256, ... through the dependent chain perm_rows → value and
//   column → x, one load of each in flight) ran at a third of HBM's rate.
//   Now one block takes a work item (≤ 16 chunks of one row tile, the
//   layout's item table that K6c reads too). A lane owns one 8-slot
//   scatter row, so its slots are 8 consecutive gather slots: one
//   perm_rows read, then the in-tile rows, values and columns in 16-byte
//   loads (a warp's rows and in-tile rows coalesced), the gather row and
//   in-tile rows two steps ahead; then 8 __ldg gathers of x in flight (x
//   is L2-resident: 16 MB at 4M columns) and one shared atomic a run of
//   equal rows into an R-float y tile. An item that holds its whole row
//   tile stores the tile with plain stores; a split one adds it with
//   global atomics, so y is zeroed only in the layout's zero_tiles.
// - K6b: one block per chunk, x tile and y tile in shared memory. The
//   layout packs each slot's row and column into one int32 (16 bits each),
//   so a slot costs 8 bytes, read four slots to a thread with 16-byte
//   loads. A chunk's slots are sorted by row: a lane sums its runs of
//   equal rows, a segmented warp scan joins the runs that cross lanes, and
//   one shared atomic a run (not a slot) reaches the y tile.
// - K6c: the gathers of B's rows are what costs. A first design (one
//   block a chunk, a flat (slot, column) walk with an integer division,
//   one 4-byte load and one shared atomic an element, a 152 KB block) had
//   about one gather in flight a warp and was bound by latency. Now one
//   block takes a work item (a run of ≤ 16 chunks of one row tile, from
//   the layout's item table) and a slice of VC ≤ 64 columns (a 64 KB tile
//   at R = 256: three blocks an SM). A warp reads the metadata of 32·M
//   consecutive slots once, coalesced and a step ahead (perm_rows and
//   row_local, then value and column), hands each slot to QP lanes with
//   shuffles, and those lanes gather its B row in float4s, 8 rows in
//   flight a lane; a run of equal rows among a lane's slots is summed in
//   registers before its shared atomic. An item that holds its whole row
//   tile stores its tile into Y with plain stores, so Y is zeroed only
//   where a row tile is split or unvisited.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void flush_tile(const float* tile, float* y,
                                           long long row0, int R, int n_rows,
                                           int V, int v0, int vc) {
  for (int i = threadIdx.x; i < R * vc; i += blockDim.x) {
    const int r = i / vc;
    const int v = i - r * vc;
    const long long row = row0 + r;
    const float val = tile[i];
    if (row < n_rows && val != 0.f)
      atomicAdd(&y[row * V + v0 + v], val);
  }
}

// K6a: a lane's M slots as 16-byte loads (M a multiple of 4, the slots
// 16-byte aligned: E % 8 == 0 and the arrays' bases aligned)
template <int M>
__device__ __forceinline__ void load_m(int (&v)[M], const int* p) {
#pragma unroll
  for (int k = 0; k < M / 4; ++k) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p) + k);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}
template <int M>
__device__ __forceinline__ void load_m(float (&v)[M], const float* p) {
#pragma unroll
  for (int k = 0; k < M / 4; ++k) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p) + k);
    v[4 * k] = q.x;
    v[4 * k + 1] = q.y;
    v[4 * k + 2] = q.z;
    v[4 * k + 3] = q.w;
  }
}

// K6a: one block per work item; a lane takes one whole 8-slot scatter row
// (kM slots), sums each run of equal rows among them before its shared
// atomic, and the registers are capped for kBlocks blocks an SM (chosen on
// the card, PERF.md §6: fewer slots a lane, no run sums or more blocks an
// SM were slower, and past 3 blocks the lane's state spills).
constexpr int kM = 8;
constexpr int kBlocks = 3;

__global__ void __launch_bounds__(kThreads, kBlocks)
spmv_item_kernel(const float* __restrict__ vals,
                 const int* __restrict__ col_local,
                 const int* __restrict__ chunk_col_tile,
                 const int* __restrict__ perm_rows,
                 const int* __restrict__ row_local,
                 const int* __restrict__ chunk_row_tile,
                 const int* __restrict__ item_chunk0,
                 const int* __restrict__ item_split,
                 const float* __restrict__ x, float* __restrict__ y, int E,
                 int C, int R, int zero_row) {
  extern __shared__ float ytile[];
  const int item = blockIdx.x;
  const int c0 = item_chunk0[item];
  const int c1 = item_chunk0[item + 1];
  for (int r = threadIdx.x; r < R; r += kThreads) ytile[r] = 0.f;
  const int E8 = E >> 3;
  const long long s_end = static_cast<long long>(c1) * E;
  constexpr long long stride = static_cast<long long>(kThreads) * kM;
  // a lane's slots s .. s + 7 are one scatter row (pad rows: perm_rows ≥
  // zero_row; pad slots: row_local == R), gather slots perm_rows·8 ..
  // perm_rows·8 + 7; E % 512 == 0, so a warp's rows are all inside the
  // item or all past it. Each step's metadata arrives in two rounds
  // issued ahead of its gathers: the gather row and in-tile rows two steps
  // ahead, the values and columns one step ahead.
  auto round1 = [&](long long ss, int& pr, int (&rl)[kM]) {
    pr = zero_row;
#pragma unroll
    for (int m = 0; m < kM; ++m) rl[m] = R;
    if (ss < s_end) {
      pr = __ldg(perm_rows + (ss >> 3));
      load_m<kM>(rl, row_local + ss);
    }
  };
  auto round2 = [&](long long ss, int pr, float (&a)[kM], int (&col)[kM]) {
    if (pr < zero_row) {
      const long long g = static_cast<long long>(pr) * 8;
      load_m<kM>(a, vals + g);
      load_m<kM>(col, col_local + g);
      const int c = __ldg(chunk_col_tile + pr / E8) * C;
#pragma unroll
      for (int m = 0; m < kM; ++m) col[m] += c;
    }
  };
  long long s = static_cast<long long>(c0) * E + threadIdx.x * kM;
  int pr0, pr1, rl0[kM], rl1[kM];
  float a0[kM], a1[kM];
  int col0[kM], col1[kM];
  round1(s, pr0, rl0);
  round2(s, pr0, a0, col0);
  round1(s + stride, pr1, rl1);
  __syncthreads();
  for (; s < s_end; s += stride) {
    round2(s + stride, pr1, a1, col1);
    int pr2, rl2[kM];
    round1(s + 2 * stride, pr2, rl2);
    if (pr0 < zero_row) {
      float p[kM];
#pragma unroll
      for (int m = 0; m < kM; ++m)            // pad slots gather nothing
        p[m] = rl0[m] < R ? a0[m] * __ldg(x + col0[m]) : 0.f;
      // neighbours of one row (a bucket keeps its entries' input order,
      // rows ascending for CSR input) are summed first
      int cur = rl0[0];
      float acc = p[0];
#pragma unroll
      for (int m = 1; m < kM; ++m) {
        if (rl0[m] == cur) {
          acc += p[m];
        } else {
          if (cur < R) atomicAdd(&ytile[cur], acc);
          cur = rl0[m];
          acc = p[m];
        }
      }
      if (cur < R) atomicAdd(&ytile[cur], acc);
    }
    pr0 = pr1;
    pr1 = pr2;
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      rl0[m] = rl1[m];
      rl1[m] = rl2[m];
      a0[m] = a1[m];
      col0[m] = col1[m];
    }
  }
  __syncthreads();
  // the whole row tile: plain stores, zeros included; a split one: atomics
  float* yt = y + static_cast<long long>(chunk_row_tile[c0]) * R;
  const bool split = item_split[item] != 0;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const float v = ytile[r];
    if (!split)
      yt[r] = v;
    else if (v != 0.f)
      atomicAdd(yt + r, v);
  }
}

// K6b: one block per chunk of a pair-tiled operand.
__device__ __forceinline__ void add_run(float* ytile, int row, int R,
                                        float v) {
  if (row < R) atomicAdd(&ytile[row], v);       // pads (row R) never add
}

// Four consecutive slots of one lane, rows nondecreasing across the warp.
__device__ __forceinline__ void pair_quad(const float* xt, float* ytile,
                                          int R, int lane, int4 rc,
                                          float4 val) {
  const unsigned w[4] = {static_cast<unsigned>(rc.x),
                         static_cast<unsigned>(rc.y),
                         static_cast<unsigned>(rc.z),
                         static_cast<unsigned>(rc.w)};
  const float a[4] = {val.x, val.y, val.z, val.w};
  // the lane's runs: the first (lead) may continue the previous lane's
  // last, runs strictly inside the lane add at once, the last (tail) may
  // go on into the next lane
  int cur = static_cast<int>(w[0] >> 16);
  float acc = a[0] * xt[w[0] & 0xffffu];
  const int lead = cur;
  float lead_sum = 0.f;
  bool multi = false;
#pragma unroll
  for (int e = 1; e < 4; ++e) {
    const int r = static_cast<int>(w[e] >> 16);
    const float p = a[e] * xt[w[e] & 0xffffu];
    if (r == cur) {
      acc += p;
    } else {
      if (multi) add_run(ytile, cur, R, acc);
      else lead_sum = acc;
      multi = true;
      cur = r;
      acc = p;
    }
  }
  const int tail = cur;
  // inclusive scan of the tail sums over the lanes, segmented by the tail
  // row (equal keys are contiguous, since rows never decrease)
  float run = acc;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, run, off);
    const int ot = __shfl_up_sync(0xffffffffu, tail, off);
    if (lane >= off && ot == tail) run += o;
  }
  const int prev_tail = __shfl_up_sync(0xffffffffu, tail, 1);
  const float prev_run = __shfl_up_sync(0xffffffffu, run, 1);
  const int next_lead = __shfl_down_sync(0xffffffffu, lead, 1);
  if (multi)
    add_run(ytile, lead, R,
            lead_sum + (lane > 0 && prev_tail == lead ? prev_run : 0.f));
  if (lane == 31 || next_lead != tail) add_run(ytile, tail, R, run);
}

__global__ void __launch_bounds__(kThreads)
spmv_pair_kernel(const float* __restrict__ vals,
                 const int* __restrict__ rowcol,
                 const int* __restrict__ chunk_row_tile,
                 const int* __restrict__ chunk_col_tile,
                 const float* __restrict__ x, float* __restrict__ y, int E,
                 int C, int R, int n_rows, int n_cols) {
  constexpr int kU = 2;                        // quads a thread has in flight
  extern __shared__ float sm[];
  float* xt = sm;
  float* ytile = sm + C;
  const int c = blockIdx.x;
  const long long base = static_cast<long long>(c) * E;
  const int4* rc4 = reinterpret_cast<const int4*>(rowcol + base);
  const float4* v4 = reinterpret_cast<const float4*>(vals + base);
  const int n4 = E >> 2;             // E % 512 == 0: a warp is all in or out
  const int lane = threadIdx.x & 31;
  const int pad = static_cast<int>(static_cast<unsigned>(R) << 16);
  int4 rq[kU];
  float4 vq[kU];
  auto load = [&](int i0) {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int i = i0 + u * kThreads;
      if (i < n4) {
        rq[u] = __ldg(rc4 + i);
        vq[u] = __ldg(v4 + i);
      } else {
        rq[u] = make_int4(pad, pad, pad, pad);
        vq[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  load(threadIdx.x);                 // in flight while the x tile loads
  const long long col0 = static_cast<long long>(chunk_col_tile[c]) * C;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    xt[j] = col0 + j < n_cols ? x[col0 + j] : 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) ytile[r] = 0.f;
  __syncthreads();
  for (int i0 = threadIdx.x; i0 < n4;) {
#pragma unroll
    for (int u = 0; u < kU; ++u) pair_quad(xt, ytile, R, lane, rq[u], vq[u]);
    i0 += kU * kThreads;
    if (i0 < n4) load(i0);
  }
  __syncthreads();
  flush_tile(ytile, y, static_cast<long long>(chunk_row_tile[c]) * R, R,
             n_rows, 1, 0, 1);
}

// K6c: one block per (work item, slice of VC ≤ W·QP columns of B). Each
// slot is gathered by QP lanes, each covering W columns (a float4 when
// W = 4); a lane gathers consecutive slots, kLoads B rows in flight. Column
// v = 4k + c of the slice sits at ((c + rot(r)) % 4)·QP + k of tile row r
// (W = 4), so the lanes of one slot add into neighbouring banks and rows
// that share banks start at different ones.
constexpr int kLoads = 8;
constexpr int kWarps = kThreads / 32;

template <int W>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float4 load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ static float at(const float4& v, int c) {
    return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
  }
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static void fma(float4& acc, float a, const float4& b) {
    acc.x = fmaf(a, b.x, acc.x);
    acc.y = fmaf(a, b.y, acc.y);
    acc.z = fmaf(a, b.z, acc.z);
    acc.w = fmaf(a, b.w, acc.w);
  }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static float load(const float* p) { return __ldg(p); }
  __device__ static float at(const float& v, int) { return v; }
  __device__ static float zero() { return 0.f; }
  __device__ static void fma(float& acc, float a, float b) {
    acc = fmaf(a, b, acc);
  }
};

// bank rotation of tile row r's four column groups (W = 4): rows that
// share banks (r·VCM mod 32 equal) get different rotations
template <int VCM>
__device__ __forceinline__ int tile_rot(int r) {
  constexpr int shift = VCM >= 32 ? 0 : VCM == 16 ? 1 : VCM == 8 ? 2 : 3;
  return (r >> shift) & 3;
}

template <int W, int QP>
__device__ __forceinline__ void tile_add(float* tile, int r, int q,
                                         const typename Vec<W>::T& v) {
  constexpr int VCM = W * QP;
  float* row = tile + r * VCM + q;
  const int rot = tile_rot<VCM>(r);
#pragma unroll
  for (int c = 0; c < W; ++c)
    atomicAdd(row + ((c + rot) & (W - 1)) * QP, Vec<W>::at(v, c));
}

template <int W, int QP>
__global__ void __launch_bounds__(kThreads, W * QP >= 64 ? 3 : 4)
spmm_item_kernel(const float* __restrict__ vals,
                 const int* __restrict__ col_local,
                 const int* __restrict__ chunk_col_tile,
                 const int* __restrict__ perm_rows,
                 const int* __restrict__ row_local,
                 const int* __restrict__ chunk_row_tile,
                 const int* __restrict__ item_chunk0,
                 const int* __restrict__ item_split,
                 const float* __restrict__ B, float* __restrict__ Y, int E,
                 int C, int R, int V, int VC, int n_rows, int zero_row) {
  constexpr int VCM = W * QP;                  // tile columns
  // slots whose metadata a lane reads (≤ 4, to bound the registers)
  constexpr int M = QP >= kLoads ? 1 : kLoads / QP > 4 ? 4 : kLoads / QP;
  constexpr int S = 32 * M;                    // slots of a warp step
  constexpr int STEPS = M * QP;                // slots a lane gathers
  constexpr int G = STEPS < kLoads ? STEPS : kLoads;  // B rows in flight
  static_assert(STEPS % G == 0 && 512 % S == 0, "warp step geometry");
  using Vt = Vec<W>;
  extern __shared__ float tile[];              // [R, VCM]
  const int item = blockIdx.x;
  const int v0 = blockIdx.y * VC;
  const int vc = min(VC, V - v0);
  const int c0 = item_chunk0[item];
  const int c1 = item_chunk0[item + 1];
  for (int i = threadIdx.x; i < R * VCM; i += kThreads) tile[i] = 0.f;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int q = lane % QP;
  const int sub = lane / QP;
  const bool lane_on = q * W < vc;
  const int E8 = E >> 3;
  const long long s_end = static_cast<long long>(c1) * E;
  constexpr long long stride = static_cast<long long>(kWarps) * S;
  // the metadata of slots s0 + lane·M + m of a warp step arrives in two
  // rounds (the scatter row's gather row and the in-tile row, then the
  // value and column), each issued a step ahead, during the gathers
  int pr[M], rl[M];
  auto first_round = [&](long long s0) {
    if (s0 >= s_end) return;
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const long long slot = s0 + lane * M + m;
      pr[m] = perm_rows[slot >> 3];
      rl[m] = row_local[slot];
    }
  };
  float a[M], an[M];
  int col[M], row[M], coln[M], rown[M];
  auto second_round = [&](long long s0) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const long long slot = s0 + lane * M + m;
      an[m] = 0.f;
      coln[m] = 0;
      rown[m] = R;
      if (s0 < s_end && pr[m] < zero_row && rl[m] < R) {  // a real slot
        const long long g = static_cast<long long>(pr[m]) * 8 + (slot & 7);
        an[m] = vals[g];
        coln[m] = chunk_col_tile[pr[m] / E8] * C + col_local[g];
        rown[m] = rl[m];
      }
    }
  };
  long long s0 = static_cast<long long>(c0) * E + (threadIdx.x >> 5) * S;
  first_round(s0);
  second_round(s0);
  first_round(s0 + stride);
  for (; s0 < s_end; s0 += stride) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      a[m] = an[m];
      col[m] = coln[m];
      row[m] = rown[m];
    }
    second_round(s0 + stride);
    first_round(s0 + 2 * stride);
    // the lane gathers slots sub·STEPS + k of the step (held by lane
    // sub·QP + k / M, register k % M), kLoads B rows in flight
    int cur = R;
    typename Vt::T acc = Vt::zero();
#pragma unroll
    for (int k0 = 0; k0 < STEPS; k0 += G) {
      float av[G];
      int rv[G];
      typename Vt::T b[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int k = k0 + j;
        const int src = sub * QP + k / M;
        const int c = __shfl_sync(0xffffffffu, col[k % M], src);
        av[j] = __shfl_sync(0xffffffffu, a[k % M], src);
        rv[j] = __shfl_sync(0xffffffffu, row[k % M], src);
        b[j] = rv[j] < R && lane_on
                   ? Vt::load(B + static_cast<long long>(c) * V + v0 + q * W)
                   : Vt::zero();
      }
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (rv[j] != cur) {
          if (cur < R && lane_on) tile_add<W, QP>(tile, cur, q, acc);
          cur = rv[j];
          acc = Vt::zero();
        }
        Vt::fma(acc, av[j], b[j]);             // pads: 0 · 0
      }
    }
    if (cur < R && lane_on) tile_add<W, QP>(tile, cur, q, acc);
  }
  __syncthreads();
  // the whole row tile: plain stores, zeros included; a split one: atomics
  const long long row0 = static_cast<long long>(chunk_row_tile[c0]) * R;
  const bool split = item_split[item] != 0;
  for (int i = threadIdx.x; i < R * QP; i += kThreads) {
    const int r = i / QP;
    const int qq = i % QP;
    if (qq * W >= vc || row0 + r >= n_rows) continue;
    float* dst = Y + (row0 + r) * V + v0 + qq * W;
    const float* src = tile + r * VCM + qq;
    const int rot = tile_rot<VCM>(r);
    float v[W];
#pragma unroll
    for (int c = 0; c < W; ++c) v[c] = src[((c + rot) & (W - 1)) * QP];
    if (!split) {
      if constexpr (W == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      else
        *dst = v[0];
    } else {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (v[c] != 0.f) atomicAdd(dst + c, v[c]);
    }
  }
}

template <typename K>
int set_smem(K kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

template <int W, int QP>
int spmm_items_launch(const void* vals, const void* col_local,
                      const void* chunk_col_tile, const void* perm_rows,
                      const void* row_local, const void* chunk_row_tile,
                      const void* item_chunk0, const void* item_split,
                      const void* B, void* Y, int n_items, int E, int C,
                      int R, int V, int VC, int n_rows, int zero_row,
                      cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(R) * W * QP * 4;
  int e = set_smem(spmm_item_kernel<W, QP>, smem);
  if (e) return e;
  spmm_item_kernel<W, QP><<<dim3(n_items, (V + VC - 1) / VC), kThreads,
                            smem, stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(col_local),
      static_cast<const int*>(chunk_col_tile),
      static_cast<const int*>(perm_rows), static_cast<const int*>(row_local),
      static_cast<const int*>(chunk_row_tile),
      static_cast<const int*>(item_chunk0),
      static_cast<const int*>(item_split), static_cast<const float*>(B),
      static_cast<float*>(Y), E, C, R, V, VC, n_rows, zero_row);
  return static_cast<int>(cudaGetLastError());
}

int spmv_items_launch(const void* vals, const void* col_local,
                      const void* chunk_col_tile, const void* perm_rows,
                      const void* row_local, const void* chunk_row_tile,
                      const void* item_chunk0, const void* item_split,
                      const void* x, void* y, int n_items, int E, int C,
                      int R, int zero_row, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(R) * 4;
  int e = set_smem(spmv_item_kernel, smem);
  if (e) return e;
  spmv_item_kernel<<<n_items, kThreads, smem, stream>>>(
      static_cast<const float*>(vals), static_cast<const int*>(col_local),
      static_cast<const int*>(chunk_col_tile),
      static_cast<const int*>(perm_rows), static_cast<const int*>(row_local),
      static_cast<const int*>(chunk_row_tile),
      static_cast<const int*>(item_chunk0),
      static_cast<const int*>(item_split), static_cast<const float*>(x),
      static_cast<float*>(y), E, C, R, zero_row);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry points (loaded with ctypes). Layout arrays are int32 (vals f32)
// as sparse/tiled.py lays them out; x / B / y / Y are contiguous f32.
// Each returns cudaGetLastError() after its launch (0 = success), or
// cudaErrorInvalidValue for a geometry it has no instance of.

// K6a. vals, col_local [n_chunks·E]; chunk_col_tile [n_chunks]; perm_rows
// [m_chunks·E/8]; row_local [m_chunks·E]; chunk_row_tile [m_chunks];
// item_chunk0 [n_items + 1], item_split [n_items] (sparse/tiled.py:
// spmm_items); x [n_cols]; y [n_row_tiles·R], zeroed in the row tiles that
// no item holds whole; zero_row = n_chunks·E/8. vals, col_local and
// row_local 16-byte aligned, E % 512 == 0.
extern "C" int spmv_tiled_launch(const void* vals, const void* col_local,
                                 const void* chunk_col_tile,
                                 const void* perm_rows, const void* row_local,
                                 const void* chunk_row_tile,
                                 const void* item_chunk0,
                                 const void* item_split, const void* x,
                                 void* y, int n_items, int E, int C, int R,
                                 int zero_row, void* stream) {
  if (n_items <= 0) return 0;
  return spmv_items_launch(vals, col_local, chunk_col_tile, perm_rows,
                           row_local, chunk_row_tile, item_chunk0, item_split,
                           x, y, n_items, E, C, R, zero_row,
                           static_cast<cudaStream_t>(stream));
}

// K6b. vals, rowcol (row_local << 16 | col_local) [m_chunks·E], both
// 16-byte aligned; chunk_row_tile, chunk_col_tile [m_chunks]; x [n_cols];
// y [n_rows], zeroed.
extern "C" int spmv_pair_tiled_launch(const void* vals, const void* rowcol,
                                      const void* chunk_row_tile,
                                      const void* chunk_col_tile,
                                      const void* x, void* y, int m_chunks,
                                      int E, int C, int R, int n_rows,
                                      int n_cols, void* stream) {
  const size_t smem = static_cast<size_t>(C + R) * 4;
  int e = set_smem(spmv_pair_kernel, smem);
  if (e) return e;
  if (m_chunks > 0)
    spmv_pair_kernel<<<m_chunks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(rowcol),
        static_cast<const int*>(chunk_row_tile),
        static_cast<const int*>(chunk_col_tile),
        static_cast<const float*>(x), static_cast<float*>(y), E, C, R, n_rows,
        n_cols);
  return static_cast<int>(cudaGetLastError());
}

// K6c. As K6a with B [n_cols, V] and Y [n_rows, V] (rows of the row tiles
// that no item stores whole zeroed); item_chunk0 [n_items + 1],
// item_split [n_items]; W = 4 (B and Y 16-byte aligned, V % 4 == 0) or 1,
// QP a power of two, VC ≤ W·QP columns a block (shared memory R·W·QP·4).
extern "C" int spmm_tiled_launch(const void* vals, const void* col_local,
                                 const void* chunk_col_tile,
                                 const void* perm_rows, const void* row_local,
                                 const void* chunk_row_tile,
                                 const void* item_chunk0,
                                 const void* item_split, const void* B,
                                 void* Y, int n_items, int E, int C, int R,
                                 int V, int VC, int W, int QP, int n_rows,
                                 int zero_row, void* stream) {
  if (n_items <= 0 || V <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K6C_CASE(w, qp)                                                     \
  if (W == w && QP == qp)                                                   \
    return spmm_items_launch<w, qp>(vals, col_local, chunk_col_tile,        \
                                    perm_rows, row_local, chunk_row_tile,   \
                                    item_chunk0, item_split, B, Y, n_items, \
                                    E, C, R, V, VC, n_rows, zero_row, st);
  K6C_CASE(4, 1) K6C_CASE(4, 2) K6C_CASE(4, 4) K6C_CASE(4, 8)
  K6C_CASE(4, 16)
  K6C_CASE(1, 1) K6C_CASE(1, 2) K6C_CASE(1, 4) K6C_CASE(1, 8)
  K6C_CASE(1, 16) K6C_CASE(1, 32)
#undef K6C_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
