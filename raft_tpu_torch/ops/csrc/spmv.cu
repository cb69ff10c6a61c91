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
// to run (shared-memory and global atomics): |Δy_i| ≤ (nnz_i + 2)·2⁻²⁴·
// Σ_j |a_ij·x_j| against an exact sum (nnz_i + 1 additions, one product).
//
// Bound on this card. Each nonzero costs 2·V flops and at least 8 bytes
// (value + column id), and x/B and y/Y move V·(n_cols + n_rows)·4 bytes:
// bound by memory at every V up to 512 on graphs of ~33 nonzeros a row.
// The least traffic is the CSR form's (nnz·8 + (n_rows + 1)·4 bytes plus
// x and y); the tiled layout reads ~12.5 bytes a slot and pads nnz to
// 1.1–1.8× as many slots on R-MAT graphs of scale 16 to 22.
//
// Design (simple first). The TPU ran a gather kernel, an XLA row gather
// (perm_rows) and a scatter kernel because it has no gather; here one
// block owns one scatter chunk of E slots and does all three: each thread
// walks slots s = t, t + 256, ..., finds its gather slot through
// perm_rows, multiplies by x read from global memory (x is L2-resident:
// 16 MB at 4M columns) and adds into an R-float y tile in shared memory
// with shared-memory atomics. The tile then reaches y once per block with
// global atomics (a row tile's chunks are in different blocks), so the
// caller passes y zeroed and row tiles with no chunk stay 0. No
// contribution array goes through device memory. K6c stages the chunk's
// (column, value, row) triples in shared memory first and then walks
// (slot, column) pairs, so the V columns of a slot are neighbouring
// threads and B's rows are read coalesced; its [R, VC] accumulator tile
// covers VC ≤ V columns per block (grid.y = ⌈V / VC⌉).

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

// K6a: one block per scatter chunk.
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const float* __restrict__ vals,
                const int* __restrict__ col_local,
                const int* __restrict__ chunk_col_tile,
                const int* __restrict__ perm_rows,
                const int* __restrict__ row_local,
                const int* __restrict__ chunk_row_tile,
                const float* __restrict__ x, float* __restrict__ y, int E,
                int C, int R, int n_rows, int zero_row) {
  extern __shared__ float ytile[];
  const int c = blockIdx.x;
  for (int r = threadIdx.x; r < R; r += blockDim.x) ytile[r] = 0.f;
  __syncthreads();
  const long long base = static_cast<long long>(c) * E;
  for (int s = threadIdx.x; s < E; s += blockDim.x) {
    const int rl = row_local[base + s];
    if (rl >= R) continue;                       // pad slot
    const int pr = perm_rows[(base + s) >> 3];
    if (pr >= zero_row) continue;                // pad row (never real)
    const long long g = static_cast<long long>(pr) * 8 + (s & 7);
    const long long col =
        static_cast<long long>(chunk_col_tile[g / E]) * C + col_local[g];
    atomicAdd(&ytile[rl], vals[g] * __ldg(&x[col]));
  }
  __syncthreads();
  flush_tile(ytile, y, static_cast<long long>(chunk_row_tile[c]) * R, R,
             n_rows, 1, 0, 1);
}

// K6b: one block per chunk of a pair-tiled operand; x tile and y tile in
// shared memory.
__global__ void __launch_bounds__(kThreads)
spmv_pair_kernel(const float* __restrict__ vals,
                 const int* __restrict__ row_local,
                 const int* __restrict__ col_local,
                 const int* __restrict__ chunk_row_tile,
                 const int* __restrict__ chunk_col_tile,
                 const float* __restrict__ x, float* __restrict__ y, int E,
                 int C, int R, int n_rows, int n_cols) {
  extern __shared__ float sm[];
  float* xt = sm;
  float* ytile = sm + C;
  const int c = blockIdx.x;
  const long long col0 = static_cast<long long>(chunk_col_tile[c]) * C;
  for (int j = threadIdx.x; j < C; j += blockDim.x)
    xt[j] = col0 + j < n_cols ? x[col0 + j] : 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) ytile[r] = 0.f;
  __syncthreads();
  const long long base = static_cast<long long>(c) * E;
  for (int s = threadIdx.x; s < E; s += blockDim.x) {
    const int rl = row_local[base + s];
    if (rl >= R) continue;
    atomicAdd(&ytile[rl], vals[base + s] * xt[col_local[base + s]]);
  }
  __syncthreads();
  flush_tile(ytile, y, static_cast<long long>(chunk_row_tile[c]) * R, R,
             n_rows, 1, 0, 1);
}

// K6c: one block per (scatter chunk, slice of VC columns of B).
__global__ void __launch_bounds__(kThreads)
spmm_ell_kernel(const float* __restrict__ vals,
                const int* __restrict__ col_local,
                const int* __restrict__ chunk_col_tile,
                const int* __restrict__ perm_rows,
                const int* __restrict__ row_local,
                const int* __restrict__ chunk_row_tile,
                const float* __restrict__ B, float* __restrict__ Y, int E,
                int C, int R, int V, int VC, int n_rows, int zero_row) {
  extern __shared__ float sm[];
  float* ytile = sm;                                       // [R, VC]
  int* scol = reinterpret_cast<int*>(sm + R * VC);         // [E]
  float* sval = sm + R * VC + E;                           // [E]
  int* srow = reinterpret_cast<int*>(sm + R * VC + 2 * E);  // [E]
  const int c = blockIdx.x;
  const int v0 = blockIdx.y * VC;
  const int vc = min(VC, V - v0);
  for (int i = threadIdx.x; i < R * vc; i += blockDim.x) ytile[i] = 0.f;
  const long long base = static_cast<long long>(c) * E;
  for (int s = threadIdx.x; s < E; s += blockDim.x) {
    const int rl = row_local[base + s];
    const int pr = rl < R ? perm_rows[(base + s) >> 3] : zero_row;
    int col = -1;
    float val = 0.f;
    if (pr < zero_row) {
      const long long g = static_cast<long long>(pr) * 8 + (s & 7);
      col = chunk_col_tile[g / E] * C + col_local[g];
      val = vals[g];
    }
    scol[s] = col;
    sval[s] = val;
    srow[s] = rl;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < E * vc; i += blockDim.x) {
    const int s = i / vc;
    const int v = i - s * vc;
    const int col = scol[s];
    if (col < 0) continue;
    const float b = __ldg(&B[static_cast<long long>(col) * V + v0 + v]);
    atomicAdd(&ytile[srow[s] * vc + v], sval[s] * b);
  }
  __syncthreads();
  flush_tile(ytile, Y, static_cast<long long>(chunk_row_tile[c]) * R, R,
             n_rows, V, v0, vc);
}

template <typename K>
int set_smem(K kern, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

// C entry points (loaded with ctypes). Layout arrays are int32 (vals f32)
// as sparse/tiled.py lays them out; x / B / y / Y are contiguous f32 and
// y / Y arrive zeroed. Each returns cudaGetLastError() after its launch
// (0 = success).

// K6a. vals, col_local [n_chunks·E]; chunk_col_tile [n_chunks]; perm_rows
// [m_chunks·E/8]; row_local [m_chunks·E]; chunk_row_tile [m_chunks];
// x [n_cols]; y [n_rows]; zero_row = n_chunks·E/8.
extern "C" int spmv_tiled_launch(const void* vals, const void* col_local,
                                 const void* chunk_col_tile,
                                 const void* perm_rows, const void* row_local,
                                 const void* chunk_row_tile, const void* x,
                                 void* y, int m_chunks, int E, int C, int R,
                                 int n_rows, int zero_row, void* stream) {
  const size_t smem = static_cast<size_t>(R) * 4;
  int e = set_smem(spmv_ell_kernel, smem);
  if (e) return e;
  if (m_chunks > 0)
    spmv_ell_kernel<<<m_chunks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(col_local),
        static_cast<const int*>(chunk_col_tile),
        static_cast<const int*>(perm_rows),
        static_cast<const int*>(row_local),
        static_cast<const int*>(chunk_row_tile),
        static_cast<const float*>(x), static_cast<float*>(y), E, C, R, n_rows,
        zero_row);
  return static_cast<int>(cudaGetLastError());
}

// K6b. vals, row_local, col_local [m_chunks·E]; chunk_row_tile,
// chunk_col_tile [m_chunks]; x [n_cols]; y [n_rows].
extern "C" int spmv_pair_tiled_launch(const void* vals, const void* row_local,
                                      const void* col_local,
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
        static_cast<const float*>(vals), static_cast<const int*>(row_local),
        static_cast<const int*>(col_local),
        static_cast<const int*>(chunk_row_tile),
        static_cast<const int*>(chunk_col_tile),
        static_cast<const float*>(x), static_cast<float*>(y), E, C, R, n_rows,
        n_cols);
  return static_cast<int>(cudaGetLastError());
}

// K6c. As K6a with B [n_cols, V] and Y [n_rows, V]; VC columns per block
// (shared memory R·VC·4 + 12·E bytes).
extern "C" int spmm_tiled_launch(const void* vals, const void* col_local,
                                 const void* chunk_col_tile,
                                 const void* perm_rows, const void* row_local,
                                 const void* chunk_row_tile, const void* B,
                                 void* Y, int m_chunks, int E, int C, int R,
                                 int V, int VC, int n_rows, int zero_row,
                                 void* stream) {
  const size_t smem = (static_cast<size_t>(R) * VC + 3 * E) * 4;
  int e = set_smem(spmm_ell_kernel, smem);
  if (e) return e;
  if (m_chunks > 0 && V > 0)
    spmm_ell_kernel<<<dim3(m_chunks, (V + VC - 1) / VC), kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(vals), static_cast<const int*>(col_local),
        static_cast<const int*>(chunk_col_tile),
        static_cast<const int*>(perm_rows),
        static_cast<const int*>(row_local),
        static_cast<const int*>(chunk_row_tile),
        static_cast<const float*>(B), static_cast<float*>(Y), E, C, R, V, VC,
        n_rows, zero_row);
  return static_cast<int>(cudaGetLastError());
}
