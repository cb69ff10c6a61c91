// Unexpanded pairwise distances (K8) for Hopper (sm_90a), bound to Python
// through a plain C entry point.
//
// Replaces raft_tpu/ops/unexpanded_pallas.py:unexpanded_pairwise_tiled
// (:261, pallas_call at :241).
//
// What it computes. out[i, j] = finish(Σ_k term(x[i, k], y[j, k])) for
// x [n, d], y [m, d] row-major and one of ten metrics (enum Metric, in
// the order of raft_tpu_torch/ops/unexpanded.py:SUPPORTED): L1, Linf (a
// maximum, NaN-propagating like jnp.max), squared L2 and L2, Minkowski
// (|x − y|^p, then ^(1/p)), Canberra (a zero denominator gives 0),
// Hamming (divided by the true d), Bray–Curtis (Σ|x − y| / max(Σ|x + y|,
// 1e-30)), KL (a ≤ 0 → 0; b ≤ 0 < a → a·log 1) and Jensen–Shannon
// (sqrt(max(½·Σ, 0))). Templated on the accumulator type: f32, or f64 for
// f64 inputs.
//
// Precision. No fast math: logf, powf and sqrtf keep their documented
// ulp (1, 4 and 0) and the division is IEEE. Each thread sums its d
// terms in order (the compiler may contract a product and a sum into an
// fma), so against the twin, which sums chunks of 16, an entry differs by
// the summation error, within (d + 2)·2⁻²⁴·Σ_k |term_k|; Linf and Hamming
// are exact in any order.
//
// Bound on this card. These terms have no tensor-core form: each of the
// n·m·d terms costs FP32 instructions on the CUDA cores (L1: an FADD and
// an FADD with |·|; Linf an FADD and a NaN-propagating max; 132 SMs × 128
// lanes × 1.98 GHz ≈ 33.45·10¹² a second; a division's reciprocal runs on
// the SFU at an eighth of that), against (n + m)·d·4 bytes read and n·m·4
// written at 3.35 TB/s. At d ≥ 16 the instructions bound it.
//
// Design (the contraction substrate the reference names,
// cpp/include/raft/linalg/detail/contractions.cuh:313, not the Mosaic
// blocks). The TPU broadcast each x column through a bf16×3 one-hot MXU
// product into [256, 128] VMEM accumulators over a sequential d-chunk
// grid. Here one 256-thread block owns a 64 × 64 output tile and keeps a
// 4 × 4 register micro-tile per thread (two for Bray–Curtis). x and y
// tiles are staged through shared memory in chunks of 32 features,
// transposed so that a thread reads its 4 x and 4 y values as one 16-byte
// load each; the next chunk's global loads are in flight while the
// current one is folded. A warp loads 8 consecutive features of 4 rows
// (one 32-byte sector a row), which also makes the transposed stores free
// of bank conflicts. Loads are bounds-checked (no padding copies), the
// last chunk folds only the features that exist, and the metric is a
// template parameter: no branch on it in the inner loop. Output offsets
// are 64-bit (n·m reaches 2·10⁹).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Metric {
  kL1 = 0, kLinf, kL2, kL2Sqrt, kLp, kCanberra, kHamming, kBrayCurtis,
  kKL, kJS
};

constexpr int kBM = 64;                 // x rows per block
constexpr int kBN = 64;                 // y rows per block
constexpr int kDK = 32;                 // features per shared-memory chunk
constexpr int kLd = kBM + 4;            // tile row length (16-byte rows)
constexpr int kThreads = 256;           // 16 × 16 threads, 4 × 4 each

__device__ __forceinline__ float v_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double v_abs(double v) { return fabs(v); }
__device__ __forceinline__ float v_log(float v) { return logf(v); }
__device__ __forceinline__ double v_log(double v) { return log(v); }
__device__ __forceinline__ float v_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double v_pow(double a, double b) {
  return pow(a, b);
}
__device__ __forceinline__ float v_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double v_sqrt(double v) { return sqrt(v); }

// maxima that propagate NaN, as jnp.maximum does (fmaxf drops it)
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ double max_nan(double a, double b) {
  return (b > a || b != b) ? b : a;        // a NaN, once in a, stays
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const double* p, double v[4]) {
  const double2 a = *reinterpret_cast<const double2*>(p);
  const double2 b = *reinterpret_cast<const double2*>(p + 2);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(double* p, const double v[4]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  *reinterpret_cast<double2*>(p + 2) = make_double2(v[2], v[3]);
}

// the reference's _kl_term (the product is kept for a ≤ 0 < b too:
// inf·log 1 is NaN there as well)
template <typename T>
__device__ __forceinline__ T kl_term(T a, T b) {
  if (!(a > T(0))) return T(0);
  return a * v_log(b > T(0) ? a / b : T(1));
}

template <int M, typename T>
__device__ __forceinline__ void fold(T xv, T yv, T p, T& a, T& b) {
  const T diff = xv - yv;
  if constexpr (M == kL1) {
    a += v_abs(diff);
  } else if constexpr (M == kLinf) {
    a = max_nan(a, v_abs(diff));
  } else if constexpr (M == kL2 || M == kL2Sqrt) {
    a += diff * diff;
  } else if constexpr (M == kLp) {
    a += v_pow(v_abs(diff), p);
  } else if constexpr (M == kCanberra) {
    const T den = v_abs(xv) + v_abs(yv);
    a += (den == T(0)) ? T(0) : v_abs(diff) / den;
  } else if constexpr (M == kHamming) {
    a += (xv != yv) ? T(1) : T(0);
  } else if constexpr (M == kBrayCurtis) {
    a += v_abs(diff);
    b += v_abs(xv + yv);
  } else if constexpr (M == kKL) {
    a += kl_term(xv, yv);
  } else {
    const T mid = T(0.5) * (xv + yv);
    a += kl_term(xv, mid) + kl_term(yv, mid);
  }
}

// comparisons written so that a NaN passes through, as jnp.maximum does
template <int M, typename T>
__device__ __forceinline__ T finish(T a, T b, T inv_p, T d) {
  if constexpr (M == kL2Sqrt) {
    return v_sqrt(a);
  } else if constexpr (M == kLp) {
    return v_pow(a, inv_p);
  } else if constexpr (M == kHamming) {
    return a / d;
  } else if constexpr (M == kBrayCurtis) {
    return a / ((b < T(1e-30)) ? T(1e-30) : b);
  } else if constexpr (M == kJS) {
    const T h = T(0.5) * a;
    return v_sqrt(h < T(0) ? T(0) : h);
  } else {
    return a;
  }
}

template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
unexpanded_kernel(const T* __restrict__ x, const T* __restrict__ y,
                  T* __restrict__ out, long long n, long long m, int d,
                  T p, T inv_p) {
  __shared__ __align__(16) T xs[kDK][kLd];
  __shared__ __align__(16) T ys[kDK][kLd];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  // loader: load r of 8 takes row lr + 32·(r & 1), feature lk + 8·(r >> 1)
  const int lk = tid & 7, lr = tid >> 3;
  const long long col0 = static_cast<long long>(blockIdx.x) * kBN;
  const long long n_tiles = (n + kBM - 1) / kBM;
  const bool vec_out = (m % 4) == 0 && col0 + tx * 4 + 3 < m;

  for (long long bt = blockIdx.y; bt < n_tiles; bt += gridDim.y) {
    const long long row0 = bt * kBM;
    T acc[4][4], acc2[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = acc2[i][j] = T(0);

    T rx[8], ry[8];
    auto fetch = [&](int k0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int row = lr + 32 * (r & 1), k = k0 + lk + 8 * (r >> 1);
        const long long gi = row0 + row, gj = col0 + row;
        rx[r] = (gi < n && k < d) ? __ldg(&x[gi * d + k]) : T(0);
        ry[r] = (gj < m && k < d) ? __ldg(&y[gj * d + k]) : T(0);
      }
    };
    auto step = [&](int kk) {
      T xv[4], yv[4];
      load4(&xs[kk][ty * 4], xv);
      load4(&ys[kk][tx * 4], yv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          fold<M>(xv[i], yv[j], p, acc[i][j], acc2[i][j]);
    };

    fetch(0);
    for (int k0 = 0; k0 < d; k0 += kDK) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        xs[lk + 8 * (r >> 1)][lr + 32 * (r & 1)] = rx[r];
        ys[lk + 8 * (r >> 1)][lr + 32 * (r & 1)] = ry[r];
      }
      __syncthreads();
      if (k0 + kDK < d) fetch(k0 + kDK);    // in flight during the fold
      const int kn = d - k0 < kDK ? d - k0 : kDK;
      if (kn == kDK) {
#pragma unroll 8
        for (int kk = 0; kk < kDK; ++kk) step(kk);
      } else {
        for (int kk = 0; kk < kn; ++kk) step(kk);
      }
      __syncthreads();
    }

    const T td = static_cast<T>(d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + ty * 4 + i;
      if (row >= n) break;
      T v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = finish<M>(acc[i][j], acc2[i][j], inv_p, td);
      T* o = out + row * m + col0 + tx * 4;
      if (vec_out) {
        store4(o, v);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col0 + tx * 4 + j < m) o[j] = v[j];
      }
    }
  }
}

template <int M, typename T>
void run(dim3 grid, cudaStream_t s, const void* x, const void* y, void* out,
         long long n, long long m, int d, double p) {
  unexpanded_kernel<M, T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(y),
      static_cast<T*>(out), n, m, d, static_cast<T>(p),
      static_cast<T>(1.0 / p));
}

template <typename T>
int launch(const void* x, const void* y, void* out, long long n,
           long long m, int d, int metric, double p, cudaStream_t s) {
  const long long n_tiles = (n + kBM - 1) / kBM;
  const dim3 grid(static_cast<unsigned>((m + kBN - 1) / kBN),
                  static_cast<unsigned>(n_tiles < 65535 ? n_tiles : 65535));
  switch (metric) {
    case kL1: run<kL1, T>(grid, s, x, y, out, n, m, d, p); break;
    case kLinf: run<kLinf, T>(grid, s, x, y, out, n, m, d, p); break;
    case kL2: run<kL2, T>(grid, s, x, y, out, n, m, d, p); break;
    case kL2Sqrt: run<kL2Sqrt, T>(grid, s, x, y, out, n, m, d, p); break;
    case kLp: run<kLp, T>(grid, s, x, y, out, n, m, d, p); break;
    case kCanberra: run<kCanberra, T>(grid, s, x, y, out, n, m, d, p); break;
    case kHamming: run<kHamming, T>(grid, s, x, y, out, n, m, d, p); break;
    case kBrayCurtis:
      run<kBrayCurtis, T>(grid, s, x, y, out, n, m, d, p);
      break;
    case kKL: run<kKL, T>(grid, s, x, y, out, n, m, d, p); break;
    case kJS: run<kJS, T>(grid, s, x, y, out, n, m, d, p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry point (loaded with ctypes). x [n, d] and y [m, d] contiguous,
// f32 (f64 = 0) or f64 (f64 = 1); out [n, m] of the same type, every
// entry written once. n, m ≥ 1 and d ≥ 1 (the wrapper answers the empty
// cases itself); metric is an enum Metric code; p the Minkowski exponent.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int unexpanded_launch(const void* x, const void* y, void* out,
                                 long long n, long long m, int d, int metric,
                                 double p, int f64, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f64) return launch<double>(x, y, out, n, m, d, metric, p, s);
  return launch<float>(x, y, out, n, m, d, metric, p, s);
}
