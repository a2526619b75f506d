// The routed MoE's row sums on Hopper (sm_90a), bfloat16 and float32: the
// combine and the dispatch's backward beside K5 (grouped_gemm.cu).
//
// Replaces no TPU kernel: the JAX package combines with an einsum over its
// dense (E, b, s, d) buffers (src/repro/models/moe.py, apply_moe).  The
// port keeps the b s k routed rows sorted by expert (models/moe.py), and a
// token's k rows lie wherever their experts put them: inv[t k + j] is the
// sorted position of token t's j-th (token, expert) pair.
//   rows_sum      y[t] = sum_j w[t, j] src[inv[t k + j]], w the float32
//                 gates (the combine) or 1 (the gradient of the dispatch's
//                 gather: a token's row feeds k sorted rows)
//   combine_bwd   for each (t, j), p = inv[t k + j]: dsrc[p] = w[t, j] dy[t]
//                 and dw[t, j] = <src[p], dy[t]>
// Each sum runs in float32 in the fixed order j = 0 .. k-1 and rounds once;
// each sorted row is written by one block (inv is a permutation): no
// atomics, so every call is bit-reproducible.
//
// What bounds them: bytes.  At granite's train-4k layer (32,768 tokens,
// top-8, d 1,024, bf16) rows_sum reads 512 MB of rows and writes 64 MB,
// ~0.17 ms at 3.35 TB/s; combine_bwd reads 512 MB and 64 MB and writes
// 512 MB, ~0.32 ms.  The plain PyTorch versions (kernels/ref.py) move the
// rows three to five times more, in float32.
//
// The design: one block of 128 threads a token; each thread owns 16-byte
// chunks of the row (8 bf16 or 4 float32 values) and keeps its float32 sums
// in registers; combine_bwd reduces each j's dot product over the block
// with warp shuffles and shared memory, in a fixed order.  Rows of any
// width that divides into 16-byte chunks; k at most kMaxK.
//
// The entries return cudaGetLastError() after their launch; the Python
// wrappers (kernels/grouped_gemm.py) raise if it is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128, kMaxK = 16, kMaxChunks = 8;  // rows up to 8 x 128 x 16 B

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // values a 16-byte chunk
  __device__ static void load(const T* p, float (&x)[kN]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    if constexpr (std::is_same<T, float>::value) {
      const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int i = 0; i < kN; ++i) x[i] = f[i];
    } else {
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const float2 v = __bfloat1622float2(h[i]);
        x[2 * i] = v.x;
        x[2 * i + 1] = v.y;
      }
    }
  }
  __device__ static void store(T* p, const float (&x)[kN]) {
    uint4 raw;
    if constexpr (std::is_same<T, float>::value) {
      float* f = reinterpret_cast<float*>(&raw);
#pragma unroll
      for (int i = 0; i < kN; ++i) f[i] = x[i];
    } else {
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rows_sum(const T* __restrict__ src, const long long* __restrict__ inv,
             const float* __restrict__ w, T* __restrict__ dst, int k, int d) {
  using V = Vec<T>;
  const long long t = blockIdx.x;
  const int chunks = d / V::kN;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    float acc[V::kN] = {};
    for (int j = 0; j < k; ++j) {
      const long long p = inv[t * k + j];
      const float wj = w == nullptr ? 1.0f : w[t * k + j];
      float x[V::kN];
      V::load(src + p * d + c * V::kN, x);
#pragma unroll
      for (int i = 0; i < V::kN; ++i) acc[i] = fmaf(wj, x[i], acc[i]);
    }
    V::store(dst + t * d + c * V::kN, acc);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    combine_bwd(const T* __restrict__ src, const T* __restrict__ dy,
                const long long* __restrict__ inv, const float* __restrict__ w,
                T* __restrict__ dsrc, float* __restrict__ dw, int k, int d) {
  using V = Vec<T>;
  __shared__ float part[kThreads / 32][kMaxK];
  const long long t = blockIdx.x;
  const int chunks = d / V::kN, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float g[kMaxChunks][V::kN];  // this thread's chunks of dy[t]
#pragma unroll
  for (int q = 0; q < kMaxChunks; ++q) {
    const int c = threadIdx.x + q * kThreads;
    if (c < chunks) V::load(dy + t * d + c * V::kN, g[q]);
  }
  for (int j = 0; j < k; ++j) {
    const long long p = inv[t * k + j];
    const float wj = w[t * k + j];
    float dot = 0.0f;
#pragma unroll
    for (int q = 0; q < kMaxChunks; ++q) {
      const int c = threadIdx.x + q * kThreads;
      if (c >= chunks) break;
      float x[V::kN], out[V::kN];
      V::load(src + p * d + c * V::kN, x);
#pragma unroll
      for (int i = 0; i < V::kN; ++i) {
        dot = fmaf(x[i], g[q][i], dot);
        out[i] = wj * g[q][i];
      }
      V::store(dsrc + p * d + c * V::kN, out);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) part[warp][j] = dot;
  }
  __syncthreads();
  if (threadIdx.x < k) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i) s += part[i][threadIdx.x];
    dw[t * k + threadIdx.x] = s;
  }
}

bool shape_ok(long long tokens, int k, int d, int elem) {
  return tokens > 0 && tokens <= 2147483647LL && k >= 1 && k <= kMaxK && d > 0 &&
         (d * elem) % 16 == 0 && d / (16 / elem) <= kMaxChunks * kThreads;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (src, dst, dy, dsrc); w and dw float32; inv
// int64 (tokens x k sorted positions).  w may be null in rows_sum (weight 1).
extern "C" int repro_moe_rows_sum(const void* src, const void* inv, const void* w, void* dst,
                                  long long tokens, int k, int d, int dtype, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !shape_ok(tokens, k, d, elem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* iv = static_cast<const long long*>(inv);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0)
    rows_sum<float><<<(unsigned)tokens, kThreads, 0, st>>>(
        static_cast<const float*>(src), iv, wf, static_cast<float*>(dst), k, d);
  else
    rows_sum<__nv_bfloat16><<<(unsigned)tokens, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(src), iv, wf, static_cast<__nv_bfloat16*>(dst), k, d);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_moe_combine_bwd(const void* src, const void* dy, const void* inv,
                                     const void* w, void* dsrc, void* dw, long long tokens, int k,
                                     int d, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int elem = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || !shape_ok(tokens, k, d, elem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* iv = static_cast<const long long*>(inv);
  const float* wf = static_cast<const float*>(w);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 0)
    combine_bwd<float><<<(unsigned)tokens, kThreads, 0, st>>>(
        static_cast<const float*>(src), static_cast<const float*>(dy), iv, wf,
        static_cast<float*>(dsrc), dwf, k, d);
  else
    combine_bwd<__nv_bfloat16><<<(unsigned)tokens, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(src), static_cast<const __nv_bfloat16*>(dy), iv, wf,
        static_cast<__nv_bfloat16*>(dsrc), dwf, k, d);
  return static_cast<int>(cudaGetLastError());
}
