// Flash attention forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_attention_pallas (_attn_kernel) in
// src/repro/kernels/flash_attention.py: GQA attention over q (b, s, nh, hd)
// and k, v (b, t, nkv, hd), scores scaled by hd^-0.5, optional tanh softcap,
// causal / sliding-window / full masks on dense left-aligned positions
// (masked scores are NEG_INF = -2e38, as in the reference), online softmax
// with float32 (m, l, acc) carries, output acc / max(l, 1e-30).
//
// What bounds it on the card: operations.  At the serving slice's shape
// (8, 512, 6, 64), causal, the two products need ~1.6 GFLOP against ~25 MB
// of q, k, v and o; in float32 outside the tensor cores (TF32 cannot meet
// the 2e-6 parity tolerance) the FMA pipes are the limit.  The design:
//   * one thread block per (q tile of 64 rows, head, batch); 256 threads;
//     the TPU's sequential kv grid axis becomes a loop inside the block;
//   * k and v tiles of 64 rows are staged in shared memory, once per block,
//     and read by all 64 query rows;
//   * each thread owns a 4 x 4 patch of the 64 x 64 score tile (rows
//     ty + 16i, columns tx + 16j) and a 4 x hd/16 patch of the output,
//     so scores, probabilities' row statistics and the accumulator stay in
//     registers; the 16 lanes that share a row reduce max and sum with
//     warp shuffles;
//   * rows of q and k in shared memory are padded by one float so the
//     lanes of a warp hit distinct banks;
//   * causal and window masks skip k tiles that lie wholly outside every
//     row's range (this only drops terms that are exactly 0);
//   * ragged tails are masked: q rows past s are not written, k rows past t
//     contribute exactly 0.  No shape has to divide a tile.
// The kv head of query head h is h / (nh / nkv).  Shared memory exceeds the
// 48 KB default for hd >= 32, so each launch opts in with
// cudaFuncSetAttribute.  wgmma / TMA / warp specialisation are later work.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // key rows per k tile
constexpr int kThreads = 256;  // 16 x 16 thread grid over the score tile
constexpr float kNegInf = -2.0e38f;

enum MaskKind { kFull = 0, kCausal = 1, kWindow = 2 };

template <int HD>
struct Tile {
  static constexpr int kQStride = HD + 1;
  static constexpr int kKStride = HD + 1;
  static constexpr int kVStride = HD;
  static constexpr int kPStride = kBk + 1;
  static constexpr int kFloats =
      kBq * kQStride + kBk * kKStride + kBk * kVStride + kBq * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int s, int t, int nh, int nkv, int mask, int window,
                     float softcap, float scale) {
  using T = Tile<HD>;
  constexpr int kCols = HD / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBq * T::kQStride;
  float* vs = ks + kBk * T::kKStride;
  float* ps = vs + kBk * T::kVStride;

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  for (int idx = tid; idx < kBq * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD, qi = q0 + r;
    qs[r * T::kQStride + c] =
        qi < s ? q[(((long long)b * s + qi) * nh + h) * HD + c] : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  // Keys this q tile can see.  Row qi sees kj <= qi (causal) and
  // qi - kj < window (window); tiles outside [k_lo, k_hi) hold only masked
  // keys, whose probability is exactly 0 once a row has a finite max.
  int k_lo = 0, k_hi = t;
  if (mask != kFull) {
    k_hi = min(t, q0 + kBq);
    if (mask == kWindow && window > 0) k_lo = max(0, q0 - window + 1);
  }

  for (int k0 = (k_lo / kBk) * kBk; k0 < k_hi; k0 += kBk) {
    __syncthreads();  // q tile stored / previous k tile fully consumed
    for (int idx = tid; idx < kBk * HD; idx += kThreads) {
      const int r = idx / HD, c = idx % HD, kj = k0 + r;
      const long long g = (((long long)b * t + kj) * nkv + kvh) * HD + c;
      ks[r * T::kKStride + c] = kj < t ? k[g] : 0.0f;
      vs[r * T::kVStride + c] = kj < t ? v[g] : 0.0f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * T::kQStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * T::kKStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = sc[i][j] * scale;
        if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
        if (kj >= t) {
          x = -INFINITY;  // ragged tail: not a key at all
        } else if (mask != kFull) {
          bool ok = kj <= qi;
          if (mask == kWindow && window > 0) ok = ok && (qi - kj) < window;
          if (!ok) x = kNegInf;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        ps[(ty + 16 * i) * T::kPStride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float vv[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) vv[cc] = vs[c * T::kVStride + tx + 16 * cc];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * T::kPStride + c];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) acc[i][cc] = fmaf(p, vv[cc], acc[i][cc]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* dst = o + (((long long)b * s + qi) * nh + h) * HD;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[tx + 16 * c] = acc[i][c] / den;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int b, int s,
           int t, int nh, int nkv, int mask, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t bytes = Tile<HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBq - 1) / kBq, nh, b);
  flash_fwd_f32_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, s, t, nh, nkv, mask, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_flash_attention_fwd_f32(
    const void* q, const void* k, const void* v, void* o, int b, int s, int t,
    int nh, int nkv, int hd, int mask, int window, float softcap, float scale,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || s == 0) return 0;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch<16>(qf, kf, vf, of, b, s, t, nh, nkv, mask, window, softcap, scale, st);
    case 32: return launch<32>(qf, kf, vf, of, b, s, t, nh, nkv, mask, window, softcap, scale, st);
    case 64: return launch<64>(qf, kf, vf, of, b, s, t, nh, nkv, mask, window, softcap, scale, st);
    case 128: return launch<128>(qf, kf, vf, of, b, s, t, nh, nkv, mask, window, softcap, scale, st);
    case 256: return launch<256>(qf, kf, vf, of, b, s, t, nh, nkv, mask, window, softcap, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
