// Flash attention backward (sm_90a), float32, on the CUDA cores.
//
// The TPU package has no attention backward kernel: it trains by XLA's
// autodiff of flash_attention_ref (src/repro/kernels/ref.py), since
// jax.grad through flash_attention_pallas fails.  This file computes the
// same gradients for K1's forward (flash_attention.cu): dQ, dK and dV of
// GQA attention over q, do (b, s, nh, hd) and k, v (b, t, nkv, hd), with
// scores scaled by hd^-0.5, optional tanh softcap (the chain rule through
// cap * tanh(x / cap) multiplies dS by 1 - tanh^2), causal / sliding-window /
// full masks on dense left-aligned positions, and ragged s and t.  The kv
// head of query head h is h / (nh / nkv), so dK and dV of a kv head sum over
// its nh / nkv query heads.
//
// What bounds it on the card: operations.  At the training slice's shape
// (8, 512, 6, 64), causal, the five products (S recomputed, dP = dO V^T,
// dV = P^T dO, dK = dS^T Q, dQ = dS K) need 2.5x the forward's ~1.6 GFLOP
// against ~50 MB of q, k, v, o, do, dq, dk and dv.  This design is simple
// rather than fast: float32 FMA on the CUDA cores (the tensor cores in
// 3xTF32, as K1's forward uses them, are the next step).  Its products are
// register tiles fed from shared memory, every operand read as a float4, so
// one load feeds 4 k-steps of S and dP or 4 rows of dV, dK and dQ (read a
// float at a time, the shared-memory pipe held it at 0.45 ms).
// The design, FlashAttention-2's without atomics, so the result is
// deterministic:
//   * the forward writes each row's log-sum-exp in base 2 (lse), so P is
//     recomputed as 2^(x - lse) with x the scores times log2 e, exactly the
//     units of K1's softmax; no row max or sum is recomputed;
//   * a preprocess computes D = rowsum(dO * O) (one warp per row), so
//     dS = P * (dP - D);
//   * dK / dV: one block of 256 threads per (k tile, kv head, batch) keeps
//     K and V in shared memory and its dK and dV in registers, and loops
//     over the group's query heads and over the q tiles that see the k
//     tile (causal: rows >= k0; window: rows < k0 + tile + window - 1);
//     P and dS go to shared memory transposed, so the sums over q rows
//     read 4 rows per load;
//   * dQ: one block per (q tile, head, batch) keeps Q and dO in shared
//     memory and dQ in registers, and loops over the k tiles its rows see
//     (the forward's tile range); dS goes to shared memory row-major;
//   * a 16 x 16 thread grid: thread (ty, tx) holds q or k rows ty + 16 a
//     and, of the head dim, runs of kV columns kV tx + 16 kV j; every
//     shared row is padded to a multiple of 4 floats that is 4 banks
//     (hd 16: 20) from the next, so the float4 reads of 8 lanes (one
//     phase) fall in distinct banks; masked cells, ragged rows and ragged
//     columns give P = dS = 0 exactly.
// Shared memory per block (floats): dK/dV 4 (kB, hd + 4) tiles + 2 (kB,
// kB + 4) tiles; dQ 4 + 1.  kB = 64 rows for hd <= 64, 32 above: 105 KB at
// hd 64, 143 KB at hd 256; each launch opts in with cudaFuncSetAttribute.
// kB = 32 at hd 64 (more, lighter blocks) ran 25% slower on an H100.
// All pointers must be 16-byte aligned (the wrapper checks).
// On an H100 at (8, 512, 6, 64) causal (chip_smoke.py prints the time and
// the training step's profile): ~0.36 ms, dK/dV ~0.19 ms of it; each q or
// k tile's global loads wait between two barriers, with one or two blocks
// an SM to hide them.
//
// The entry returns cudaGetLastError() after its launches; the Python
// wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;               // threads along a tile's columns
constexpr int kTY = kThreads / kTX;   // threads along its rows
constexpr float kLog2e = 1.4426950408889634f;

enum MaskKind { kFull = 0, kCausal = 1, kWindow = 2 };

template <int HD>
struct Bwd {
  static constexpr int kB = HD <= 64 ? 64 : 32;  // rows of a q tile and of a k tile
  static constexpr int kS = HD + 4;              // shared row of a (kB, HD) tile
  static constexpr int kP = kB + 4;              // shared row of a (kB, kB) tile
  static constexpr int kR = kB / kTY;            // tile rows per thread
  static constexpr int kC = kB / kTX;            // (q, k) tile columns per thread
  static constexpr int kV = HD / kTX < 4 ? HD / kTX : 4;  // head-dim columns per load
  static constexpr int kJ = HD / (kTX * kV);     // loads per head-dim row
  static constexpr int kE = kV * kJ;             // head-dim columns per thread
  static constexpr size_t kKvBytes = sizeof(float) * (4 * kB * kS + 2 * kB * kP + 2 * kB);
  static constexpr size_t kQBytes = sizeof(float) * (4 * kB * kS + kB * kP + 2 * kB);
};

// First head-dim column of this thread's load j (kV columns from there).
template <int HD>
__device__ __forceinline__ int hd_col(int tx, int j) {
  return Bwd<HD>::kV * (tx + kTX * j);
}

// N consecutive floats (N = 1, 2, 4; 4 N-byte aligned) in one load.
template <int N>
__device__ __forceinline__ void ldv(float* dst, const float* src) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x, dst[1] = x.y, dst[2] = x.z, dst[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x, dst[1] = x.y;
  } else {
    dst[0] = src[0];
  }
}

// 2^x in one MUFU instruction, as the forward computes it.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Rows row0 .. row0 + kB of src (row r at src + r * row_stride) into a
// (kB, HD) shared tile of row stride kS, a float4 at a time; rows at or
// past limit are zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0,
                                          int limit, long long row_stride, int tid) {
  using C = Bwd<HD>;
  constexpr int kVecs = HD / 4;
  for (int idx = tid; idx < C::kB * kVecs; idx += kThreads) {
    const int r = idx / kVecs, c = 4 * (idx % kVecs);
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < limit)
      x = *reinterpret_cast<const float4*>(src + (long long)(row0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * C::kS + c) = x;
  }
}

// lse and D of the q tile's rows (0 past s).
template <int HD>
__device__ __forceinline__ void load_rows(float* lrow, float* drow, const float* __restrict__ lse,
                                          const float* __restrict__ delta, int q0, int s,
                                          int tid) {
  if (tid < Bwd<HD>::kB) {
    const int qi = q0 + tid;
    lrow[tid] = qi < s ? lse[qi] : 0.0f;
    drow[tid] = qi < s ? delta[qi] : 0.0f;
  }
}

// S = Q K^T and dP = dO V^T for this thread's cells of a (q tile, k tile):
// rows ty + kTY a, columns tx + kTX c; 4 k-steps per load.
template <int HD>
__device__ __forceinline__ void scores_dp(const float* qs, const float* dos, const float* ks,
                                          const float* vs, int ty, int tx,
                                          float (&sc)[Bwd<HD>::kR][Bwd<HD>::kC],
                                          float (&dp)[Bwd<HD>::kR][Bwd<HD>::kC]) {
  using C = Bwd<HD>;
#pragma unroll
  for (int a = 0; a < C::kR; ++a)
#pragma unroll
    for (int c = 0; c < C::kC; ++c) sc[a][c] = dp[a][c] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < HD; kk += 4) {
    float qa[C::kR][4], da[C::kR][4], kb[C::kC][4], vb[C::kC][4];
#pragma unroll
    for (int a = 0; a < C::kR; ++a) {
      ldv<4>(qa[a], qs + (ty + kTY * a) * C::kS + kk);
      ldv<4>(da[a], dos + (ty + kTY * a) * C::kS + kk);
    }
#pragma unroll
    for (int c = 0; c < C::kC; ++c) {
      ldv<4>(kb[c], ks + (tx + kTX * c) * C::kS + kk);
      ldv<4>(vb[c], vs + (tx + kTX * c) * C::kS + kk);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int a = 0; a < C::kR; ++a)
#pragma unroll
        for (int c = 0; c < C::kC; ++c) {
          sc[a][c] = fmaf(qa[a][u], kb[c][u], sc[a][c]);
          dp[a][c] = fmaf(da[a][u], vb[c][u], dp[a][c]);
        }
  }
}

// In place: sc becomes P = 2^(x - lse) and dp becomes dS = P (dP - D),
// times 1 - tanh^2 under a softcap.  x is computed as the forward computes
// it (scores times scale * log2 e, or softcap * log2 e * tanh(scores *
// scale / softcap)).  Masked cells and cells past s or t are exactly 0.
template <int HD>
__device__ __forceinline__ void probs_ds(float (&sc)[Bwd<HD>::kR][Bwd<HD>::kC],
                                         float (&dp)[Bwd<HD>::kR][Bwd<HD>::kC],
                                         const float* lrow, const float* drow, int q0, int k0,
                                         int s, int t, int ty, int tx, int mask, int window,
                                         float softcap, float scale) {
  using C = Bwd<HD>;
  const float scale_l2 = scale * kLog2e, softcap_l2 = softcap * kLog2e;
#pragma unroll
  for (int a = 0; a < C::kR; ++a) {
    const int il = ty + kTY * a, qi = q0 + il;
#pragma unroll
    for (int c = 0; c < C::kC; ++c) {
      const int kj = k0 + tx + kTX * c;
      bool ok = qi < s && kj < t;
      if (mask != kFull) {
        ok = ok && kj <= qi;
        if (mask == kWindow && window > 0) ok = ok && qi - kj < window;
      }
      float p = 0.0f, ds = 0.0f;
      if (ok) {
        float x, dcap = 1.0f;
        if (softcap > 0.0f) {
          const float th = tanhf(sc[a][c] * scale / softcap);
          x = softcap_l2 * th;
          dcap = 1.0f - th * th;
        } else {
          x = sc[a][c] * scale_l2;
        }
        p = exp2_approx(x - lrow[il]);
        ds = p * (dp[a][c] - drow[il]) * dcap;
      }
      sc[a][c] = p;
      dp[a][c] = ds;
    }
  }
}

// D = rowsum(dO * O): one warp per (b, i, h) row, written as (b, nh, s).
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, long long rows, int s, int nh, int hd) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // the whole warp shares the row
  const float* orow = o + row * hd;
  const float* drow = dout + row * hd;
  float acc = 0.0f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(orow[d], drow[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = static_cast<int>(row % nh);
    const long long bi = row / nh;  // b * s + i
    const long long b = bi / s;
    const int i = static_cast<int>(bi % s);
    delta[(b * nh + h) * s + i] = acc;
  }
}

// Two blocks an SM: ptxas then keeps hd 64 in 128 registers without
// spilling (168 uncapped, one block an SM, ran 4% slower on an H100).
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int s, int t, int nh,
                      int nkv, int mask, int window, float softcap, float scale) {
  using C = Bwd<HD>;
  constexpr int kB = C::kB, kS = C::kS, kP = C::kP;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;            // [kB][kS]
  float* vs = ks + kB * kS;    // [kB][kS]
  float* qs = vs + kB * kS;    // [kB][kS]
  float* dos = qs + kB * kS;   // [kB][kS]
  float* pt = dos + kB * kS;   // [kB k][kP]  P transposed
  float* dst = pt + kB * kP;   // [kB k][kP]  dS transposed
  float* lrow = dst + kB * kP; // [kB]
  float* drow = lrow + kB;     // [kB]

  const int k0 = blockIdx.x * kB, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int group = nh / nkv;
  const long long q_rs = (long long)nh * HD, kv_rs = (long long)nkv * HD;
  const long long kv_off = ((long long)b * t * nkv + kvh) * HD;

  load_tile<HD>(ks, k + kv_off, k0, t, kv_rs, tid);
  load_tile<HD>(vs, v + kv_off, k0, t, kv_rs, tid);

  float adk[C::kR][C::kE], adv[C::kR][C::kE];
#pragma unroll
  for (int a = 0; a < C::kR; ++a)
#pragma unroll
    for (int e = 0; e < C::kE; ++e) adk[a][e] = adv[a][e] = 0.0f;

  // Query rows that see a key of this tile: row qi sees kj <= qi (causal)
  // and qi - kj < window (window).
  int q_lo = 0, q_hi = s;
  if (mask != kFull) {
    q_lo = k0;
    if (mask == kWindow && window > 0) q_hi = min(s, k0 + kB - 1 + window);
  }
  const int q_first = q_lo / kB * kB;

  for (int hh = 0; hh < group; ++hh) {
    const int h = kvh * group + hh;
    const long long q_off = ((long long)b * s * nh + h) * HD;
    const long long row_off = ((long long)b * nh + h) * s;
    for (int q0 = q_first; q0 < q_hi; q0 += kB) {
      __syncthreads();  // the previous tile's readers are done; K and V have landed
      load_tile<HD>(qs, q + q_off, q0, s, q_rs, tid);
      load_tile<HD>(dos, dout + q_off, q0, s, q_rs, tid);
      load_rows<HD>(lrow, drow, lse + row_off, delta + row_off, q0, s, tid);
      __syncthreads();
      float sc[C::kR][C::kC], dp[C::kR][C::kC];
      scores_dp<HD>(qs, dos, ks, vs, ty, tx, sc, dp);
      probs_ds<HD>(sc, dp, lrow, drow, q0, k0, s, t, ty, tx, mask, window, softcap, scale);
#pragma unroll
      for (int a = 0; a < C::kR; ++a)
#pragma unroll
        for (int c = 0; c < C::kC; ++c) {
          pt[(tx + kTX * c) * kP + ty + kTY * a] = sc[a][c];
          dst[(tx + kTX * c) * kP + ty + kTY * a] = dp[a][c];
        }
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the tile's q rows, 4 at a time;
      // this thread holds k rows ty + kTY a.
#pragma unroll 2
      for (int i0 = 0; i0 < kB; i0 += 4) {
        float pa[C::kR][4], sa[C::kR][4];
#pragma unroll
        for (int a = 0; a < C::kR; ++a) {
          ldv<4>(pa[a], pt + (ty + kTY * a) * kP + i0);
          ldv<4>(sa[a], dst + (ty + kTY * a) * kP + i0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float ob[C::kE], qb[C::kE];
#pragma unroll
          for (int j = 0; j < C::kJ; ++j) {
            ldv<C::kV>(ob + C::kV * j, dos + (i0 + u) * kS + hd_col<HD>(tx, j));
            ldv<C::kV>(qb + C::kV * j, qs + (i0 + u) * kS + hd_col<HD>(tx, j));
          }
#pragma unroll
          for (int a = 0; a < C::kR; ++a)
#pragma unroll
            for (int e = 0; e < C::kE; ++e) {
              adv[a][e] = fmaf(pa[a][u], ob[e], adv[a][e]);
              adk[a][e] = fmaf(sa[a][u], qb[e], adk[a][e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < C::kR; ++a) {
    const int kj = k0 + ty + kTY * a;
    if (kj >= t) continue;
    float* dkr = dk + kv_off + (long long)kj * kv_rs;
    float* dvr = dv + kv_off + (long long)kj * kv_rs;
#pragma unroll
    for (int j = 0; j < C::kJ; ++j)
#pragma unroll
      for (int u = 0; u < C::kV; ++u) {
        dkr[hd_col<HD>(tx, j) + u] = adk[a][C::kV * j + u] * scale;
        dvr[hd_col<HD>(tx, j) + u] = adv[a][C::kV * j + u];
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int s, int t, int nh, int nkv, int mask, int window,
                    float softcap, float scale) {
  using C = Bwd<HD>;
  constexpr int kB = C::kB, kS = C::kS, kP = C::kP;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [kB][kS]
  float* dos = qs + kB * kS;   // [kB][kS]
  float* ks = dos + kB * kS;   // [kB][kS]
  float* vs = ks + kB * kS;    // [kB][kS]
  float* dss = vs + kB * kS;   // [kB q][kP]  dS
  float* lrow = dss + kB * kP; // [kB]
  float* drow = lrow + kB;     // [kB]

  const int q0 = blockIdx.x * kB, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const long long q_rs = (long long)nh * HD, kv_rs = (long long)nkv * HD;
  const long long q_off = ((long long)b * s * nh + h) * HD;
  const long long kv_off = ((long long)b * t * nkv + kvh) * HD;
  const long long row_off = ((long long)b * nh + h) * s;

  load_tile<HD>(qs, q + q_off, q0, s, q_rs, tid);
  load_tile<HD>(dos, dout + q_off, q0, s, q_rs, tid);
  load_rows<HD>(lrow, drow, lse + row_off, delta + row_off, q0, s, tid);

  float adq[C::kR][C::kE];
#pragma unroll
  for (int a = 0; a < C::kR; ++a)
#pragma unroll
    for (int e = 0; e < C::kE; ++e) adq[a][e] = 0.0f;

  // Keys this q tile sees (the forward's range).
  int k_lo = 0, k_hi = t;
  if (mask != kFull) {
    k_hi = min(t, q0 + kB);
    if (mask == kWindow && window > 0) k_lo = max(0, q0 - window + 1);
  }

  for (int k0 = k_lo / kB * kB; k0 < k_hi; k0 += kB) {
    __syncthreads();  // the previous tile's readers are done; Q and dO have landed
    load_tile<HD>(ks, k + kv_off, k0, t, kv_rs, tid);
    load_tile<HD>(vs, v + kv_off, k0, t, kv_rs, tid);
    __syncthreads();
    float sc[C::kR][C::kC], dp[C::kR][C::kC];
    scores_dp<HD>(qs, dos, ks, vs, ty, tx, sc, dp);
    probs_ds<HD>(sc, dp, lrow, drow, q0, k0, s, t, ty, tx, mask, window, softcap, scale);
#pragma unroll
    for (int a = 0; a < C::kR; ++a)
#pragma unroll
      for (int c = 0; c < C::kC; ++c) dss[(ty + kTY * a) * kP + tx + kTX * c] = dp[a][c];
    __syncthreads();
    // dQ += dS K over the tile's keys, 4 at a time; this thread holds q
    // rows ty + kTY a.
#pragma unroll 2
    for (int j0 = 0; j0 < kB; j0 += 4) {
      float sa[C::kR][4];
#pragma unroll
      for (int a = 0; a < C::kR; ++a) ldv<4>(sa[a], dss + (ty + kTY * a) * kP + j0);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float kb[C::kE];
#pragma unroll
        for (int j = 0; j < C::kJ; ++j)
          ldv<C::kV>(kb + C::kV * j, ks + (j0 + u) * kS + hd_col<HD>(tx, j));
#pragma unroll
        for (int a = 0; a < C::kR; ++a)
#pragma unroll
          for (int e = 0; e < C::kE; ++e) adq[a][e] = fmaf(sa[a][u], kb[e], adq[a][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < C::kR; ++a) {
    const int qi = q0 + ty + kTY * a;
    if (qi >= s) continue;
    float* dqr = dq + q_off + (long long)qi * q_rs;
#pragma unroll
    for (int j = 0; j < C::kJ; ++j)
#pragma unroll
      for (int u = 0; u < C::kV; ++u)
        dqr[hd_col<HD>(tx, j) + u] = adq[a][C::kV * j + u] * scale;
  }
}

template <int HD>
int launch_bwd(const float* q, const float* k, const float* v, const float* dout,
               const float* lse, const float* delta, float* dq, float* dk, float* dv, int b,
               int s, int t, int nh, int nkv, int mask, int window, float softcap, float scale,
               cudaStream_t st) {
  using C = Bwd<HD>;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)C::kKvBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kQBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_tiles = (t + C::kB - 1) / C::kB, q_tiles = (s + C::kB - 1) / C::kB;
  if (k_tiles > 0)
    flash_bwd_dkdv_kernel<HD><<<dim3(k_tiles, nkv, b), kThreads, C::kKvBytes, st>>>(
        q, k, v, dout, lse, delta, dk, dv, s, t, nh, nkv, mask, window, softcap, scale);
  if (q_tiles > 0)
    flash_bwd_dq_kernel<HD><<<dim3(q_tiles, nh, b), kThreads, C::kQBytes, st>>>(
        q, k, v, dout, lse, delta, dq, s, t, nh, nkv, mask, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// float32 only.  q, o, do, dq: (b, s, nh, hd); k, v, dk, dv: (b, t, nkv,
// hd); lse: the forward's (b, nh, s) base-2 log-sum-exp; delta: (b, nh, s)
// scratch for D.  All contiguous and 16-byte aligned.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* lse,
    const void* dout, void* dq, void* dk, void* dv, void* delta, int b, int s, int t, int nh,
    int nkv, int hd, int mask, int window, float softcap, float scale, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0) return 0;
  if (b > 65535 || nh > 65535 || nkv > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)b * s * nh;
  if (rows > 0) {
    const long long blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
    flash_bwd_delta_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout),
        static_cast<float*>(delta), rows, s, nh, hd);
  }
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* df = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* xf = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
#define REPRO_BWD_CASE(HD)                                                                   \
  case HD:                                                                                   \
    return launch_bwd<HD>(qf, kf, vf, df, lf, xf, dqf, dkf, dvf, b, s, t, nh, nkv, mask,     \
                          window, softcap, scale, st);
  switch (hd) {
    REPRO_BWD_CASE(16)
    REPRO_BWD_CASE(32)
    REPRO_BWD_CASE(64)
    REPRO_BWD_CASE(128)
    REPRO_BWD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_BWD_CASE
}
