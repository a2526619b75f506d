// Flash attention forward on Hopper's tensor cores (sm_90a), float32 and
// bfloat16.
//
// Replaces the TPU kernel flash_attention_pallas (_attn_kernel) in
// src/repro/kernels/flash_attention.py: GQA attention over q (b, s, nh, hd)
// and k, v (b, t, nkv, hd), scores scaled by hd^-0.5, optional tanh softcap
// before masking, causal / sliding-window / full masks on dense
// left-aligned positions (masked scores are NEG_INF = -2e38, as in the
// reference), online softmax with float32 (m, l, acc) carries, output
// acc / max(l, 1e-30) in the input's type.  The kv head of query head h is
// h / (nh / nkv).  For training, the kernel also writes each row's
// log-sum-exp (base 2, see the entry below), which the backward reads.
//
// What bounds it on the card: operations.  At the serving slice's shape
// (8, 512, 6, 64), causal, the two products need ~1.6 GFLOP against ~25 MB
// of q, k, v and o (float32).  Both products run on the tensor cores with
// mma.sync:
//   * float32: m16n8k8 TF32 with a 3xTF32 split.  Each operand x becomes
//     hi = tf32(x) and lo = tf32(x - hi), rounded as cvt.rna.tf32.f32
//     rounds but in two full-rate integer operations (the conversion
//     instruction was slower); a product is lo*hi + hi*lo + hi*hi
//     (small terms first), accumulated in float32, which carries about
//     2^-22 relative error per product: float32-class accuracy
//     (tests/test_torch_tf32_split.py emulates it against the plain
//     version at 2e-6; single TF32 misses by ~500x).  Three TF32 products
//     cost 3 x 1.6 GFLOP at 495 TFLOP/s.  The kernel splits its operands
//     itself and never depends on torch's allow_tf32 switches.  The tensor
//     cores truncate as they accumulate, so each k tile's P.V goes into a
//     fresh accumulator (kPvGroup output n-tiles at a time) and is added
//     to O in float32: the drift no longer grows with the sequence;
//   * bfloat16: m16n8k16 BF16 with float32 accumulation; p is rounded to
//     bf16 before P.V, as the plain version rounds probs to q's dtype.
// mma.sync rather than wgmma/TMA: it needs no descriptors or warpgroup
// fences, works on register-held fragments of any tile (the 3xTF32 split
// happens in registers), and with 64-row tiles of small heads (hd 64) the
// per-warp 16 x 8 shape wastes nothing.  On an H100 at the slice's shape
// the float32 kernel reaches ~18% of the 3xTF32 bound (chip_smoke.py): the
// splits and the legacy mma path cost issue slots, so wgmma with split
// operands staged in shared memory is the next step.
// The design, FlashAttention-2 style:
//   * one block of 4 warps per (q tile of 64 rows, head, batch); each warp
//     owns 16 query rows: its row statistics (m, l) and its O accumulator
//     stay in registers (the TPU's sequential kv grid axis becomes a loop
//     inside the block);
//   * the q tile sits on gridDim.z and is reversed, so the heaviest causal
//     tiles (most keys) are dispatched first across every head and batch;
//   * k / v tiles of kBk rows are copied global -> shared with cp.async
//     (16 B per thread), double-buffered: tile j+1 loads while tile j
//     computes.  Rows are padded by 16 B, so ldmatrix (8 rows of 16 B) and
//     the scalar V loads below hit 32 distinct banks;
//   * S = Q.K^T: Q fragments via ldmatrix (kept in registers, split once
//     per block, where they fit: float32 hd <= 64, bf16 hd <= 128;
//     otherwise reloaded from shared memory per k-step), K fragments via
//     ldmatrix for two n-tiles at a time.  float32 issues the three TF32
//     products term by term over four n-tiles, so consecutive mmas feed
//     different accumulators instead of waiting on each other;
//   * softmax in base 2: scores times scale * log2 e in one multiply, then
//     2^x in one ex2.approx instruction;
//   * O += P.V, float32: the S accumulator holds columns 2t, 2t+1 of each
//     row pair while an m16n8k8 A fragment wants columns t, t+4.  Instead
//     of moving P between lanes, the mma's k index is relabelled: A's
//     column t is key 2t and column t+4 is key 2t+1, and the B fragment
//     loads V rows 2t and 2t+1 to match (scalar loads, conflict-free with
//     the padding).  bf16: the S accumulator of two n-tiles is exactly the
//     m16n8k16 A fragment; V fragments via ldmatrix.trans;
//   * causal and window masks skip k tiles that lie wholly outside every
//     row's range (this only drops terms that are exactly 0) and mask per
//     element only in tiles that straddle an edge; q rows past s are not
//     written, k rows past t are zero-filled by cp.async and score -inf,
//     so they contribute exactly 0.  No shape has to divide a tile.
//
// Tiles, shared memory and registers per instantiation (ptxas -v, sm_90a,
// CUDA 12.8; chip_smoke.py prints them on every build):
//   type  hd   kBk  Q in   smem      registers  spills (stores / loads)
//   f32   16   64   regs    25.6 KB  128        0
//   f32   32   64   regs    46.1 KB  167        0
//   f32   64   64   regs    87.0 KB  240        0
//   f32   128  32   smem   101.4 KB  246        0
//   f32   256  32   smem   199.7 KB  255        4 B / 12 B
//   bf16  16   64   regs    15.4 KB   96        0
//   bf16  32   64   regs    25.6 KB  111        0
//   bf16  64   64   regs    46.1 KB  142        0
//   bf16  128  64   regs    87.0 KB  183        0
//   bf16  256  32   smem   101.4 KB  241        0
// At hd 64, 240 registers and 87 KB allow two blocks (8 warps) an SM;
// capping registers to fit more blocks makes ptxas spill.
// Shared memory exceeds the 48 KB default for most of them, so each launch
// opts in with cudaFuncSetAttribute.
//
// The entry returns cudaGetLastError() after its launch; the Python wrapper
// raises if it is not 0.

#include <math.h>

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kWarps = 4;
constexpr int kBq = 16 * kWarps;  // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -2.0e38f;

template <typename T, int HD>
struct Cfg {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kBk = kF32 ? (HD <= 64 ? 64 : 32) : (HD <= 128 ? 64 : 32);
  static constexpr bool kQRegs = kF32 ? HD <= 64 : HD <= 128;
  // f32 P.V: output n-tiles at a time (8, or 4 where O already holds 128 registers)
  static constexpr int kPvGroup = HD == 256 ? 4 : HD / 8 < 8 ? HD / 8 : 8;
  static constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte copy
  static constexpr int kStride = HD + kVec;       // shared row, padded by 16 B
  static constexpr size_t kBytes = sizeof(T) * kStride * (kBq + 4 * kBk);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int s, int t, int nh, int nkv,
                 int mask, int window, float softcap, float scale) {
  using C = Cfg<T, HD>;
  constexpr int kBk = C::kBk, kS = C::kStride;
  constexpr int kNT = kBk / 8;  // score n-tiles (8 keys) per k tile
  constexpr int kDT = HD / 8;   // output n-tiles (8 columns)
  constexpr int kQFrags = C::kF32 ? HD / 8 : HD / 16;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBq * kS;       // [2][kBk][kS]
  T* vs = ks + 2 * kBk * kS;   // [2][kBk][kS]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBq;  // heaviest causal tiles first
  const int kvh = h / (nh / nkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int qw = q0 + 16 * warp;  // this warp's first query row
  const float scale_l2 = scale * kLog2e, softcap_l2 = softcap * kLog2e;
  const T* qw_s = qs + 16 * warp * kS;

  const long long kv_rs = (long long)nkv * HD;
  const T* kb = k + ((long long)b * t * nkv + kvh) * HD;
  const T* vb = v + ((long long)b * t * nkv + kvh) * HD;

  // Keys this q tile can see.  Row qi sees kj <= qi (causal) and
  // qi - kj < window (window); tiles outside [k_lo, k_hi) hold only masked
  // keys, whose probability is exactly 0 once a row has a finite max.
  int k_lo = 0, k_hi = t;
  if (mask != kFull) {
    k_hi = min(t, q0 + kBq);
    if (mask == kWindow && window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int kt0 = k_lo / kBk;
  const int n_tiles = k_hi > kt0 * kBk ? (k_hi - kt0 * kBk + kBk - 1) / kBk : 0;

  load_rows<T, HD, kThreads>(qs, q + ((long long)b * s * nh + h) * HD, q0, kBq, s, (long long)nh * HD, tid);
  cp_async_commit();
  if (n_tiles > 0) {
    load_rows<T, HD, kThreads>(ks, kb, kt0 * kBk, kBk, t, kv_rs, tid);
    load_rows<T, HD, kThreads>(vs, vb, kt0 * kBk, kBk, t, kv_rs, tid);
  }
  cp_async_commit();
  cp_async_wait<1>();  // the q tile has landed
  __syncthreads();

  // Q's A fragments: rows 16 * warp + (lane % 16), column half lane / 16.
  unsigned qh[C::kQRegs ? kQFrags : 1][4], ql[C::kQRegs && C::kF32 ? kQFrags : 1][4];
  const T* q_frag = qw_s + (lane % 16) * kS + (lane / 16) * (C::kF32 ? 4 : 8);
  if constexpr (C::kQRegs) {
#pragma unroll
    for (int kk = 0; kk < kQFrags; ++kk) {
      if constexpr (C::kF32) {
        unsigned raw[4];
        ldsm_x4(raw, q_frag + kk * 8);
        split_bits(raw, qh[kk], ql[kk]);
      } else {
        ldsm_x4(qh[kk], q_frag + kk * 16);
      }
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  float acc[kDT][4];
#pragma unroll
  for (int n = 0; n < kDT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  // Lane offsets of the K (ldmatrix, two n-tiles) and V fragments.
  const int k_row = (lane % 8) + 8 * (lane / 16);
  const int k_col = ((lane / 8) % 2) * (C::kF32 ? 4 : 8);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (kt0 + it) * kBk;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_rows<T, HD, kThreads>(ks + (buf ^ 1) * kBk * kS, kb, k0 + kBk, kBk, t, kv_rs, tid);
      load_rows<T, HD, kThreads>(vs + (buf ^ 1) * kBk * kS, vb, k0 + kBk, kBk, t, kv_rs, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile it has landed; tile it + 1 may be in flight
    __syncthreads();
    const T* kt = ks + buf * kBk * kS;
    const T* vt = vs + buf * kBk * kS;

    // S = Q K^T for this warp's 16 rows and the tile's kBk keys.
    float sc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
    if constexpr (C::kF32) {
#pragma unroll
      for (int kk = 0; kk < HD / 8; ++kk) {
        unsigned ah[4], al[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ah[i] = qh[kk][i];
            al[i] = ql[kk][i];
          }
        } else {
          unsigned raw[4];
          ldsm_x4(raw, q_frag + kk * 8);
          split_bits(raw, ah, al);
        }
        // Four n-tiles at a time, term by term (lo.hi, hi.lo, then
        // hi.hi), so consecutive mmas feed different accumulators.
#pragma unroll
        for (int p0 = 0; p0 < kNT / 2; p0 += 2) {
          unsigned bh[4][2], bl[4][2];  // [n-tile][b0, b1]
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            unsigned raw[4], h[4], lo[4];
            ldsm_x4(raw, kt + (16 * (p0 + i) + k_row) * kS + kk * 8 + k_col);
            split_bits(raw, h, lo);
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              bh[2 * i + x / 2][x % 2] = h[x];
              bl[2 * i + x / 2][x % 2] = lo[x];
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(sc[2 * p0 + i], al, bh[i][0], bh[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(sc[2 * p0 + i], ah, bl[i][0], bl[i][1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(sc[2 * p0 + i], ah, bh[i][0], bh[i][1]);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        unsigned a[4];
        if constexpr (C::kQRegs) {
#pragma unroll
          for (int i = 0; i < 4; ++i) a[i] = qh[kk][i];
        } else {
          ldsm_x4(a, q_frag + kk * 16);
        }
#pragma unroll
        for (int p = 0; p < kNT / 2; ++p) {
          unsigned bb[4];
          ldsm_x4(bb, kt + (16 * p + k_row) * kS + kk * 16 + k_col);
          mma_bf16(sc[2 * p], a, bb[0], bb[1]);
          mma_bf16(sc[2 * p + 1], a, bb[2], bb[3]);
        }
      }
    }

    // Scale, softcap, mask (only in tiles that straddle an edge), online
    // softmax.  Lane holds rows g (e = 0, 1) and g + 8 (e = 2, 3), columns
    // 8 j + 2 tig + (e & 1); the 4 lanes of a quad share a row.  The
    // softmax works in base 2 (scores times log2 e, then 2^x).  Masked
    // scores are NEG_INF in that base too, so a row with no visible key
    // still weights its keys evenly, as the reference does.
    const bool edge = k0 + kBk > t ||
                      (mask != kFull && (k0 + kBk - 1 > qw ||
                                         (mask == kWindow && window > 0 &&
                                          qw + 15 - k0 >= window)));
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = softcap > 0.0f ? softcap_l2 * tanhf(sc[j][e] * scale / softcap)
                                 : sc[j][e] * scale_l2;
        if (edge) {
          const int qi = qw + g + 8 * (e >> 1);
          const int kj = k0 + 8 * j + 2 * tig + (e & 1);
          if (kj >= t) {
            x = -INFINITY;  // ragged tail: not a key at all
          } else if (mask != kFull) {
            bool ok = kj <= qi;
            if (mask == kWindow && window > 0) ok = ok && (qi - kj) < window;
            if (!ok) x = kNegInf;
          }
        }
        sc[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(sc[j][e] - m[e >> 1]);
        sc[j][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];  // per-lane part of the row sum

    // O = alpha O + P V.
    if constexpr (C::kF32) {
      // The tensor cores truncate as they accumulate, so a long chain of
      // mmas into O drifts: each tile's P V goes into a fresh accumulator,
      // kPvGroup output n-tiles at a time, and is added to O in float32.
      constexpr int kG = C::kPvGroup;
#pragma unroll
      for (int n0 = 0; n0 < kDT; n0 += kG) {
        float pv[kG][4];
#pragma unroll
        for (int i = 0; i < kG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) pv[i][e] = 0.0f;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          // A column tig is key 2 tig, column tig + 4 is key 2 tig + 1.
          const unsigned pa[4] = {__float_as_uint(sc[j][0]), __float_as_uint(sc[j][2]),
                                  __float_as_uint(sc[j][1]), __float_as_uint(sc[j][3])};
          unsigned ah[4], al[4];
          split_bits(pa, ah, al);
          const T* v0 = vt + (8 * j + 2 * tig) * kS + 8 * n0 + g;
          unsigned bh[kG][2], bl[kG][2];
#pragma unroll
          for (int i = 0; i < kG; ++i) {
            split(v0[8 * i], bh[i][0], bl[i][0]);
            split(v0[kS + 8 * i], bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < kG; ++i) mma_tf32(pv[i], al, bh[i][0], bh[i][1]);
#pragma unroll
          for (int i = 0; i < kG; ++i) mma_tf32(pv[i], ah, bl[i][0], bl[i][1]);
#pragma unroll
          for (int i = 0; i < kG; ++i) mma_tf32(pv[i], ah, bh[i][0], bh[i][1]);
        }
#pragma unroll
        for (int i = 0; i < kG; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n0 + i][e] = acc[n0 + i][e] * alpha[e >> 1] + pv[i][e];
      }
    } else {
#pragma unroll
      for (int n = 0; n < kDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      const int v_row = (lane % 8) + 8 * ((lane / 8) % 2);
      const int v_col = 8 * (lane / 16);
#pragma unroll
      for (int c = 0; c < kNT / 2; ++c) {
        const unsigned a[4] = {pack_bf16(sc[2 * c][0], sc[2 * c][1]),
                               pack_bf16(sc[2 * c][2], sc[2 * c][3]),
                               pack_bf16(sc[2 * c + 1][0], sc[2 * c + 1][1]),
                               pack_bf16(sc[2 * c + 1][2], sc[2 * c + 1][3])};
#pragma unroll
        for (int p = 0; p < kDT / 2; ++p) {
          unsigned bb[4];
          ldsm_x4_trans(bb, vt + (16 * c + v_row) * kS + 16 * p + v_col);
          mma_bf16(acc[2 * p], a, bb[0], bb[1]);
          mma_bf16(acc[2 * p + 1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = qw + g + 8 * r;
    if (qi >= s) continue;
    const float den = fmaxf(lr, 1e-30f);
    if (lse != nullptr && tig == 0) lse[((long long)b * nh + h) * s + qi] = m[r] + log2f(den);
    T* dst = o + (((long long)b * s + qi) * nh + h) * HD + 2 * tig;
#pragma unroll
    for (int n = 0; n < kDT; ++n) {
      const float x0 = acc[n][2 * r] / den, x1 = acc[n][2 * r + 1] / den;
      if constexpr (C::kF32) {
        *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int s, int t,
           int nh, int nkv, int mask, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t bytes = Cfg<T, HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (s + kBq - 1) / kBq;
  if (b > 65535 || tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nh, b, tiles);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, s, t, nh, nkv, mask, window, softcap, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, float* lse, int b, int s,
              int t, int nh, int nkv, int hd, int mask, int window, float softcap, float scale,
              cudaStream_t st) {
#define REPRO_FWD_CASE(HD) \
  case HD:                 \
    return launch<T, HD>(q, k, v, o, lse, b, s, t, nh, nkv, mask, window, softcap, scale, st);
  switch (hd) {
    REPRO_FWD_CASE(16)
    REPRO_FWD_CASE(32)
    REPRO_FWD_CASE(64)
    REPRO_FWD_CASE(128)
    REPRO_FWD_CASE(256)
#undef REPRO_FWD_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o all of it).  lse, when
// not null, receives each row's log-sum-exp in base 2 of the scores times
// log2 e (float32, (b, nh, s)): the softmax's own units, so the backward
// (flash_attention_bwd.cu) recomputes P as 2^(x - lse).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int b, int s, int t,
    int nh, int nkv, int hd, int mask, int window, float softcap, float scale,
    int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b == 0 || s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, l, b, s, t, nh, nkv, hd, mask, window, softcap, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, l, b, s, t, nh, nkv, hd, mask, window, softcap,
                                    scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
