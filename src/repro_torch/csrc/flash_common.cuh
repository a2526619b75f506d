// Device helpers shared by the flash attention forward (flash_attention.cu)
// and backward (flash_attention_bwd.cu): cp.async copies, ldmatrix, the
// mma.sync tensor-core products (m16n8k8 TF32, m16n8k16 BF16, float32
// accumulators), the 3xTF32 split and 2^x.
//
// mma.sync fragment layouts, lane = 4 g + t (g = lane / 4, t = lane % 4):
//   m16n8k8 TF32   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//                  B (8 x 8):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   m16n8k16 BF16  A (16 x 16): a0 (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..)
//                  B (16 x 8):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C / D (16 x 8, float32): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash {

enum MaskKind { kFull = 0, kCausal = 1, kWindow = 2 };

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 16-byte matrices; lane i gives the row address of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 split of x: hi = tf32(x), lo = tf32(x - hi), round to nearest,
// ties away from zero: what cvt.rna.tf32.f32 computes, in two integer
// operations (add half of the 13 dropped bits' range to the magnitude,
// clear them).
__device__ __forceinline__ unsigned to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
template <int N>
__device__ __forceinline__ void split_bits(const unsigned (&x)[N], unsigned (&hi)[N],
                                           unsigned (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) split(__uint_as_float(x[i]), hi[i], lo[i]);
}

// 2^x in one MUFU instruction; results below 2^-126 flush to 0, which
// drops nothing from a softmax whose largest term is 1.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<unsigned*>(&v);
}

// Rows row0 .. row0 + nrows of src (row r at src + r * row_stride) into a
// shared tile whose rows are HD elements padded by 16 bytes (so ldmatrix's 8
// rows of 16 B hit distinct banks); rows at or past limit are zero-filled.
template <typename T, int HD, int kNumThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int row0, int nrows,
                                          int limit, long long row_stride, int tid) {
  constexpr int kVec = 16 / sizeof(T), kVecsPerRow = HD / kVec, kStride = HD + kVec;
  for (int idx = tid; idx < nrows * kVecsPerRow; idx += kNumThreads) {
    const int r = idx / kVecsPerRow, c = (idx % kVecsPerRow) * kVec;
    const bool ok = row0 + r < limit;
    const T* g = ok ? src + (long long)(row0 + r) * row_stride + c : src;
    cp_async16(dst + r * kStride + c, g, ok);
  }
}

}  // namespace flash
