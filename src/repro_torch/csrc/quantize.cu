// Per-block symmetric int8 quantize / dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/quantize.py:
//   quantize_int8_pallas   (_quant_kernel)   -> repro_quantize_int8_f32
//   dequantize_int8_pallas (_dequant_kernel) -> repro_dequantize_int8_f32
//
// What bounds it on the card: bytes.  Quantize reads 4 bytes and writes 1
// (+ 4 per 256) for each element, at one division each, so device memory
// bandwidth is the limit by two orders of magnitude.  The design keeps each
// element to one read and one write: one warp owns one 256-element group,
// each lane loads its 8 floats with two 16-byte loads, the group's absmax
// is a warp shuffle reduction in registers, and each lane stores its 8 int8
// codes as one 8-byte store.  No shared memory, no second pass.
//
// Bit-exactness with the plain version (and with jnp.round in the JAX
// package): the scale is amax / 127 in IEEE division, each code is
// rintf(x / scale) -- IEEE division (nvcc's default -prec-div=true; this
// file must never be built with --use_fast_math), round half to even --
// then clipped to [-127, 127].  Dequantize is one float multiply, as the
// plain version.  Any number of groups works: the TPU kernel's
// rows % 64 assert is not carried over.
//
// Each entry returns cudaGetLastError() after its launch; the Python
// wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 256;          // quantization block (elements per scale)
constexpr int kGroupsPerCta = 8;     // one warp per group, 8 warps per block
constexpr int kDequantThreads = 256;

__global__ void __launch_bounds__(32 * kGroupsPerCta)
quantize_int8_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, long long groups) {
  const long long g = (long long)blockIdx.x * kGroupsPerCta + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (g >= groups) return;  // whole warps exit together: g is warp-uniform

  const float4* src = reinterpret_cast<const float4*>(x + g * kGroup) + lane * 2;
  const float4 a = src[0];
  const float4 b = src[1];
  const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};

  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float s = amax > 0.0f ? amax / 127.0f : 1.0f;

  union { int8_t c[8]; uint2 u; } out;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float r = fminf(fmaxf(rintf(v[i] / s), -127.0f), 127.0f);
    out.c[i] = static_cast<int8_t>(r);
  }
  reinterpret_cast<uint2*>(q + g * kGroup)[lane] = out.u;
  if (lane == 0) scale[g] = s;
}

__global__ void __launch_bounds__(kDequantThreads)
dequantize_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                       float* __restrict__ x, long long n) {
  // 4 elements per thread; n is a multiple of 256, so a quad never
  // straddles the end or a group boundary.
  const long long i = ((long long)blockIdx.x * kDequantThreads + threadIdx.x) * 4;
  if (i >= n) return;
  const char4 c = *reinterpret_cast<const char4*>(q + i);
  const float s = scale[i / kGroup];
  float4 o;
  o.x = static_cast<float>(c.x) * s;
  o.y = static_cast<float>(c.y) * s;
  o.z = static_cast<float>(c.z) * s;
  o.w = static_cast<float>(c.w) * s;
  *reinterpret_cast<float4*>(x + i) = o;
}

}  // namespace

extern "C" int repro_quantize_int8_f32(const void* x, void* q, void* scale,
                                       long long groups, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (groups <= 0) return 0;
  const long long blocks = (groups + kGroupsPerCta - 1) / kGroupsPerCta;
  quantize_int8_kernel<<<(unsigned)blocks, 32 * kGroupsPerCta, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(scale), groups);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_dequantize_int8_f32(const void* q, const void* scale, void* x,
                                         long long n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const long long quads = n / 4;
  const long long blocks = (quads + kDequantThreads - 1) / kDequantThreads;
  dequantize_int8_kernel<<<(unsigned)blocks, kDequantThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<float*>(x), n);
  return static_cast<int>(cudaGetLastError());
}
