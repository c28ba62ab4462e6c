// Shared helpers of the serving kernels (float32 and bfloat16 instances).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// The reference's additive mask value: never -inf, because
// exp(-inf - -inf) is a NaN where exp(-1e30 - -1e30) is 1.
constexpr float kNegInf = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype() does
}

// Elements of T in one 16-byte load.
template <typename T> struct Vec16 { static constexpr int n = 16 / sizeof(T); };

// Load 16 bytes of T from global memory (16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load16(const T* __restrict__ src, float* dst);
template <>
__device__ __forceinline__ void load16<float>(const float* __restrict__ src, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(src));
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* __restrict__ src,
                                                      float* dst) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(src));
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) dst[i] = __bfloat162float(h[i]);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// dtype codes shared with kernels/attention.py
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

}  // namespace repro
