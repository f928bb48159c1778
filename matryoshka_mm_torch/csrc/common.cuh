// Helpers shared by the kernels: 16-byte vector loads and stores between
// global memory (bf16 or f32) and f32 registers, 8-byte int8 loads, and the
// rounding of softmax probabilities to the value dtype before the PV
// product (the JAX reference casts probabilities to v.dtype the same way).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace m3 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// elements of T in one 16-byte vector
template <typename T>
constexpr int kVec = 16 / sizeof(T);

__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// 8 int8 values (8 bytes) as floats
__device__ __forceinline__ void load8(const int8_t* p, float* dst) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const uint32_t word = i < 4 ? x.x : x.y;
    dst[i] = static_cast<float>(
        static_cast<int8_t>((word >> (8 * (i & 3))) & 0xFF));
  }
}

// N consecutive values of T (N a multiple of kVec<T>) as floats
template <int N, typename T>
__device__ __forceinline__ void load_n(const T* p, float* dst) {
#pragma unroll
  for (int i = 0; i < N; i += kVec<T>) load16(p + i, dst + i);
}

__device__ __forceinline__ void store16(float* p, const float* src) {
  *reinterpret_cast<float4*>(p) = make_float4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* src) {
  uint4 x;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = x;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// probability as the PV product sees it: rounded to the value dtype
template <typename T>
__device__ __forceinline__ float round_p(float p) {
  return to_float(from_float<T>(p));
}

}  // namespace m3
