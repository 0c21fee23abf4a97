// Shared helpers for the kernels of this directory: conversions between the
// compute dtype (float or bf16) and float, vector loads and stores, and the
// SPADE table geometry.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace agl {

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>  // round to nearest even, as torch's and XLA's casts
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive values (16-byte aligned for float, 8-byte for bf16) as floats.
__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

// One 16-byte vector of T (8 bf16 or 4 float), held in registers.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  uint4 raw;
  __device__ __forceinline__ T* v() { return reinterpret_cast<T*>(&raw); }
};

// SPADE block class of offset u < f inside an f-pixel block (f >= 5):
// 0 for u = 0, 1 for u = 1, 3 for u = f-2, 4 for u = f-1, 2 between.
__device__ __forceinline__ int row_class(int u, int f) {
  return u == 0 ? 0 : u == 1 ? 1 : u == f - 2 ? 3 : u == f - 1 ? 4 : 2;
}

// Column of the compact (B, H/f, 5, C, 5 * W/f) tables for image column j.
__device__ __forceinline__ int compact_col(int j, int f) { return (j / f) * 5 + row_class(j % f, f); }

}  // namespace agl
