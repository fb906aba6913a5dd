// Shared helpers for the plotpointe_tpu_torch kernels (sm_90a, plain C ABI).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define PPT_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEG_INF = -1e30f;  // the JAX package's "minus infinity" for scores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

constexpr int CHUNK = 128;  // items per top-K chunk
constexpr int ROW_ILP = 4;  // 16-byte row loads a thread keeps in flight

// One 16-byte load of a row, widened to f32: 4 floats or 8 bf16 values.
// The address must be 16-byte aligned.
template <typename T>
struct RowVec;

template <>
struct RowVec<float> {
  static constexpr int kElems = 4;
  __device__ static __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  }
};

template <>
struct RowVec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
};

PPT_EXPORT const char* ppt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
