// Constants and row helpers shared by the GAT attention kernels
// (gat_fwd, gat_bwd_dst, gat_bwd_src and their multi-head forms).
#pragma once

#include "common.cuh"

constexpr float LEAKY_SLOPE = 0.2f;
constexpr float LOGIT_CLAMP = 10.0f;
constexpr float EPS = 1e-9f;  // softmax denominator epsilon
constexpr int WARPS_PER_BLOCK = 8;

__device__ __forceinline__ void store_row(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_row(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to the row type the pointer's type names
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
