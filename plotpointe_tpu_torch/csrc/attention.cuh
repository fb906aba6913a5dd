// Constants and row helpers shared by the GAT attention kernels
// (gat_fwd, gat_bwd_dst, gat_bwd_src and their multi-head forms).
//
// Rows wider than STRIP columns run in column strips: the weighted sums are
// separable by column, the per-edge dot products are not. So the backward
// first takes those dot products over the full rows (`row_dots`) and each
// strip reads them.
#pragma once

#include "common.cuh"

constexpr float LEAKY_SLOPE = 0.2f;
constexpr float LOGIT_CLAMP = 10.0f;
constexpr float EPS = 1e-9f;  // softmax denominator epsilon
constexpr int WARPS_PER_BLOCK = 8;
constexpr int STRIP = 512;  // the widest row a lane's registers hold (16 values a lane)

__device__ __forceinline__ void store_row(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_row(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
// x rounded to the row type the pointer's type names
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// For each row r of a CSR (ptr, idx) and each of its entries e:
//   out_e[e] = sum_f a[r, f] * b[idx[e], f]        over f < d,
// and, where self_out is not null, self_out[r] = sum_f a[r, f] * c[r, f].
// a and c rows are lda apart, b rows ldb apart; rows at any width. One warp
// per row: each lane sums its columns f = lane, lane + 32, ... in order, then
// a warp sum: a fixed order, so the same bits on every run.
template <typename TA, typename TB>
__global__ void row_dots(const TA* __restrict__ a, const TB* __restrict__ b,
                         const float* __restrict__ c, const int* __restrict__ ptr,
                         const int* __restrict__ idx, float* __restrict__ out_e,
                         float* __restrict__ self_out, int n, int d, long long lda,
                         long long ldb) {
  constexpr int ILP = 4;  // entries whose rows are in flight at once
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const TA* ar = a + static_cast<long long>(row) * lda;
  if (self_out != nullptr) {
    const float* cr = c + static_cast<long long>(row) * lda;
    float s = 0.f;
    for (int f = lane; f < d; f += 32) s += to_f32(ar[f]) * cr[f];
    s = warp_sum(s);
    if (lane == 0) self_out[row] = s;
  }
  const int end = ptr[row + 1];
  for (int e = ptr[row]; e < end; e += ILP) {
    const TB* br[ILP];
    float p[ILP];
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      br[q] = b + static_cast<long long>(e + q < end ? idx[e + q] : 0) * ldb;
      p[q] = 0.f;
    }
    for (int f = lane; f < d; f += 32) {
      const float av = to_f32(ar[f]);
#pragma unroll
      for (int q = 0; q < ILP; ++q) p[q] += av * to_f32(br[q][f]);
    }
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      p[q] = warp_sum(p[q]);
      if (lane == 0 && e + q < end) out_e[e + q] = p[q];
    }
  }
}
