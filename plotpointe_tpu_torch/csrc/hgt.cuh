// What the three HGT kernels (hgt_fwd.cu, hgt_bwd_dst.cu, hgt_bwd_src.cu)
// share: the shape rule, the relation of a stacked source row and the
// per-lane parts of a head's dot product.
//
// The relation-stacked table holds a row [K' | V'] of 2 W values (W = H * D)
// a source: the user rows under relation 0 (rates), then the item rows under
// 1 (rated_by) and under 2 (similar); a row's relation follows from its
// index and the blocks' first rows off1, off2. A walk lane holds the K'
// half's chunks c0, c0 + 32, ... (gatv2.cuh's layout of a W-wide row, one
// lane group a warp) and the V' half's chunks at the same columns, so a
// lane's K' and V' values belong to the same heads as its q, g and out
// values.
#pragma once

#include "gatv2.cuh"

constexpr int HGT_REL = 3;

// The shape every HGT entry takes: H * D of 256 or 512, D a power of two
// from 8 to 128 (a 16-byte chunk never spans two heads, a head never spans
// two slots of a lane); the piece plan's stride odd.
inline bool hgt_shape_ok(int heads, int d, int stride) {
  const int w = heads * d;
  return (w == 256 || w == 512) && d >= 8 && d <= 128 && (d & (d - 1)) == 0 && stride % 2 == 1;
}

// The relation of stacked row s.
__device__ __forceinline__ int relation_of(int s, int off1, int off2) {
  return (s >= off1) + (s >= off2);
}

// v[r] for the relation r of an edge, without indexing registers at run time.
__device__ __forceinline__ float of_relation(const float (&v)[HGT_REL], int r) {
  return r == 0 ? v[0] : (r == 1 ? v[1] : v[2]);
}

// This lane's part of a . b over one chunk, in column order.
template <int VEC>
__device__ __forceinline__ float dot_part(const float (&a)[VEC], const float (&b)[VEC]) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) s = fmaf(a[k], b[k], s);
  return s;
}
