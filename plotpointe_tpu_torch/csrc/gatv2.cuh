// What the three GATv2 kernels (gatv2_fwd.cu, gatv2_bwd_dst.cu,
// gatv2_bwd_src.cu) share: the lane layout of a row, the per-lane part of
// the logit, the sums of a head across lanes, the dropout hash and the
// combine of split rows.
//
// A row is H * D values of the row type T (bf16 or f32), read in 16-byte
// chunks of VEC values (8 bf16, 4 f32); the f32 rows beside it (xr, g, out,
// a) are read at the same columns. A lane group is as wide as a row's
// chunks rounded up to a power of two, up to a warp; lane c0 of a group
// holds chunks c0, c0 + 32, ... (C slots). D is a power of two, so a head's
// chunks lie in aligned runs of `red` lanes of one slot, or, for a head of
// more than 32 chunks, in every lane of several slots (`merge`). The forward
// and B1 form each edge's logit with the same instructions in the same
// order, so they read the same bits.
#pragma once

#include "attention.cuh"
#include "walk.cuh"

constexpr int GATV2_MAX_WIDTH = 1024;  // H * D a row holds
constexpr int HEAD_ID_SHIFT = 27;      // head k's dropout ids are canonical ids + k * 2**27

// The dropout of a launch: `masked` false keeps every edge with 1. Else the
// multiplier of edge id e of head k: a splitmix32-style hash of the uint32
// id (e + id_offset + k * 2**27) xor the seed below `thresh` keeps it with
// `scale` (1 / (1 - rate), rounded to f32), else 0; the function of
// `ops/gat_fused.hash_mask`.
struct Drop {
  int masked;
  unsigned seed, thresh;
  float scale;
  long long id_offset;
};

__device__ __forceinline__ float keep_of(const Drop& dr, long long e, int k) {
  unsigned x = static_cast<unsigned>(e + dr.id_offset + (static_cast<long long>(k) << HEAD_ID_SHIFT));
  x ^= dr.seed;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return x < dr.thresh ? dr.scale : 0.f;
}

__device__ __forceinline__ float lrelu(float z) { return z > 0.f ? z : LEAKY_SLOPE * z; }

// This lane's part of a . lrelu(rl + xr) over one chunk, in column order.
template <int VEC>
__device__ __forceinline__ float score_part(const float (&x)[VEC], const float (&xr)[VEC],
                                            const float (&a)[VEC]) {
  float p = 0.f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) p = fmaf(a[k], lrelu(x[k] + xr[k]), p);
  return p;
}

// x / dn from the reciprocal r = 1 / dn: x * r corrected by one FMA (the
// division's bits outside the underflow range, without its cost)
__device__ __forceinline__ float div_by(float x, float dn, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, dn, x), r, q);
}

// v[q][c] holds this lane's part of head[c]'s sum for entry q; afterwards
// the head's whole sum, the same bits in every lane of the head: a butterfly
// over the `red` lanes that hold the head's chunks of slot c, then, where one
// head takes several slots of every lane (`merge`), the slots of a head
// added in slot order.
template <int Q, int C>
__device__ __forceinline__ void head_sums(float (&v)[Q][C], const int (&head)[C], unsigned gmask,
                                          int red, bool merge) {
  for (int o = red >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) v[q][c] += __shfl_xor_sync(gmask, v[q][c], o);
  }
  if (C > 1 && merge) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float t[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        t[c] = 0.f;
#pragma unroll
        for (int c2 = 0; c2 < C; ++c2)
          if (head[c2] == head[c]) t[c] += v[q][c2];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) v[q][c] = t[c];
    }
  }
}

// The layout of a row of H * D values in chunks of VEC.
struct RowLayout {
  int nc;      // 16-byte chunks of a row
  int span;    // lanes of a group: a power of two >= min(nc, 32)
  int groups;  // lane groups a warp: 32 / span
  int red;     // lanes one head's chunks take in a slot
};

inline RowLayout row_layout(int heads, int d, int vec) {
  RowLayout l;
  l.nc = heads * d / vec;
  l.span = 1;
  while (l.span < l.nc && l.span < 32) l.span <<= 1;
  l.groups = 32 / l.span;
  const int per_head = d / vec;
  l.red = per_head < l.span ? per_head : l.span;
  return l;
}

// A lane's place in its group and the heads of its chunks.
template <int C, int VEC>
struct Lane {
  int c0, grp, gid;  // chunk of slot 0, group of the warp, group of the block
  unsigned gmask;    // the group's lanes
  bool merge;        // a head takes several slots of every lane
  int head[C];       // the head of each of this lane's chunks
  bool live[C];      // the chunk lies in the row
  bool first[C];     // the chunk starts its head: its lane writes the head's scalars

  __device__ __forceinline__ Lane(const RowLayout& l, int d) {
    const int lane = threadIdx.x & 31;
    grp = lane / l.span;
    c0 = lane - grp * l.span;
    gid = (threadIdx.x >> 5) * l.groups + grp;
    gmask = l.span == 32 ? FULL_MASK : ((1u << l.span) - 1u) << (grp * l.span);
    merge = d / VEC > 32;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ch = c0 + 32 * c;
      live[c] = ch < l.nc;
      head[c] = live[c] ? ch * VEC / d : 0;  // a chunk past the row: zeros, under head 0
      first[c] = live[c] && ch * VEC % d == 0;
    }
  }
};

// Each split row's scratch slots (w floats each) summed in piece order and,
// where `a` is not null, multiplied by a column's a; one thread per (split
// row, 4 columns); rows w floats apart
__global__ void gatv2_sum_slots(const float4* __restrict__ scratch, const int* __restrict__ split_rows,
                                const int* __restrict__ split_ptr, const float4* __restrict__ a,
                                float4* __restrict__ y, int n_split, int w4) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_split) * w4) return;
  const int r = static_cast<int>(i / w4);
  const int c = static_cast<int>(i - static_cast<long long>(r) * w4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = split_ptr[r]; s < split_ptr[r + 1]; ++s) {
    const float4 v = scratch[static_cast<long long>(s) * w4 + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  if (a != nullptr) {
    const float4 m = a[c];
    acc = make_float4(m.x * acc.x, m.y * acc.y, m.z * acc.z, m.w * acc.w);
  }
  y[static_cast<long long>(split_rows[r]) * w4 + c] = acc;
}

inline cudaError_t launch_sum_slots(const float* scratch, const int* split_rows, const int* split_ptr,
                                    const float* a, float* y, int n_split, int w, cudaStream_t st) {
  if (n_split == 0) return cudaSuccess;
  const long long threads = static_cast<long long>(n_split) * (w / 4);
  gatv2_sum_slots<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(scratch), split_rows, split_ptr,
      reinterpret_cast<const float4*>(a), reinterpret_cast<float4*>(y), n_split, w / 4);
  return cudaGetLastError();
}

// The shape every GATv2 entry takes: 1 to 8 heads, D a power of two >= 32,
// H * D <= GATV2_MAX_WIDTH; the piece plan's stride odd.
inline bool gatv2_shape_ok(int heads, int d, int stride) {
  return heads >= 1 && heads <= 8 && d >= 32 && (d & (d - 1)) == 0 &&
         heads * d <= GATV2_MAX_WIDTH && stride % 2 == 1;
}
