// The running top-R candidate lists shared by the kNN kernels (knn_topk.cu,
// knn_topk_fast.cu).
//
// A block owns KNN_BR rows and sweeps every column tile of KNN_BC columns
// itself: blocks run in no order, so nothing may carry over between them.
// After each tile's scores land in shared memory (S, row-major, row stride
// KNN_SLD), one warp per row folds them into that row's list: the row's
// R best (score, column) pairs so far, kept sorted in shared memory. The
// order is a total one: higher score first, equal scores by smaller column.
// So the final list is the top-R of every column by that order, whatever
// order the candidates arrived in, and the plain version can reproduce it
// exactly from the same scores. Self (column == row) and padding columns
// (>= n) are never inserted; slots no candidate reached keep (-1e30, -1).
#pragma once

#include "common.cuh"

constexpr int KNN_BR = 128;  // rows a block owns
constexpr int KNN_BC = 128;  // columns per tile
constexpr int KNN_THREADS = 256;
constexpr int KNN_WARPS = KNN_THREADS / 32;
constexpr int KNN_SLD = KNN_BC + 4;  // row stride of the score tile (floats)
constexpr int KNN_MAX_R = 128;       // K_PAD: at most 4 list entries a lane

// Does (s, c) rank above (ts, tc)? Higher score first, then smaller column.
__device__ __forceinline__ bool knn_above(float s, int c, float ts, int tc) {
  return s > ts || (s == ts && c < tc);
}

// Bytes of the lists: score [KNN_BR][r] f32, then column [KNN_BR][r] int32.
__host__ __device__ constexpr size_t knn_list_bytes(int r) {
  return static_cast<size_t>(KNN_BR) * r * (sizeof(float) + sizeof(int));
}

__device__ __forceinline__ void knn_list_init(float* ls, int* li, int r) {
  for (int j = threadIdx.x; j < KNN_BR * r; j += blockDim.x) {
    ls[j] = NEG_INF;
    li[j] = -1;
  }
}

// Insert (s, c) into one row's sorted list of r entries if it ranks above
// the last one. Called by a whole warp with the same (s, c).
__device__ __forceinline__ void knn_insert(float* ls, int* li, int r, float s, int c, int lane) {
  if (!knn_above(s, c, ls[r - 1], li[r - 1])) return;
  int p = 0;  // entries that rank above (s, c): its place in the list
#pragma unroll
  for (int u = 0; u < KNN_MAX_R / 32; ++u) {
    const int j = u * 32 + lane;
    const bool above = j < r && knn_above(ls[j], li[j], s, c);
    p += __popc(__ballot_sync(FULL_MASK, above));
  }
  float vs[KNN_MAX_R / 32];
  int vi[KNN_MAX_R / 32];
#pragma unroll
  for (int u = 0; u < KNN_MAX_R / 32; ++u) {
    const int j = u * 32 + lane;
    if (j > p && j < r) {
      vs[u] = ls[j - 1];
      vi[u] = li[j - 1];
    }
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < KNN_MAX_R / 32; ++u) {
    const int j = u * 32 + lane;
    if (j > p && j < r) {
      ls[j] = vs[u];
      li[j] = vi[u];
    } else if (j == p) {
      ls[j] = s;
      li[j] = c;
    }
  }
  __syncwarp();
}

// Fold the score tile S (rows row0.., columns col0..) into the lists. Every
// thread of the block calls it, between two __syncthreads().
__device__ __forceinline__ void knn_fold_tile(const float* S, float* ls, int* li, int r, int row0,
                                              int col0, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int rr = warp; rr < KNN_BR && row0 + rr < n; rr += KNN_WARPS) {
    const int grow = row0 + rr;
    float* rs = ls + rr * r;
    int* ri = li + rr * r;
#pragma unroll
    for (int t = 0; t < KNN_BC / 32; ++t) {
      const int gcol = col0 + t * 32 + lane;
      const float s = S[rr * KNN_SLD + t * 32 + lane] + 0.0f;  // -0 -> +0: ties compare as keys do
      const bool beats = gcol < n && gcol != grow && knn_above(s, gcol, rs[r - 1], ri[r - 1]);
      unsigned m = __ballot_sync(FULL_MASK, beats);
      while (m) {  // in increasing column order
        const int src = __ffs(m) - 1;
        m &= m - 1;
        knn_insert(rs, ri, r, __shfl_sync(FULL_MASK, s, src), col0 + t * 32 + src, lane);
      }
    }
  }
}

// The block's lists are rows row0.. of out [n, r]: one contiguous stretch.
__device__ __forceinline__ void knn_write(const float* ls, const int* li, int r, int row0, int n,
                                          int* __restrict__ out_idx, float* __restrict__ out_score) {
  const long long base = static_cast<long long>(row0) * r;
  const int count = min(KNN_BR, n - row0) * r;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    out_score[base + j] = ls[j];
    out_idx[base + j] = li[j];
  }
}
