// Weighted CSR reduce (SpMM): y_r = sum over the row's entries k of
// values_k * x[idx_k], x rows at the row type (bf16 or f32), sums in f32.
//
// Replaces plotpointe_tpu/ops/spmm_kernel.py::_wreduce_kernel (launched by
// _wreduce_call). LightGCN's propagation runs it over the destination CSR
// (row_ptr, src, values) and its backward over the transpose CSR (t_ptr,
// t_dst, values in source order): one entry point for both directions.
//
// Two modes for rows that were gathered before the call (x [E, *], row e
// belonging to entry e), which the legacy attention contracts take:
//   idx == null     entry e reads x row e (no index stream is read);
//                   replaces plotpointe_tpu/ops/gat_kernel.py::_reduce_kernel
//                   (v1's weighted one-hot reduce over chunk tiles);
//   values == null  unit weights; with a null idx it replaces
//                   plotpointe_tpu/ops/gat_fused.py::_reduce_kernel (the
//                   unweighted one-hot reduce over the aligned layout).
// x rows may be a column strip of a wider array: `ld` is x's row stride in
// elements. With an index and values it is kernel 7 as before: the same
// loads, products and sums in the same order.
//
// What bounds it: bytes. Each entry reads one x row chosen by the graph
// (D * 2 bytes in bf16 rows), so the traffic is a data-dependent gather of E
// rows, above the compulsory read of x, idx, values and ptr and the write of
// y; the arithmetic is 2 FLOP per gathered element.
//
// Design: one warp per output row, the walk of gat_fwd.cu's `aggregate`
// without the softmax. A row of x is read in 16-byte chunks (4 f32 or 8 bf16
// values a lane). Where a row is narrower than the warp (D = 64 in bf16 is 8
// chunks), the warp splits into `groups` lane groups that take different
// entries at once: group g walks entries g, g + groups, ... of each batch of
// 32, several rows in flight per lane. The 32 lanes load 32 (idx, value)
// pairs with one coalesced load and hand them out by shuffle. f32
// accumulators stay in registers; at the end the groups are folded into
// group 0 in group order and each output row is written once. No atomics, a
// fixed order: deterministic.
// Known limit: a row with thousands of entries (a hot item) is one warp's
// serial loop, as in the attention kernels.
#include "common.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;

// C: 16-byte chunks a lane holds of one x row (ceil(chunks per row / 32))
template <typename T, int C>
__global__ void spmm_rows(const T* __restrict__ x, const float* __restrict__ values,
                          const int* __restrict__ ptr, const int* __restrict__ idx,
                          float* __restrict__ y, int n_rows, int nc, int groups,
                          long long ld) {
  constexpr int VEC = RowVec<T>::kElems;
  // entries in flight per lane: 32 row values in registers at most (8 f32
  // or 4 bf16 rows at C = 1). More registers cost warps per SM, and with an
  // average of ~11 entries per row the walk is bound by each row's chain of
  // dependent loads (ptr, then idx, then x), which only more warps hide.
  constexpr int FIT = 32 / (C * VEC);
  constexpr int EDGE_ILP = FIT > 8 ? 8 : (FIT < 1 ? 1 : FIT);
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int span = nc < 32 ? nc : 32;  // lanes one x row spans
  const int grp = lane / span;         // this lane's entry slot within a step
  const int c0 = lane - grp * span;    // this lane's first chunk of the row
  const bool active = grp < groups;
  const long long d = static_cast<long long>(nc) * VEC;  // y's row stride
  const int beg = ptr[row];
  const int end = ptr[row + 1];

  float acc[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;

  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int s = 0;
    float v = 0.f;
    if (e < end) {
      s = idx != nullptr ? idx[e] : e;
      v = values != nullptr ? values[e] : 1.f;
    }
    const int cnt = min(32, end - base);
    // group grp takes batch slots grp + groups * k, k = k0 .. k0 + EDGE_ILP - 1
    for (int k0 = 0; k0 * groups < cnt; k0 += EDGE_ILP) {
      int sj[EDGE_ILP];
      float wj[EDGE_ILP];
      bool ok[EDGE_ILP];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        const int j = grp + groups * (k0 + q);
        sj[q] = __shfl_sync(FULL_MASK, s, j & 31);
        wj[q] = __shfl_sync(FULL_MASK, v, j & 31);
        ok[q] = active && j < cnt;
      }
      float xv[EDGE_ILP][C][VEC];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        const T* r = x + sj[q] * ld;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const int ch = c0 + 32 * c;
          if (ok[q] && ch < nc) {
            RowVec<T>::load(r + ch * VEC, xv[q][c]);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) xv[q][c][k] = 0.f;
          }
        }
      }
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        if (ok[q]) {
#pragma unroll
          for (int c = 0; c < C; ++c)
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[c][k] += wj[q] * xv[q][c][k];
        }
      }
    }
  }
  // fold groups 1 .. groups - 1 into group 0, in group order
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float t = acc[c][k];
      for (int g = 1; g < groups; ++g) t += __shfl_sync(FULL_MASK, acc[c][k], (lane + g * span) & 31);
      acc[c][k] = t;
    }
  }
  if (grp != 0) return;
  float* out = y + row * d;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ch = c0 + 32 * c;
    if (ch < nc) {
#pragma unroll
      for (int k = 0; k < VEC; k += 4) {
        *reinterpret_cast<float4*>(out + ch * VEC + k) =
            make_float4(acc[c][k], acc[c][k + 1], acc[c][k + 2], acc[c][k + 3]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(int d, int ld, int n_rows, cudaStream_t st, const T* x, const float* values,
                   const int* ptr, const int* idx, float* y) {
  const int nc = d / RowVec<T>::kElems;  // 16-byte chunks per row
  const int groups = nc >= 32 ? 1 : 32 / nc;
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((n_rows + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  switch ((nc + 31) / 32) {
#define PPT_CASE(C) \
  case C:           \
    spmm_rows<T, C><<<grid, block, 0, st>>>(x, values, ptr, idx, y, n_rows, nc, groups, ld); \
    break;
    PPT_CASE(1) PPT_CASE(2) PPT_CASE(3) PPT_CASE(4)
#undef PPT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x [*, ld] rows (bf16 if bf16, else f32), 16-byte aligned, of which each
// entry reads the first d columns; values [E] f32, or null for unit weights;
// ptr [n_rows + 1] int32 (a CSR: row r's entries are ptr[r] .. ptr[r + 1] -
// 1); idx [E] int32 naming each entry's x row, or null for row e itself;
// y [n_rows, d] f32, 16-byte aligned. d must be a multiple of 32, at most
// 512; ld >= d, with ld rows 16-byte aligned.
PPT_EXPORT int ppt_spmm_csr(const void* x, int bf16, const float* values, const int* ptr,
                            const int* idx, float* y, int n_rows, int d, int ld, void* stream) {
  if (d <= 0 || d % 32 != 0 || d > 512 || ld < d || ld % (bf16 ? 8 : 4) != 0) {
    return cudaErrorInvalidValue;
  }
  if (n_rows == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(d, ld, n_rows, st, static_cast<const __nv_bfloat16*>(x), values,
                                 ptr, idx, y);
  }
  return launch<float>(d, ld, n_rows, st, static_cast<const float*>(x), values, ptr, idx, y);
}
