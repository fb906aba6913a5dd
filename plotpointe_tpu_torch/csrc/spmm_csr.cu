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
// elements.
//
// What bounds it: bytes. Each entry reads one x row chosen by the graph
// (D * 2 bytes in bf16 rows), so the traffic is a data-dependent gather of E
// rows, above the compulsory read of x, idx, values and ptr and the write of
// y; the arithmetic is 2 FLOP per gathered element. At LightGCN's shape
// (255,404 x 64 bf16 rows = 32.7 MB) x fits in the 50 MB L2, so what the walk
// loses is latency and imbalance: each entry is a chain of dependent loads
// (row bounds, then idx, then the x row), and in-degrees are lognormal with
// rows of thousands of entries.
//
// Design: an edge-balanced walk over a plan that `ops/spmm_kernel.py` builds
// once per CSR and caches.
//   pieces  a piece is a run of at most CAP (64) consecutive entries of one
//           row: rows up to CAP entries are one piece (an empty row one empty
//           piece), longer rows several. The pieces in order tile the
//           entries, so their bounds form a finer CSR (`piece_ptr`).
//   units   a unit is a run of consecutive pieces of about UNIT (64) entries
//           (each piece counted as its entries plus one), so it walks at most
//           UNIT + CAP entries; units in order tile the pieces (`unit_ptr`).
// spmm_units: one lane group per unit. A row of x is read in 16-byte chunks
//   (4 f32 or 8 bf16 values a lane); where a row is narrower than the warp
//   (D = 64 in bf16 is 8 chunks) the warp holds `groups` lane groups, each
//   walking its own unit's rows, so no lane group walks a hot row alone and
//   the groups of a warp walk about as many entries each. A group walks its
//   unit's entries as one flat run, several x rows in flight, and at each
//   piece's end writes that piece's f32 sum once: to y where the piece is
//   its whole row, else to a scratch row. A block's units are consecutive,
//   so its entries are one contiguous range: the block first copies up to
//   STAGE of its idx and values into shared memory with cp.async, which
//   takes the idx load out of every entry's chain of dependent loads.
// spmm_combine: each split row's scratch rows summed in piece order into y.
// No atomics, a fixed order: the same bits on every run. The cp.async
// helpers live in walk.cuh, which the attention walks (kernels 8 and 3)
// share.
#include "walk.cuh"

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int STAGE = 2048;  // entries of idx and values a block stages (16 KB)

// The output row of piece p: y row p without a piece map, else y row o for
// o >= 0 or scratch row -1 - o.
__device__ __forceinline__ float* piece_row(float* y, float* scratch, const int* piece_out, int p,
                                            long long d) {
  if (piece_out == nullptr) return y + p * d;
  const int o = piece_out[p];
  return o >= 0 ? y + o * d : scratch + (-1LL - o) * d;
}

// C: 16-byte chunks a lane holds of one x row (ceil(chunks per row / 32))
template <typename T, int C>
__global__ void __launch_bounds__(32 * WARPS_PER_BLOCK)
    spmm_units(const T* __restrict__ x, const float* __restrict__ values,
               const int* __restrict__ piece_ptr, const int* __restrict__ idx,
               const int* __restrict__ piece_out, const int* __restrict__ unit_ptr,
               float* __restrict__ y, float* __restrict__ scratch, int n_units, int nc, int groups,
               long long ld) {
  constexpr int VEC = RowVec<T>::kElems;
  // entries in flight per lane: 32 row values in registers at most (8 f32
  // or 4 bf16 rows at C = 1); more registers cost resident warps
  constexpr int FIT = 32 / (C * VEC);
  constexpr int EDGE_ILP = FIT > 8 ? 8 : (FIT < 1 ? 1 : FIT);
  extern __shared__ int stage[];  // [STAGE] idx, then [STAGE] values
  int* s_idx = stage;
  float* s_val = reinterpret_cast<float*>(stage + STAGE);

  const int u0 = blockIdx.x * WARPS_PER_BLOCK * groups;
  const int u1 = min(u0 + WARPS_PER_BLOCK * groups, n_units);
  const int e0 = piece_ptr[unit_ptr[u0]];
  const int staged =
      (idx != nullptr || values != nullptr) ? min(piece_ptr[unit_ptr[u1]] - e0, STAGE) : 0;
  for (int i = threadIdx.x; i < staged; i += blockDim.x) {
    if (idx != nullptr) cp_async4(s_idx + i, idx + e0 + i);
    if (values != nullptr) cp_async4(s_val + i, values + e0 + i);
  }
  cp_async_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int span = nc < 32 ? nc : 32;  // lanes one x row spans
  const int grp = lane / span;         // this lane's unit within the warp
  const int c0 = lane - grp * span;    // this lane's first chunk of a row
  const int u = u0 + (threadIdx.x >> 5) * groups + grp;
  if (grp >= groups || u >= u1) return;
  const long long d = static_cast<long long>(nc) * VEC;  // y's row stride
  int p = unit_ptr[u];  // the piece being summed
  const int p_end = unit_ptr[u + 1];
  int pe = piece_ptr[p + 1];  // its end
  const int e_end = piece_ptr[p_end];

  float acc[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;

  // write piece p's sum and start the next piece
  auto flush = [&]() {
    float* out = piece_row(y, scratch, piece_out, p, d);
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
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;
    }
    ++p;
  };

  for (int e = piece_ptr[p]; e < e_end; e += EDGE_ILP) {
    int sj[EDGE_ILP];
    float wj[EDGE_ILP];
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      const int ej = e + q;
      const int k = ej - e0;
      sj[q] = 0;
      wj[q] = 0.f;
      if (ej < e_end) {
        sj[q] = idx == nullptr ? ej : (k < staged ? s_idx[k] : idx[ej]);
        wj[q] = values == nullptr ? 1.f : (k < staged ? s_val[k] : values[ej]);
      }
    }
    float xv[EDGE_ILP][C][VEC];
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      const T* r = x + static_cast<long long>(sj[q]) * ld;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = c0 + 32 * c;
        if (e + q < e_end && ch < nc) {
          RowVec<T>::load(r + ch * VEC, xv[q][c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) xv[q][c][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      if (e + q < e_end) {
        while (e + q == pe) {  // the piece (and any empty ones after it) ended
          flush();
          pe = piece_ptr[p + 1];
        }
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[c][k] += wj[q] * xv[q][c][k];
      }
    }
  }
  while (p < p_end) flush();  // the last piece, then trailing empty ones (zeros)
}

// y[split_rows[r]] = the scratch rows split_ptr[r] .. split_ptr[r + 1] - 1,
// summed in that order; one thread per (split row, 4 columns)
__global__ void spmm_combine(const float4* __restrict__ scratch, const int* __restrict__ split_rows,
                             const int* __restrict__ split_ptr, float4* __restrict__ y,
                             int n_split, int d4) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_split) * d4) return;
  const int r = static_cast<int>(i / d4);
  const int c = static_cast<int>(i - static_cast<long long>(r) * d4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = split_ptr[r]; s < split_ptr[r + 1]; ++s) {
    const float4 v = scratch[static_cast<long long>(s) * d4 + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  y[static_cast<long long>(split_rows[r]) * d4 + c] = acc;
}

template <typename T>
cudaError_t launch(int d, long long ld, int n_units, cudaStream_t st, const T* x,
                   const float* values, const int* piece_ptr, const int* idx,
                   const int* piece_out, const int* unit_ptr, float* y, float* scratch) {
  const int nc = d / RowVec<T>::kElems;  // 16-byte chunks per row
  const int groups = nc >= 32 ? 1 : 32 / nc;
  const int per_block = WARPS_PER_BLOCK * groups;
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((n_units + per_block - 1) / per_block);
  const size_t smem = (idx != nullptr || values != nullptr) ? 2 * STAGE * sizeof(int) : 0;
  switch ((nc + 31) / 32) {
#define PPT_CASE(C)                                                                            \
  case C:                                                                                      \
    spmm_units<T, C><<<grid, block, smem, st>>>(x, values, piece_ptr, idx, piece_out, unit_ptr, \
                                                y, scratch, n_units, nc, groups, ld);           \
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
// idx [E] int32 naming each entry's x row, or null for row e itself.
// The plan: piece_ptr [n_pieces + 1] int32 (piece p is entries
// piece_ptr[p] .. piece_ptr[p + 1] - 1 of one row); piece_out [n_pieces]
// int32, o >= 0 to write y row o, o < 0 to write scratch row -1 - o, or
// null for y row p (every row one piece: piece_ptr is the CSR's own ptr);
// unit_ptr [n_units + 1] int32 (unit u is pieces unit_ptr[u] ..
// unit_ptr[u + 1] - 1, unit_ptr[n_units] = n_pieces); scratch [slots, d]
// f32; split_rows [n_split] and split_ptr [n_split + 1] int32: y row
// split_rows[r] is the sum of scratch rows split_ptr[r] .. split_ptr[r + 1]
// - 1. y [n_rows, d] f32, 16-byte aligned, every row written (an empty row
// is one empty piece: 0). d must be a multiple of 32, at most 512; ld >= d,
// with ld rows 16-byte aligned.
PPT_EXPORT int ppt_spmm_csr(const void* x, int bf16, const float* values, const int* piece_ptr,
                            const int* idx, const int* piece_out, const int* unit_ptr, float* y,
                            float* scratch, const int* split_rows, const int* split_ptr,
                            int n_units, int n_split, int d, int ld, void* stream) {
  if (d <= 0 || d % 32 != 0 || d > 512 || ld < d || ld % (bf16 ? 8 : 4) != 0 ||
      (n_split > 0 && (piece_out == nullptr || scratch == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (n_units == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(d, ld, n_units, st, static_cast<const __nv_bfloat16*>(x),
                                   values, piece_ptr, idx, piece_out, unit_ptr, y, scratch)
           : launch<float>(d, ld, n_units, st, static_cast<const float*>(x), values, piece_ptr,
                           idx, piece_out, unit_ptr, y, scratch);
  if (err != cudaSuccess || n_split == 0) return err;
  const int d4 = d / 4;
  const long long threads = static_cast<long long>(n_split) * d4;
  spmm_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(scratch), split_rows, split_ptr, reinterpret_cast<float4*>(y),
      n_split, d4);
  return cudaGetLastError();
}
