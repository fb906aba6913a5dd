// Approximate cosine kNN candidates: bf16 tensor-core tile scores fused with
// a running top-R.
//
// Replaces plotpointe_tpu/ops/knn_kernel.py::_knn_kernel_fast (launched in
// knn_topk_pallas with mode="fast"). The same function as knn_topk.cu, but
// each score is a product of bf16-rounded rows summed in f32 (the TPU's
// single-pass bf16 MXU product): rows xb [n, d] bf16 in, out_idx [n, R]
// int32 and out_score [n, R] f32 out, descending; self and padding excluded;
// equal scores by smaller column; -1 / -1e30 in slots no column reached.
// The wrapper re-scores the candidates exactly in f32 and keeps the top k,
// so a neighbour is lost only where bf16 rounding pushed it below the R-th.
//
// What bounds it on this card: the bf16 operations, 989 TFLOP/s on the
// tensor cores at best: n (n - 1) d for the distinct pairs of the symmetric
// scores, 2 n^2 d for the full matrix this row-owned design computes. The
// bytes (xb read once) are negligible.
//
// Design: the block and selection of knn_topk.cu (128 rows a block, 128-wide
// column tiles swept in the block, knn.cuh's sorted lists), with the tile's
// product on the tensor cores through warp-level WMMA bf16 fragments (16 x 16
// x 16, f32 accumulators): 8 warps, each a 32 x 64 piece of the tile as 2 x 4
// fragments. Chunks of 32 features are staged in shared memory row-major and
// the next chunk is loaded into registers while this one is multiplied. The
// TPU kernel's slot pre-reduction (an economy of its vector unit) is not
// copied: the selection is the exact top-R of these scores, as in exact mode.
#include <mma.h>

#include "knn.cuh"

namespace {

using nvcuda::wmma::accumulator;
using nvcuda::wmma::col_major;
using nvcuda::wmma::fragment;
using nvcuda::wmma::matrix_a;
using nvcuda::wmma::matrix_b;
using nvcuda::wmma::mem_row_major;
using nvcuda::wmma::row_major;
using bf16 = __nv_bfloat16;

constexpr int DK = 32;        // features per staged chunk
constexpr int BLD = DK + 8;   // row stride of a staged chunk (bf16; 80 bytes)
static_assert(KNN_BR == KNN_BC, "one loader serves both operands");

// Thread tid loads 16-byte pieces tid and tid + 256 of a [128 rows][32
// features] chunk: row = v / 4, features 8 * (v % 4) .. + 8. d is a multiple
// of 8, so a piece is all in range or all out (then zero).
__device__ __forceinline__ void load_chunk(const bf16* __restrict__ x, int n, int d, int row0,
                                           int k0, uint4 (&v)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * KNN_THREADS;
    const int row = row0 + idx / 4, k = k0 + 8 * (idx % 4);
    v[q] = (row < n && k < d)
               ? __ldg(reinterpret_cast<const uint4*>(x + static_cast<long long>(row) * d + k))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void store_chunk(bf16* dst, const uint4 (&v)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * KNN_THREADS;
    *reinterpret_cast<uint4*>(dst + (idx / 4) * BLD + 8 * (idx % 4)) = v[q];
  }
}

__global__ void __launch_bounds__(KNN_THREADS, 1)
    knn_fast(const bf16* __restrict__ x, int* __restrict__ out_idx, float* __restrict__ out_score,
             int n, int d, int r) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);          // [KNN_BR][BLD]: this block's rows
  bf16* Bs = As + KNN_BR * BLD;                      // [KNN_BC][BLD]: the tile's columns
  float* S = reinterpret_cast<float*>(Bs + KNN_BC * BLD);  // [KNN_BR][KNN_SLD]
  float* ls = S + KNN_BR * KNN_SLD;                  // [KNN_BR][r]
  int* li = reinterpret_cast<int*>(ls + KNN_BR * r);

  const int row0 = blockIdx.x * KNN_BR;
  const int warp = threadIdx.x / 32;
  const int wy = warp / 2, wx = warp % 2;  // rows wy*32 .. +32, columns wx*64 .. +64
  knn_list_init(ls, li, r);

  for (int col0 = 0; col0 < n; col0 += KNN_BC) {
    fragment<accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.f);
    uint4 va[2], vb[2];
    load_chunk(x, n, d, row0, 0, va);
    load_chunk(x, n, d, col0, 0, vb);
    store_chunk(As, va);
    store_chunk(Bs, vb);
    __syncthreads();
    for (int k0 = 0; k0 < d; k0 += DK) {
      const bool more = k0 + DK < d;
      if (more) {
        load_chunk(x, n, d, row0, k0 + DK, va);
        load_chunk(x, n, d, col0, k0 + DK, vb);
      }
#pragma unroll
      for (int kk = 0; kk < DK; kk += 16) {
        fragment<matrix_a, 16, 16, 16, bf16, row_major> fa[2];
        fragment<matrix_b, 16, 16, 16, bf16, col_major> fb[4];  // B = columns^T
#pragma unroll
        for (int i = 0; i < 2; ++i)
          nvcuda::wmma::load_matrix_sync(fa[i], As + (wy * 32 + i * 16) * BLD + kk, BLD);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nvcuda::wmma::load_matrix_sync(fb[j], Bs + (wx * 64 + j * 16) * BLD + kk, BLD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) nvcuda::wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
      if (more) {
        store_chunk(As, va);
        store_chunk(Bs, vb);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        nvcuda::wmma::store_matrix_sync(S + (wy * 32 + i * 16) * KNN_SLD + wx * 64 + j * 16,
                                        acc[i][j], KNN_SLD, mem_row_major);
    __syncthreads();
    knn_fold_tile(S, ls, li, r, row0, col0, n);
    __syncthreads();
  }
  knn_write(ls, li, r, row0, n, out_idx, out_score);
}

size_t smem_bytes(int r) {
  return sizeof(bf16) * 2 * KNN_BR * BLD + sizeof(float) * KNN_BR * KNN_SLD + knn_list_bytes(r);
}

}  // namespace

// xb [n, d] bf16, 16-byte aligned, d a multiple of 8; out_idx [n, r] int32,
// out_score [n, r] f32; 1 <= r <= 128.
PPT_EXPORT int ppt_knn_topk_fast(const void* xb, int* out_idx, float* out_score, int n, int d,
                                 int r, void* stream) {
  if (n <= 0 || d <= 0 || d % 8 != 0 || r < 1 || r > KNN_MAX_R) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(knn_fast, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n + KNN_BR - 1) / KNN_BR;
  knn_fast<<<blocks, KNN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(xb), out_idx, out_score, n, d, r);
  return cudaGetLastError();
}

// Dynamic shared memory for r candidates a row, for the wrapper's check.
PPT_EXPORT size_t ppt_knn_topk_fast_smem(int r) { return smem_bytes(r); }
