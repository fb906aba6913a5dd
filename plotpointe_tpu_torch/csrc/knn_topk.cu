// Exact cosine kNN candidates: f32 tile scores fused with a running top-R.
//
// Replaces plotpointe_tpu/ops/knn_kernel.py::_knn_kernel (launched in
// knn_topk_pallas). For L2-normalised rows x [n, d] f32 it writes, per row,
// the R best columns by score x[row] . x[col] (self and padding excluded;
// equal scores by smaller column) to out_idx [n, R] int32 and out_score
// [n, R] f32, descending; slots no column reached hold -1 / -1e30. The
// wrapper re-scores these candidates exactly and keeps the top k.
//
// What bounds it on this card: the f32 operations. The scores are symmetric,
// so the job needs each distinct pair once, n (n - 1) d operations; this
// design owns rows and computes the full matrix, 2 n^2 d, twice that. The TPU
// scores at Precision.HIGHEST so that the selection loses no neighbour to
// bf16 rounding; here every product is a plain f32 FMA on the CUDA cores (no
// TF32, no bf16 split), 67 TFLOP/s at best. The bytes (x read once) are
// negligible.
//
// Design: a SIMT SGEMM tile fused with the selection of knn.cuh, so the
// [n, n] scores never reach device memory. A block of 256 threads owns 128
// rows and sweeps the column tiles (128 wide) itself. Each tile's product is
// staged through shared memory in chunks of 16 features (rows transposed, so
// a thread reads its operands as 16-byte vectors), the next chunk is loaded
// into registers while this one is multiplied, and each thread keeps an 8x8
// register tile: 64 FMAs per 16 shared-memory bytes of each operand. Each
// score sums d = 0..d-1 in order. The tile goes to shared memory and one warp
// per row folds it into that row's sorted list (a ballot finds the few
// columns that beat the R-th best). No atomics: the result is deterministic.
#include "knn.cuh"

namespace {

constexpr int DK = 16;               // features per staged chunk
constexpr int ALD = KNN_BR + 4;      // row stride of the transposed chunks (floats)
static_assert(KNN_BR == KNN_BC, "one loader serves both operands");

// Four features of one row; d is a multiple of 4, so a vector is all in
// range or all out (then zero, which adds nothing to a score).
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int n, int d, int row, int k) {
  if (row < n && k < d)
    return __ldg(reinterpret_cast<const float4*>(x + static_cast<long long>(row) * d + k));
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// Thread tid loads vectors tid and tid + 256 of a [128 rows][16 features]
// chunk: row = v / 4, features 4 * (v % 4) ...
__device__ __forceinline__ void load_chunk(const float* __restrict__ x, int n, int d, int row0,
                                           int k0, float4 (&v)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * KNN_THREADS;
    v[q] = load4(x, n, d, row0 + idx / 4, k0 + 4 * (idx % 4));
  }
}

// ... and stores them transposed: dst[feature][row].
__device__ __forceinline__ void store_chunk(float* dst, const float4 (&v)[2]) {
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int idx = threadIdx.x + q * KNN_THREADS;
    const int row = idx / 4, k = 4 * (idx % 4);
    dst[(k + 0) * ALD + row] = v[q].x;
    dst[(k + 1) * ALD + row] = v[q].y;
    dst[(k + 2) * ALD + row] = v[q].z;
    dst[(k + 3) * ALD + row] = v[q].w;
  }
}

__global__ void __launch_bounds__(KNN_THREADS, 1)
    knn_exact(const float* __restrict__ x, int* __restrict__ out_idx, float* __restrict__ out_score,
              int n, int d, int r) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // [DK][ALD]: this block's rows
  float* Bs = As + DK * ALD;         // [DK][ALD]: the tile's columns
  float* S = Bs + DK * ALD;          // [KNN_BR][KNN_SLD]
  float* ls = S + KNN_BR * KNN_SLD;  // [KNN_BR][r]
  int* li = reinterpret_cast<int*>(ls + KNN_BR * r);

  const int row0 = blockIdx.x * KNN_BR;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  knn_list_init(ls, li, r);

  for (int col0 = 0; col0 < n; col0 += KNN_BC) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float4 va[2], vb[2];
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
      for (int k = 0; k < DK; ++k) {
        // rows ty*4 + {0..3} and 64 + ty*4 + {0..3}; columns likewise with tx
        const float4 a0 = *reinterpret_cast<const float4*>(As + k * ALD + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(As + k * ALD + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * ALD + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * ALD + 64 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
      if (more) {
        store_chunk(As, va);
        store_chunk(Bs, vb);
        __syncthreads();
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* srow = S + (ty * 4 + (i & 3) + (i >> 2) * 64) * KNN_SLD;
      *reinterpret_cast<float4*>(srow + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(srow + 64 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    knn_fold_tile(S, ls, li, r, row0, col0, n);
    __syncthreads();
  }
  knn_write(ls, li, r, row0, n, out_idx, out_score);
}

size_t smem_bytes(int r) {
  return sizeof(float) * (2 * DK * ALD + KNN_BR * KNN_SLD) + knn_list_bytes(r);
}

}  // namespace

// x [n, d] f32, 16-byte aligned, d a multiple of 4; out_idx [n, r] int32,
// out_score [n, r] f32; 1 <= r <= 128.
PPT_EXPORT int ppt_knn_topk(const float* x, int* out_idx, float* out_score, int n, int d, int r,
                            void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || r < 1 || r > KNN_MAX_R) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(knn_exact, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (n + KNN_BR - 1) / KNN_BR;
  knn_exact<<<blocks, KNN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(x, out_idx, out_score,
                                                                             n, d, r);
  return cudaGetLastError();
}

// Dynamic shared memory for r candidates a row, for the wrapper's check.
PPT_EXPORT size_t ppt_knn_topk_smem(int r) { return smem_bytes(r); }
