// Exact cosine kNN candidates: f32-faithful 3xTF32 tile scores on the tensor
// cores, fused with a running top-R.
//
// Replaces plotpointe_tpu/ops/knn_kernel.py::_knn_kernel (launched in
// knn_topk_pallas). For L2-normalised rows x [n, d] f32 it writes, per row,
// the R best columns by score x[row] . x[col] (self and padding excluded;
// equal scores by smaller column) to out_idx [n, R] int32 and out_score
// [n, R] f32, descending; slots no column reached hold -1 / -1e30. The
// wrapper re-scores these candidates exactly and keeps the top k.
//
// Numerics. The TPU kernel scores at Precision.HIGHEST, several bf16 passes
// on its matrix unit that together are f32-faithful. Hopper's counterpart is
// 3xTF32: the wrapper splits x once into hi (x rounded to the nearest TF32
// value, its 13 low mantissa bits zero) and lo = x - hi (exact in f32,
// |lo| <= 2^-11 |x|); the kernel sums lo.hi^T, then hi.lo^T, then hi.hi^T
// into f32 accumulators with wgmma m64n128k8 TF32 (the tensor core reads lo
// truncated to TF32). The dropped lo.lo^T term and lo's truncation leave an
// error near 1e-7 on unit rows, well inside the 1e-5 the kernel is held to.
//
// What bounds it on this card: the TF32 operations, 3 passes of the product
// at 495 TFLOP/s: 3 n (n - 1) d for the distinct pairs of the symmetric
// scores, 6 n^2 d for the full matrix this row-owned design computes (the
// f32 pipe, 67 TFLOP/s, would take 2.5x the 3-pass time). The bytes (hi and
// lo read once) are negligible.
//
// Design: knn.cuh's sweep (128 rows a block, 128-wide column tiles, a
// 2-stage cp.async ring, wgmma from shared memory, the selection filtered in
// registers). A stage holds 16 features of hi and lo for the block's rows
// and the tile's columns: four [128][16] f32 panels of 64-byte rows, 32 KB,
// each row's four 16-byte quarters permuted by bits 1-2 of the row (wgmma's
// 64-byte swizzle). Each warpgroup issues six wgmma m64n128k8 TF32 a chunk
// (8-feature chunks, three wgmma between barriers, spent more on the
// barriers than on the products). Shared memory at R = 28: the ring 64 KB
// (+1 KB to align it), survivors 16.5 KB, lists 28 KB: 109.5 KB, so two
// blocks share an SM. No atomics on floats: the result is deterministic.
#include "knn.cuh"

namespace {

struct Tf32x3 {
  static constexpr int DK = 16;  // features a chunk: 64-byte rows
  const float* hi;
  const float* lo;

  // Panel op (0 hi rows, 1 lo rows, 2 hi columns, 3 lo columns; 8 KB each)
  // row rr, 16-byte quarter c (features 4c..4c+3) goes to byte op*8192 +
  // rr*64 + 16 (c ^ bits 1-2 of rr) (wgmma's 64-byte swizzle). Thread t
  // copies quarter t % 4 of rows t / 4 and 64 + t / 4 of each panel. d is a
  // multiple of 4, so a quarter is all in range or all out.
  __device__ __forceinline__ void load(unsigned char* stage, int row0, int col0, int k0, int n,
                                       int d) const {
    const int c = threadIdx.x & 3, k = k0 + 4 * c;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int op = i >> 1, rr = (threadIdx.x >> 2) + 64 * (i & 1);
      const int grow = (op < 2 ? row0 : col0) + rr;
      const float* base = (op & 1) ? lo : hi;
      const bool ok = grow < n && k < d;
      cp_async16(stage + op * 8192 + rr * 64 + 16 * (c ^ ((rr >> 1) & 3)),
                 ok ? base + static_cast<long long>(grow) * d + k : base, ok);
    }
  }

  // Warpgroup w multiplies its 64 rows by the tile's 128 columns in three
  // TF32 passes a k8 step, the small terms first: lo.hi^T, hi.lo^T, hi.hi^T;
  // the second k8 step starts 32 bytes further along the rows.
  __device__ __forceinline__ void mma(const unsigned char* stage, float (&acc)[16][4]) const {
    const int a0 = (threadIdx.x >> 7) * 64 * 64;  // this warpgroup's rows
    const unsigned long long a_hi = wgmma_desc(stage + a0, 64, SWIZZLE_64B);
    const unsigned long long a_lo = wgmma_desc(stage + 8192 + a0, 64, SWIZZLE_64B);
    const unsigned long long b_hi = wgmma_desc(stage + 16384, 64, SWIZZLE_64B);
    const unsigned long long b_lo = wgmma_desc(stage + 24576, 64, SWIZZLE_64B);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; kk += 2) {
      wgmma_tf32(acc, a_lo + kk, b_hi + kk);
      wgmma_tf32(acc, a_hi + kk, b_lo + kk);
      wgmma_tf32(acc, a_hi + kk, b_hi + kk);
    }
    wgmma_commit();
  }
};

__global__ void __launch_bounds__(KNN_THREADS, 2)
    knn_exact(const float* __restrict__ hi, const float* __restrict__ lo, int* __restrict__ out_idx,
              float* __restrict__ out_score, int n, int d, int r) {
  knn_sweep(Tf32x3{hi, lo}, out_idx, out_score, n, d, r);
}

}  // namespace

// hi, lo [n, d] f32 (hi + lo = x, hi TF32-exact), 16-byte aligned, d a
// multiple of 4; out_idx [n, r] int32, out_score [n, r] f32; 1 <= r <= 128.
PPT_EXPORT int ppt_knn_topk(const float* hi, const float* lo, int* out_idx, float* out_score, int n,
                            int d, int r, void* stream) {
  if (n <= 0 || d <= 0 || d % 4 != 0 || r < 1 || r > KNN_MAX_R) return cudaErrorInvalidValue;
  return knn_launch(knn_exact, n, r, stream, hi, lo, out_idx, out_score, n, d, r);
}

// Dynamic shared memory for r candidates a row, for the wrapper's check.
PPT_EXPORT size_t ppt_knn_topk_smem(int r) { return knn_smem_bytes(r); }
