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
// Design: knn.cuh's sweep (128 rows a block, 128-wide column tiles, a
// 2-stage cp.async ring, wgmma from shared memory, the selection filtered in
// registers). A stage holds 64 features of the block's rows and of the
// tile's columns: two [128][64] bf16 panels of 128-byte rows, 32 KB, each
// row's eight 16-byte pieces permuted by bits 0-2 of the row (wgmma's
// 128-byte swizzle). Each warpgroup issues four wgmma m64n128k16 a chunk.
// Shared memory at R = 29: the ring 64 KB (+1 KB to align it), survivors
// 16.5 KB, lists 29 KB: 110.5 KB, two blocks an SM. The TPU kernel's slot
// pre-reduction (an economy of its vector unit) is not copied: the
// selection is the exact top-R of these scores, as in exact mode.
#include "knn.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Bf16 {
  static constexpr int DK = 64;  // features a chunk: 128-byte rows
  const bf16* x;

  // Panel 0 the block's rows, panel 1 the tile's columns (16 KB each): row
  // rr's 16-byte eighth c (features 8c..8c+7) goes to byte op*16384 +
  // rr*128 + 16 (c ^ bits 0-2 of rr) (wgmma's 128-byte swizzle). Thread t
  // copies eighth t % 8 of rows t / 8 + 32 i of each panel. d is a multiple
  // of 8, so an eighth is all in range or all out.
  __device__ __forceinline__ void load(unsigned char* stage, int row0, int col0, int k0, int n,
                                       int d) const {
    const int c = threadIdx.x & 7, k = k0 + 8 * c;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int op = i >> 2, rr = (threadIdx.x >> 3) + 32 * (i & 3);
      const int grow = (op ? col0 : row0) + rr;
      const bool ok = grow < n && k < d;
      cp_async16(stage + op * 16384 + rr * 128 + 16 * (c ^ (rr & 7)),
                 ok ? x + static_cast<long long>(grow) * d + k : x, ok);
    }
  }

  // Warpgroup w multiplies its 64 rows (panel 0, rows 64w..) by the tile's
  // 128 columns (panel 1): four k16 steps, each 32 bytes further along the
  // 128-byte swizzled rows.
  __device__ __forceinline__ void mma(const unsigned char* stage, float (&acc)[16][4]) const {
    const unsigned long long da =
        wgmma_desc(stage + (threadIdx.x >> 7) * 64 * 128, 128, SWIZZLE_128B);
    const unsigned long long db = wgmma_desc(stage + 16384, 128, SWIZZLE_128B);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; kk += 2) wgmma_bf16(acc, da + kk, db + kk);
    wgmma_commit();
  }
};

__global__ void __launch_bounds__(KNN_THREADS, 2)
    knn_fast(const bf16* __restrict__ x, int* __restrict__ out_idx, float* __restrict__ out_score,
             int n, int d, int r) {
  knn_sweep(Bf16{x}, out_idx, out_score, n, d, r);
}

}  // namespace

// xb [n, d] bf16, 16-byte aligned, d a multiple of 8; out_idx [n, r] int32,
// out_score [n, r] f32; 1 <= r <= 128.
PPT_EXPORT int ppt_knn_topk_fast(const void* xb, int* out_idx, float* out_score, int n, int d,
                                 int r, void* stream) {
  if (n <= 0 || d <= 0 || d % 8 != 0 || r < 1 || r > KNN_MAX_R) return cudaErrorInvalidValue;
  return knn_launch(knn_fast, n, r, stream, static_cast<const bf16*>(xb), out_idx, out_score, n, d,
                    r);
}

// Dynamic shared memory for r candidates a row, for the wrapper's check.
PPT_EXPORT size_t ppt_knn_topk_fast_smem(int r) { return knn_smem_bytes(r); }
