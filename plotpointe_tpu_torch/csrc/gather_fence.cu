// Gather fence: the f32 sum of x[:8, :min(128, D)], broadcast to [8, 128].
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_gather_fence. On the TPU it is
// an opaque custom call that orders two large XLA row gathers in the
// attention backward. The port's backward gathers rows inside its kernels
// (gat_bwd_dst.cu, gat_bwd_src.cu), so no pair of gathers remains to order
// and the training step does not call it; it is ported as the function it
// computes. The JAX package folds the result into the next gather's table at
// 1e-30 scale; that fold (which spreads a NaN in the block to the whole
// table) is not carried over.
//
// What bounds it: launch latency. It reads at most 8 x 128 values and writes
// 1,024 floats.
//
// Design: one block of 128 threads. Thread c sums column c over the first
// (at most 8) rows in f32; the block sums the columns (warp shuffles, then
// four partials in shared memory, in a fixed order) and every thread writes
// eight of the 1,024 outputs.
#include "common.cuh"

namespace {

constexpr int LANES = 128;

template <typename T>
__global__ void fence(const T* __restrict__ x, int m, int d, float* __restrict__ out) {
  __shared__ float warp_part[LANES / 32];
  const int c = threadIdx.x;
  const int rows = min(8, m);
  const int lanes = min(LANES, d);
  float v = 0.f;
  if (c < lanes) {
    for (int r = 0; r < rows; ++r) v += to_f32(x[static_cast<long long>(r) * d + c]);
  }
  v = warp_sum(v);
  if ((c & 31) == 0) warp_part[c >> 5] = v;
  __syncthreads();
  const float total = (warp_part[0] + warp_part[1]) + (warp_part[2] + warp_part[3]);
  for (int i = c; i < 8 * LANES; i += LANES) out[i] = total;
}

}  // namespace

// x [m, d] (bf16 if bf16, else f32), m >= 1; writes out [8, 128] f32.
PPT_EXPORT int ppt_gather_fence(const void* x, int bf16, int m, int d, float* out, void* stream) {
  if (m <= 0 || d <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    fence<__nv_bfloat16><<<1, LANES, 0, st>>>(static_cast<const __nv_bfloat16*>(x), m, d, out);
  } else {
    fence<float><<<1, LANES, 0, st>>>(static_cast<const float*>(x), m, d, out);
  }
  return cudaGetLastError();
}
