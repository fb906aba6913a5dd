// Read-stream probe: the delivered memory rate of the card.
//
// Replaces plotpointe_tpu/utils/profiling.py::_stream_probe_kernel (launched
// by measure_device_peaks, :143-155), with its exact output: x [M, D] bf16
// cut into blocks of BM rows; block g's eight slabs of BM/8 rows each fold
// to one output row:
//   out[8 g + r, l] = max over slab r of block g and over the columns
//                     j = l (mod 128) of x, as f32, + c
// (a slab is BM/8 contiguous rows, so out row s is the s-th run of
// BM/8 * D contiguous elements). Max is exact, so the order of the fold is
// free and the result equals the plain version's bit for bit (NaN aside:
// fmaxf drops a NaN that jnp.max would keep; the probe's data has none).
//
// What bounds it: bytes. It reads x once (256 MB at the probe's shape) and
// writes M / BM * 8 * 128 f32; 1 operation per element read. 268 MB at 3.35
// TB/s is 0.080 ms.
//
// Design: one block of 256 threads per slab (512 blocks at the probe's
// shape: all resident at once on 132 SMs). Thread t walks the slab's 16-byte
// chunks t, t + 256, ..., 8 loads in flight per thread (32 KB per block) to
// cover the memory latency; as D is a multiple of 128, chunk f covers
// output lanes 8 (f mod 16) .. 8 (f mod 16) + 7, so a thread always feeds
// the same 8 lanes. Lanes l and l + 16 of a warp share lanes and fold by
// one shuffle; the 8 warps fold through shared memory, and 128 threads
// write the slab's output row once.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ILP = 8;  // 16-byte loads in flight per thread

__global__ void stream_probe(const __nv_bfloat16* __restrict__ x, float c, float* __restrict__ out,
                             long long slab_chunks) {
  __shared__ float part[WARPS][16][8];
  const __nv_bfloat16* base = x + static_cast<long long>(blockIdx.x) * slab_chunks * 8;
  float m[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = -CUDART_INF_F;
  for (long long f0 = threadIdx.x; f0 < slab_chunks; f0 += static_cast<long long>(THREADS) * ILP) {
    float v[ILP][8];
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      const long long f = f0 + static_cast<long long>(q) * THREADS;
      if (f < slab_chunks) {
        RowVec<__nv_bfloat16>::load(base + f * 8, v[q]);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[q][k] = -CUDART_INF_F;
      }
    }
#pragma unroll
    for (int q = 0; q < ILP; ++q)
#pragma unroll
      for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], v[q][k]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = fmaxf(m[k], __shfl_xor_sync(FULL_MASK, m[k], 16));
  if (lane < 16) {
#pragma unroll
    for (int k = 0; k < 8; ++k) part[warp][lane][k] = m[k];
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    const int grp = threadIdx.x >> 3, k = threadIdx.x & 7;
    float r = part[0][grp][k];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) r = fmaxf(r, part[w][grp][k]);
    out[static_cast<long long>(blockIdx.x) * 128 + threadIdx.x] = r + c;
  }
}

}  // namespace

// x [m, d] bf16, 16-byte aligned; out [m / bm * 8, 128] f32. d a multiple
// of 128, bm a multiple of 8 dividing m.
PPT_EXPORT int ppt_stream_probe(const void* x, float c, float* out, int m, int d, int bm,
                                void* stream) {
  if (m <= 0 || d <= 0 || d % 128 != 0 || bm <= 0 || bm % 8 != 0 || m % bm != 0) {
    return cudaErrorInvalidValue;
  }
  const int slabs = m / bm * 8;
  const long long slab_chunks = static_cast<long long>(bm / 8) * d / 8;
  stream_probe<<<slabs, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), c, out, slab_chunks);
  return cudaGetLastError();
}
