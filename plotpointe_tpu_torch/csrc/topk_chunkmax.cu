// Top-K retrieval phase 1: per-chunk maxima of the query-item scores.
//
// Replaces plotpointe_tpu/ops/topk_kernel.py::_chunkmax_kernel (launched in
// topk_mips_pallas). For queries Q [B, D] and a catalog X [N, D] (f32 or
// bf16, both in the table's type), writes out[b, c] = max over the items i of
// chunk c (i in [128c, min(128c + 128, N))) of the f32 score Q[b] . X[i].
// Items past N are never read; out is a dense [B, ceil(N / 128)].
//
// What bounds it: the catalog stream (N * D * itemsize bytes, read once) at
// small B; the 2 * B * N * D multiply-adds on the CUDA cores at B = 64 in
// f32. This version uses no tensor cores.
//
// Design: one block of 128 threads per 128-item chunk and per slab of up to
// NQ queries (blockIdx.y; NQ = 8, 16, 32 or 64 chosen from B). The query slab
// sits in shared memory, transposed ([D][NQ]) so one 16-byte broadcast load
// gives four queries' weights for one feature. Thread i owns item i: it reads
// its row straight from global memory in 16-byte loads, four in flight, and
// keeps NQ running sums in registers. The chunk max is a warp max then a max
// over the 4 warps. The [B, N] scores never leave the SM. Each dot product
// sums d = 0..D-1 in order with f32 FMAs, exactly as the rescore kernel does,
// so the phase-2 score of an item equals the score its chunk max was taken
// over.
#include "common.cuh"

namespace {

template <typename T, int NQ>
__global__ void __launch_bounds__(CHUNK) chunkmax(const T* __restrict__ x,
                                                  const T* __restrict__ q,
                                                  float* __restrict__ out, int n, int b, int d,
                                                  int n_chunks) {
  extern __shared__ __align__(16) float qs[];  // [d][NQ]
  __shared__ float red[CHUNK / 32][NQ];
  constexpr int V = RowVec<T>::kElems;

  const int c = blockIdx.x;
  const int q0 = blockIdx.y * NQ;
  const int nq = min(NQ, b - q0);
  for (int idx = threadIdx.x; idx < NQ * d; idx += blockDim.x) {
    const int t = idx / d, f = idx - t * d;
    qs[f * NQ + t] = t < nq ? to_f32(q[static_cast<long long>(q0 + t) * d + f]) : 0.f;
  }
  __syncthreads();

  const int i = threadIdx.x;
  const int warp = i >> 5, lane = i & 31;
  const long long item = static_cast<long long>(c) * CHUNK + i;
  float acc[NQ];
#pragma unroll
  for (int t = 0; t < NQ; ++t) acc[t] = 0.f;
  if (item < n) {
    const T* row = x + item * d;
    for (int f0 = 0; f0 < d; f0 += ROW_ILP * V) {
      float xv[ROW_ILP][V];
#pragma unroll
      for (int u = 0; u < ROW_ILP; ++u)
        if (f0 + u * V < d) RowVec<T>::load(row + f0 + u * V, xv[u]);
#pragma unroll
      for (int u = 0; u < ROW_ILP; ++u) {
        if (f0 + u * V >= d) break;
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const float4* qf = reinterpret_cast<const float4*>(qs + (f0 + u * V + e) * NQ);
#pragma unroll
          for (int t4 = 0; t4 < NQ / 4; ++t4) {
            const float4 w = qf[t4];
            acc[4 * t4 + 0] = fmaf(w.x, xv[u][e], acc[4 * t4 + 0]);
            acc[4 * t4 + 1] = fmaf(w.y, xv[u][e], acc[4 * t4 + 1]);
            acc[4 * t4 + 2] = fmaf(w.z, xv[u][e], acc[4 * t4 + 2]);
            acc[4 * t4 + 3] = fmaf(w.w, xv[u][e], acc[4 * t4 + 3]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NQ; ++t) {
    const float m = warp_max(item < n ? acc[t] : NEG_INF);
    if (lane == 0) red[warp][t] = m;
  }
  __syncthreads();
  if (i < nq) {
    float m = red[0][i];
#pragma unroll
    for (int w = 1; w < CHUNK / 32; ++w) m = fmaxf(m, red[w][i]);
    out[static_cast<long long>(q0 + i) * n_chunks + c] = m;
  }
}

template <typename T, int NQ>
cudaError_t launch(const void* x, const void* q, float* out, int n, int b, int d,
                   cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d) * NQ;
  cudaError_t err = cudaFuncSetAttribute(chunkmax<T, NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const dim3 grid(n_chunks, (b + NQ - 1) / NQ);
  chunkmax<T, NQ><<<grid, CHUNK, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(q),
                                             out, n, b, d, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* q, float* out, int n, int b, int d,
                     cudaStream_t st) {
  if (b <= 8) return launch<T, 8>(x, q, out, n, b, d, st);
  if (b <= 16) return launch<T, 16>(x, q, out, n, b, d, st);
  if (b <= 32) return launch<T, 32>(x, q, out, n, b, d, st);
  return launch<T, 64>(x, q, out, n, b, d, st);
}

}  // namespace

// x [n, d], q [b, d] (both f32, or both bf16 when bf16 != 0), x 16-byte
// aligned and d a multiple of 16 / itemsize; out [b, ceil(n / 128)] f32.
PPT_EXPORT int ppt_topk_chunkmax(const void* x, const void* q, float* out, int n, int b, int d,
                                 int bf16, void* stream) {
  if (n <= 0 || b <= 0 || d <= 0 || d % (bf16 ? 8 : 4) != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(x, q, out, n, b, d, st)
              : dispatch<float>(x, q, out, n, b, d, st);
}

// Dynamic shared memory of the largest query slab, for the wrapper's check.
PPT_EXPORT size_t ppt_topk_chunkmax_smem(int d) { return sizeof(float) * static_cast<size_t>(d) * 64; }
