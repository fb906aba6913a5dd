// Top-K retrieval phase 2: exact f32 scores of the selected chunks' items.
//
// Replaces plotpointe_tpu/ops/topk_kernel.py::_rescore_kernel (launched by
// _rescore_call). For each query b and each of its R selected chunk ids
// c = chunk_id[b, j], writes out[b, j, t] = Q[b] . X[128c + t] in f32 (both
// operands upcast from the table's type), and NEG_INF for 128c + t >= N;
// items past N are never read.
//
// What bounds it: bytes. It reads R chunks of 128 rows per query
// (R * 128 * D * itemsize), a small fraction of the catalog; the arithmetic
// is 2 FLOP per element read.
//
// Design: one block of 128 threads per (selected chunk, query). The query row
// sits in shared memory as f32; thread t reads item t's row straight from
// global memory in 16-byte loads, four in flight, and sums d = 0..D-1 in
// order with f32 FMAs, exactly as the chunk-max kernel does.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(CHUNK) rescore(const T* __restrict__ x,
                                                 const T* __restrict__ q,
                                                 const int* __restrict__ chunk_id,
                                                 float* __restrict__ out, int n, int d, int r) {
  extern __shared__ __align__(16) float qs[];  // [d]
  constexpr int V = RowVec<T>::kElems;
  const int j = blockIdx.x, b = blockIdx.y;
  for (int f = threadIdx.x; f < d; f += blockDim.x) qs[f] = to_f32(q[static_cast<long long>(b) * d + f]);
  __syncthreads();

  const long long item =
      static_cast<long long>(chunk_id[static_cast<long long>(b) * r + j]) * CHUNK + threadIdx.x;
  float s = NEG_INF;
  if (item < n) {
    const T* row = x + item * d;
    s = 0.f;
    for (int f0 = 0; f0 < d; f0 += ROW_ILP * V) {
      float xv[ROW_ILP][V];
#pragma unroll
      for (int u = 0; u < ROW_ILP; ++u)
        if (f0 + u * V < d) RowVec<T>::load(row + f0 + u * V, xv[u]);
#pragma unroll
      for (int u = 0; u < ROW_ILP; ++u) {
        if (f0 + u * V >= d) break;
#pragma unroll
        for (int e = 0; e < V; ++e) s = fmaf(qs[f0 + u * V + e], xv[u][e], s);
      }
    }
  }
  out[(static_cast<long long>(b) * r + j) * CHUNK + threadIdx.x] = s;
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const int* chunk_id, float* out, int n, int b,
                   int r, int d, cudaStream_t st) {
  const size_t smem = sizeof(float) * static_cast<size_t>(d);
  cudaError_t err = cudaFuncSetAttribute(rescore<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  rescore<T><<<dim3(r, b), CHUNK, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(q),
                                              chunk_id, out, n, d, r);
  return cudaGetLastError();
}

}  // namespace

// x [n, d], q [b, d] (both f32, or both bf16 when bf16 != 0), x 16-byte
// aligned and d a multiple of 16 / itemsize; chunk_id [b, r] int32 in
// [0, ceil(n / 128)); out [b, r, 128] f32.
PPT_EXPORT int ppt_topk_rescore(const void* x, const void* q, const int* chunk_id, float* out,
                                int n, int b, int r, int d, int bf16, void* stream) {
  if (n <= 0 || b <= 0 || r <= 0 || d <= 0 || d % (bf16 ? 8 : 4) != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, q, chunk_id, out, n, b, r, d, st)
              : launch<float>(x, q, chunk_id, out, n, b, r, d, st);
}

PPT_EXPORT size_t ppt_topk_rescore_smem(int d) { return sizeof(float) * static_cast<size_t>(d); }
