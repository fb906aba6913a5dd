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
// Design: one block per (selected chunk, query), or per quarter or half of
// one where the batch gives too few blocks to fill the card (a single
// request's 40 chunks), one thread per row. A chunk is 128 contiguous rows,
// so the block stages its rows into shared memory with 16-byte cp.async
// copies, consecutive threads on consecutive bytes, in pieces of 256 bytes
// of every row (128 where the grid takes several waves, so that more blocks
// are resident), two pieces in flight; a piece's 16-byte slots are
// XOR-swizzled by row, so thread t reading row t's slot v hits eight
// distinct bank groups in each phase. Thread t then sums d = 0..D-1 in
// order with one f32 FMA each, the query in shared memory as f32: the order
// of the earlier per-row design, so the bits are the same. Blocks are
// ordered by rank j first, query second: the first selection writes each
// query's chunk ids ascending, so the blocks in flight together read
// neighbouring chunks, and a chunk picked by several queries of a batch is
// read from device memory about once and from the L2 for the others.
#include "tensor_core.cuh"

namespace {

constexpr int STAGES = 2;  // pieces in flight
// bytes of each row staged at a time: 256 where the grid fits the card in
// one wave, 128 where it takes several (half the shared memory, twice the
// blocks resident)
constexpr int WIDE_PIECE = 256, NARROW_PIECE = 128;

size_t rs_smem(int rows, int d, int piece) {
  return ((static_cast<size_t>(d) * 4 + 15) & ~static_cast<size_t>(15)) +
         static_cast<size_t>(STAGES) * rows * piece;
}

template <typename T>
__global__ void __launch_bounds__(CHUNK) rescore(const T* __restrict__ x, const T* __restrict__ q,
                                                 const int* __restrict__ chunk_id,
                                                 float* __restrict__ out, int n, int b, int d,
                                                 int r, int piece) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Raw = typename RowVec<T>::Raw;  // 16 bytes of a row
  constexpr int V = RowVec<T>::kElems;
  const int rows = blockDim.x, t = threadIdx.x, parts = CHUNK / rows;
  const int pair = blockIdx.x / parts, part = blockIdx.x - pair * parts;
  const int j = pair / b, bq = pair - j * b;
  float* qs = reinterpret_cast<float*>(smem);  // [d]
  unsigned char* ring = smem + ((static_cast<size_t>(d) * 4 + 15) & ~static_cast<size_t>(15));
  const long long first =
      static_cast<long long>(chunk_id[static_cast<long long>(bq) * r + j]) * CHUNK + part * rows;
  const int live = static_cast<int>(max(0LL, min(static_cast<long long>(rows), n - first)));
  const unsigned char* base = reinterpret_cast<const unsigned char*>(x + first * d);
  const int row_bytes = d * static_cast<int>(sizeof(T));
  const int pieces = (row_bytes + piece - 1) / piece;

  auto issue = [&](int p) {  // piece p of the live rows into its ring stage
    const int pb = min(piece, row_bytes - p * piece), nv = pb >> 4, swz = (nv & 7) ? 0 : 7;
    unsigned char* dst = ring + (p % STAGES) * rows * piece;
    // slot i = rr * nv + v of the piece, i = t, t + rows, ...: rr and v
    // stepped without a division
    const int drr = rows / nv, dv = rows - drr * nv;
    int rr = t / nv, v = t - rr * nv;
    for (int i = t; i < live * nv; i += rows) {
      cp_async16(dst + rr * pb + ((v ^ (rr & swz)) << 4),
                 base + static_cast<long long>(rr) * row_bytes + p * piece + (v << 4), true);
      rr += drr;
      v += dv;
      if (v >= nv) {
        v -= nv;
        ++rr;
      }
    }
    cp_async_commit();
  };
  issue(0);
  if (pieces > 1) issue(1);
  for (int f = t; f < d; f += rows) qs[f] = to_f32(q[static_cast<long long>(bq) * d + f]);

  float s = 0.f;
  for (int p = 0; p < pieces; ++p) {
    if (p + 1 < pieces) cp_async_wait_pending<1>(); else cp_async_wait_pending<0>();
    __syncthreads();
    if (t < live) {
      const int pb = min(piece, row_bytes - p * piece), nv = pb >> 4, swz = (nv & 7) ? 0 : 7;
      const unsigned char* src = ring + (p % STAGES) * rows * piece + t * pb;
      const float* qp = qs + p * (piece / static_cast<int>(sizeof(T)));
      for (int v = 0; v < nv; ++v) {
        float xv[V];
        widen(*reinterpret_cast<const Raw*>(src + ((v ^ (t & swz)) << 4)), xv);
#pragma unroll
        for (int h = 0; h < V; h += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(qp + v * V + h);
          s = fmaf(qa.x, xv[h], s);
          s = fmaf(qa.y, xv[h + 1], s);
          s = fmaf(qa.z, xv[h + 2], s);
          s = fmaf(qa.w, xv[h + 3], s);
        }
      }
    }
    __syncthreads();
    if (p + STAGES < pieces) issue(p + STAGES);
  }
  out[(static_cast<long long>(bq) * r + j) * CHUNK + part * rows + t] = t < live ? s : NEG_INF;
}

template <typename T>
cudaError_t launch(const void* x, const void* q, const int* chunk_id, float* out, int n, int b,
                   int r, int d, cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> opted{0};
  err = opt_in_smem(rescore<T>, opted, dev);
  if (err != cudaSuccess) return err;
  // whole chunks a block where the batch fills the card twice over, else
  // halves or quarters of them
  const int sms = device_sm_count(dev);
  const long long pairs = static_cast<long long>(b) * r;
  int rows = CHUNK;
  while (rows > 32 && pairs * (CHUNK / rows) < 2LL * sms) rows >>= 1;
  const long long blocks = pairs * (CHUNK / rows);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int piece = blocks > 3LL * sms ? NARROW_PIECE : WIDE_PIECE;  // 3 wide blocks fit an SM
  rescore<T><<<static_cast<unsigned>(blocks), rows, rs_smem(rows, d, piece), st>>>(
      static_cast<const T*>(x), static_cast<const T*>(q), chunk_id, out, n, b, d, r, piece);
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

// Dynamic shared memory of a whole-chunk block at width d, for the wrapper's check.
PPT_EXPORT size_t ppt_topk_rescore_smem(int d) { return rs_smem(CHUNK, d, WIDE_PIECE); }
