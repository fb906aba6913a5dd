// Sampled-eval ranks: each eval user's positive and neg_k negatives scored in
// f32 and ranked against each other in one pass.
//
// Replaces no TPU kernel: the JAX package's `_eval_chunk`
// (plotpointe_tpu/train/evaluate.py) scores every item for a chunk of users
// with one XLA product and gathers the 1 + neg_k candidates of each user from
// it, and the port did the same with a dense f32 product, which computed and
// wrote ~63 times the scores the ranks need. For user b of a chunk (row
// users[b] of U), with the positive pos[b] and the negatives negs[b, :]:
//   rank[b] = 1 + #{j : s(negs[b, j]) > s(pos[b])}, or neg_k + 2 where
//             s(pos[b]) is not finite;
//   ties[b] = #{j : s(negs[b, j]) == s(pos[b])};
// every negative slot counts, repeats included. Each score s(i) is one f32 FMA
// chain over d = 0 .. D-1 in ascending order from 0, the order in which a
// non-split-K f32 product on the CUDA cores accumulates, and the positive and
// the negatives are scored by the same code, so equal rows tie exactly.
//
// What bounds it: bytes. It reads (1 + neg_k) rows of I per user (D * 4 bytes
// each) and does 2 FLOP per element read. The rows are drawn uniformly, so
// nothing is reused inside a block; at the eval's shapes (63,001 x 128 f32 =
// 32 MB) the table stays in the 50 MB L2, which serves the reads.
//
// Design: one block of ROWS threads per user, the user's row in shared memory
// (read by broadcast). The block walks its candidates in tiles of ROWS rows,
// one row a thread; candidate 0 is the positive. A tile's rows are staged into
// shared memory PIECE bytes of each row at a time with 16-byte cp.async
// copies (consecutive threads on consecutive bytes of a row, so a warp's copy
// is whole 128-byte lines), STAGES pieces in flight, the item ids of the next
// tiles staged ahead in a ring of 4. A piece's 16-byte slots are XOR-swizzled
// by row so that thread t reading its row's slot v hits eight distinct bank
// groups in each quarter-warp phase. Thread t carries its row's chain across
// the pieces; at a tile's end it compares the score with the positive's (the
// first tile's thread 0 publishes it) and counts. A block reduction of the
// two counts ends with one store per user. On an H100 at 2,048 users x 1,001
// candidates of 63,001 x 128 this takes 0.29 ms; threads walking whole rows
// straight from the L2 in 16-byte loads took 0.43 ms (a warp's load then
// touches 32 lines), pieces of 64 or 256 bytes 0.29-0.30 ms (256 lost 8% at
// D 64).
#include "tensor_core.cuh"

namespace {

constexpr int ROWS = 128;  // candidates a tile, one a thread
constexpr int PIECE = 128;  // bytes of each row staged at a time: 8 slots of 16 bytes
constexpr int SLOTS = PIECE / 16;
constexpr int STAGES = 2;  // pieces in flight
constexpr int ID_RING = 4;  // tiles of item ids staged

size_t er_smem(int d) {
  return static_cast<size_t>(d) * 4 + static_cast<size_t>(ID_RING) * ROWS * 4 +
         static_cast<size_t>(STAGES) * ROWS * PIECE;
}

__device__ __forceinline__ void count_and_store(int gt, int eq, float ps, int neg_k, int b,
                                                int* rank, int* ties) {
  __shared__ int red[2][ROWS / 32];
  const int t = threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    gt += __shfl_xor_sync(FULL_MASK, gt, o);
    eq += __shfl_xor_sync(FULL_MASK, eq, o);
  }
  if ((t & 31) == 0) {
    red[0][t >> 5] = gt;
    red[1][t >> 5] = eq;
  }
  __syncthreads();
  if (t == 0) {
    int g = 0, e = 0;
#pragma unroll
    for (int w = 0; w < ROWS / 32; ++w) {
      g += red[0][w];
      e += red[1][w];
    }
    rank[b] = isfinite(ps) ? 1 + g : neg_k + 2;
    ties[b] = e;
  }
}

__global__ void __launch_bounds__(ROWS) eval_rank(
    const float* __restrict__ u_tab, const float* __restrict__ i_tab, const int* __restrict__ users,
    const int* __restrict__ pos, const int* __restrict__ negs, int* __restrict__ rank,
    int* __restrict__ ties, int d, int neg_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float pos_score;
  const int t = threadIdx.x, b = blockIdx.x;
  float* us = reinterpret_cast<float*>(smem);  // [d]
  int* ids = reinterpret_cast<int*>(smem + static_cast<size_t>(d) * 4);  // [ID_RING][ROWS]
  unsigned char* ring = smem + static_cast<size_t>(d) * 4 + ID_RING * ROWS * 4;
  const int n_cand = neg_k + 1, tiles = (n_cand + ROWS - 1) / ROWS;
  const int row_bytes = d * 4, pieces = (row_bytes + PIECE - 1) / PIECE, steps = tiles * pieces;
  const int* my_negs = negs + static_cast<long long>(b) * neg_k;

  auto put_ids = [&](int k) {  // the item ids of tile k, -1 past the candidates
    const int c = k * ROWS + t;
    if (k < tiles)
      ids[(k % ID_RING) * ROWS + t] = c >= n_cand ? -1 : (c == 0 ? pos[b] : my_negs[c - 1]);
  };
  auto issue = [&](int q) {  // step q's piece of its tile's rows into its ring stage
    if (q < steps) {
      const int k = q / pieces, p = q - k * pieces;
      const int nv = min(PIECE, row_bytes - p * PIECE) >> 4;
      unsigned char* dst = ring + (q % STAGES) * ROWS * PIECE;
      const int* tid = ids + (k % ID_RING) * ROWS;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(i_tab) + p * PIECE;
      // slot i = r * nv + v, i = t, t + ROWS, ...: r and v stepped without a division
      const int dr = ROWS / nv, dv = ROWS - dr * nv;
      int r = t / nv, v = t - r * nv;
      for (int i = t; i < ROWS * nv; i += ROWS) {
        const int id = tid[r];
        if (id >= 0)
          cp_async16(dst + r * PIECE + ((v ^ (r & 7)) << 4),
                     src + static_cast<long long>(id) * row_bytes + (v << 4), true);
        r += dr;
        v += dv;
        if (v >= nv) {
          v -= nv;
          ++r;
        }
      }
    }
    cp_async_commit();  // an empty group past the last step keeps the count
  };

  const float* urow = u_tab + static_cast<long long>(users[b]) * d;
  for (int f = t; f < d; f += ROWS) us[f] = urow[f];
  put_ids(0);
  put_ids(1);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < STAGES; ++q) issue(q);

  float s = 0.f, ps = 0.f;
  int gt = 0, eq = 0;
  for (int q = 0; q < steps; ++q) {
    const int k = q / pieces, p = q - k * pieces;
    cp_async_wait_pending<STAGES - 1>();
    __syncthreads();
    if (p == 0) put_ids(k + 2);
    const bool live = k * ROWS + t < n_cand;
    if (live) {
      const int nv = min(PIECE, row_bytes - p * PIECE) >> 4;
      const unsigned char* row = ring + (q % STAGES) * ROWS * PIECE + t * PIECE;
      const float* up = us + p * (PIECE / 4);
#pragma unroll
      for (int v = 0; v < SLOTS; ++v) {
        if (v >= nv) break;
        const float4 x = *reinterpret_cast<const float4*>(row + ((v ^ (t & 7)) << 4));
        const float4 a = *reinterpret_cast<const float4*>(up + 4 * v);
        s = fmaf(a.x, x.x, s);
        s = fmaf(a.y, x.y, s);
        s = fmaf(a.z, x.z, s);
        s = fmaf(a.w, x.w, s);
      }
    }
    const bool last = p == pieces - 1;
    if (last && k == 0 && t == 0) pos_score = s;
    __syncthreads();
    if (last) {
      ps = pos_score;
      if (live && (k > 0 || t > 0)) {
        gt += s > ps;
        eq += s == ps;
      }
      s = 0.f;
    }
    issue(q + STAGES);
  }
  count_and_store(gt, eq, ps, neg_k, b, rank, ties);
}

}  // namespace

// u [n_users, d], i [n_items, d] f32, 16-byte aligned, d a multiple of 4;
// users, pos [c] and negs [c, neg_k] int32 ids in range; rank, ties [c] int32.
PPT_EXPORT int ppt_eval_rank(const float* u, const float* it, const int* users, const int* pos,
                             const int* negs, int* rank, int* ties, int c, int d, int neg_k,
                             void* stream) {
  if (c <= 0 || d <= 0 || d % 4 != 0 || neg_k < 1 || neg_k > 0x7fffffff - ROWS)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  static std::atomic<unsigned long long> opted{0};
  err = opt_in_smem(eval_rank, opted, dev);
  if (err != cudaSuccess) return err;
  eval_rank<<<static_cast<unsigned>(c), ROWS, er_smem(d), static_cast<cudaStream_t>(stream)>>>(
      u, it, users, pos, negs, rank, ties, d, neg_k);
  return cudaGetLastError();
}

// Dynamic shared memory of a block at width d, for the wrapper's check.
PPT_EXPORT size_t ppt_eval_rank_smem(int d) { return er_smem(d); }
