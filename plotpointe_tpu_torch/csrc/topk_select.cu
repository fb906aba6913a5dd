// Top-K retrieval's two selections, between the chunk-max kernel, the
// rescore kernel and the caller: the top r entries of each row of an f32
// matrix [B, W], ties at equal value to the smaller position.
//
// Replaces the torch ops the port ran between its top-K kernels; the JAX
// package selects there with XLA ops, not Pallas (packed-key merge rounds or
// lax.top_k, plotpointe_tpu/ops/topk_kernel.py:296-323).
//
// Two modes, one function: rank each row's entries by (value descending,
// position ascending), keep the first r, and write an int32 id computed from
// each kept position.
//   FIRST (over the [B, n_chunks] chunk maxima): the ids are the positions
//     clamped to `clamp`, written in ascending order (no values). In that
//     order the rescore's output [B, r, 128] lists items in catalog order,
//     so the final selection's "smaller position" is the smaller item index,
//     and concurrent rescore blocks read neighbouring chunks.
//   FINAL (over the rescore's [B, R * 128] scores): values descending, ids
//     chunk_id[b, pos / 128] * 128 + pos % 128, or -1 where the value is
//     <= NEG_INF / 2 (no real candidate).
// Values are compared as order-preserving uint32 keys (-0 as +0, NaN below
// every number, as torch.sort orders them); nothing is computed on them, so
// the kernel gives its plain version's bits, positions included.
//
// What bounds it: latency. A row is a few thousand floats (15-20 KB at the
// served shapes); the work is a handful of passes over it on one SM.
//
// Design: one block of 512 threads per row. The row's keys go to shared
// memory (rows up to KEYS_CAP; longer rows are read from global memory on
// each pass). A radix select over 8-bit digits, most significant first,
// finds the r-th key: each pass histograms the keys that share the digits
// fixed so far, one warp scans the 256 bins from the top, and the pass stops
// early where the crossing bin is taken whole. A compaction then keeps every
// key above the threshold and the first ties at it in position order: each
// warp walks a contiguous segment in 32-wide steps with ballots, one block
// prefix over the warps' counts gives every kept entry its rank in position
// order. FIRST writes there. FINAL packs (key, ~position) into a uint64 and
// sorts the r survivors descending: a bitonic sort in shared memory up to
// SORT_CAP survivors; above it, the survivors go to a scratch buffer, tiles
// of SORT_CAP are sorted, and each survivor's rank is its rank in its tile
// plus, for every other tile, a binary search of how many entries there
// rank above it (the packed keys are distinct).
#include "common.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 256;
constexpr int KEYS_CAP = 32768;  // rows up to this long are held in shared memory
constexpr int SORT_CAP = 2048;   // survivors sorted in shared memory; above, through scratch
constexpr int FIRST = 0, FINAL = 1;

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned u = __float_as_uint(v);
  if ((u << 1) == 0) u = 0;                       // -0 ranks as +0
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0;  // NaN below every number
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long packed(unsigned key, int pos) {
  return (static_cast<unsigned long long>(key) << 32) | (0xffffffffu - static_cast<unsigned>(pos));
}

__device__ __forceinline__ int position_of(unsigned long long p) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(p));
}

// Block-wide bitonic sort of s[0, p2) into descending order; p2 a power of two.
__device__ void bitonic_desc(unsigned long long* s, int p2) {
  for (int k = 2; k <= p2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p2 / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (j - 1)), hi = lo + j;
        const unsigned long long a = s[lo], b = s[hi];
        if ((a < b) == ((lo & k) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// The FINAL mode's output at rank j of row `row`: the value's own bits and
// the item id of its position.
__device__ __forceinline__ void write_final(const float* __restrict__ xr, int row, int r, int rc,
                                            const int* __restrict__ chunk_id, int j,
                                            unsigned long long p, int* __restrict__ out_id,
                                            float* __restrict__ out_val) {
  const int pos = position_of(p);
  const float v = xr[pos];
  const int id = chunk_id[static_cast<long long>(row) * rc + pos / CHUNK] * CHUNK + pos % CHUNK;
  const long long o = static_cast<long long>(row) * r + j;
  out_id[o] = v > NEG_INF / 2 ? id : -1;
  out_val[o] = v;
}

template <bool IN_SMEM>
__global__ void __launch_bounds__(THREADS) select_rows(const float* __restrict__ x, int w, int r,
                                                       int mode, int clamp,
                                                       const int* __restrict__ chunk_id,
                                                       int* __restrict__ out_id,
                                                       float* __restrict__ out_val,
                                                       unsigned long long* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned hist[BINS];
  __shared__ unsigned warp_gt[WARPS], warp_eq[WARPS];
  __shared__ unsigned s_prefix, s_mask, s_above, s_done;
  const int row = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* xr = x + static_cast<long long>(row) * w;
  unsigned* keys = reinterpret_cast<unsigned*>(smem);  // [w] when IN_SMEM
  unsigned long long* sorted = reinterpret_cast<unsigned long long*>(
      smem + (IN_SMEM ? ((static_cast<size_t>(w) * 4 + 15) & ~static_cast<size_t>(15)) : 0));
  auto key_at = [&](int i) -> unsigned { return IN_SMEM ? keys[i] : order_key(__ldg(xr + i)); };
  if (IN_SMEM)
    for (int i = tid; i < w; i += THREADS) keys[i] = order_key(__ldg(xr + i));

  // radix select: the keys at or above the r-th share the digits in `mask`
  // with `prefix` or exceed them; `above` of them exceed them
  unsigned prefix = 0, mask = 0, above = 0;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < BINS; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < w; i += THREADS) {
      const unsigned k = key_at(i);
      if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 0xffu], 1u);
    }
    __syncthreads();
    if (warp == 0) {
      unsigned c[8], sum = 0;  // lane l: bins 255 - 8l down to 248 - 8l
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        c[e] = hist[BINS - 1 - 8 * lane - e];
        sum += c[e];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned t = __shfl_up_sync(FULL_MASK, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned need = static_cast<unsigned>(r) - above, excl = incl - sum;
      if (excl < need && need <= incl) {  // the lane whose bins the r-th key falls in
        unsigned cum = excl;
        int e = 0;
        while (cum + c[e] < need) cum += c[e++];
        s_prefix = prefix | (static_cast<unsigned>(BINS - 1 - 8 * lane - e) << shift);
        s_mask = mask | (0xffu << shift);
        s_above = above + cum;
        s_done = cum + c[e] == need;  // the bin is taken whole: no later digit matters
      }
    }
    __syncthreads();
    prefix = s_prefix;
    mask = s_mask;
    above = s_above;
    if (s_done) break;
  }
  const unsigned need = static_cast<unsigned>(r) - above;  // ties at the threshold to keep

  // compaction in position order: warp `warp` walks [lo, hi)
  const int seg = ((w + WARPS - 1) / WARPS + 31) & ~31;
  const int lo = warp * seg, hi = min(w, lo + seg);
  unsigned n_gt = 0, n_eq = 0;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const unsigned k = i < hi ? key_at(i) : 0;
    n_gt += __popc(__ballot_sync(FULL_MASK, i < hi && (k & mask) > prefix));
    n_eq += __popc(__ballot_sync(FULL_MASK, i < hi && (k & mask) == prefix));
  }
  if (lane == 0) {
    warp_gt[warp] = n_gt;
    warp_eq[warp] = n_eq;
  }
  __syncthreads();
  unsigned gt_base = 0, eq_base = 0;
  for (int v = 0; v < warp; ++v) {
    gt_base += warp_gt[v];
    eq_base += warp_eq[v];
  }
  const unsigned below = (1u << lane) - 1;
  const bool sort_smem = mode == FINAL && r <= SORT_CAP;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const unsigned k = i < hi ? key_at(i) : 0;
    const bool gt = i < hi && (k & mask) > prefix, eq = i < hi && (k & mask) == prefix;
    const unsigned bg = __ballot_sync(FULL_MASK, gt), be = __ballot_sync(FULL_MASK, eq);
    const unsigned eq_rank = eq_base + __popc(be & below);
    if (gt || (eq && eq_rank < need)) {
      const unsigned slot = gt_base + __popc(bg & below) + min(eq_rank, need);
      if (mode == FIRST) {
        const long long o = static_cast<long long>(row) * r + slot;
        out_id[o] = min(i, clamp);
        if (out_val) out_val[o] = xr[i];
      } else if (sort_smem) {
        sorted[slot] = packed(k, i);
      } else {
        scratch[static_cast<long long>(row) * r + slot] = packed(k, i);
      }
    }
    gt_base += __popc(bg);
    eq_base += __popc(be);
  }
  if (!sort_smem) return;

  int p2 = 1;
  while (p2 < r) p2 <<= 1;
  for (int i = r + tid; i < p2; i += THREADS) sorted[i] = 0;  // below every packed key
  __syncthreads();
  bitonic_desc(sorted, p2);
  for (int j = tid; j < r; j += THREADS)
    write_final(xr, row, r, w / CHUNK, chunk_id, j, sorted[j], out_id, out_val);
}

// FINAL above SORT_CAP survivors, step 1: sort each tile of SORT_CAP of a
// row's packed survivors descending, in place.
__global__ void __launch_bounds__(THREADS) sort_tiles(unsigned long long* __restrict__ scratch,
                                                      int r) {
  __shared__ unsigned long long s[SORT_CAP];
  unsigned long long* t = scratch + static_cast<long long>(blockIdx.y) * r +
                          static_cast<long long>(blockIdx.x) * SORT_CAP;
  const int len = min(SORT_CAP, r - static_cast<int>(blockIdx.x) * SORT_CAP);
  for (int i = threadIdx.x; i < SORT_CAP; i += THREADS) s[i] = i < len ? t[i] : 0;
  __syncthreads();
  bitonic_desc(s, SORT_CAP);
  for (int i = threadIdx.x; i < len; i += THREADS) t[i] = s[i];
}

// Step 2: each survivor's rank is its place in its own tile plus, in every
// other tile, the number of entries above it; write it there.
__global__ void rank_tiles(const unsigned long long* __restrict__ scratch,
                           const float* __restrict__ x, int w, int r,
                           const int* __restrict__ chunk_id, int* __restrict__ out_id,
                           float* __restrict__ out_val) {
  const int row = blockIdx.y, e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= r) return;
  const unsigned long long* s = scratch + static_cast<long long>(row) * r;
  const unsigned long long p = s[e];
  const int own = e / SORT_CAP, tiles = (r + SORT_CAP - 1) / SORT_CAP;
  int rank = e - own * SORT_CAP;
  for (int t = 0; t < tiles; ++t) {
    if (t == own) continue;
    const unsigned long long* tl = s + static_cast<long long>(t) * SORT_CAP;
    int a = 0, b = min(SORT_CAP, r - t * SORT_CAP);
    while (a < b) {
      const int m = (a + b) >> 1;
      if (tl[m] > p) a = m + 1; else b = m;
    }
    rank += a;
  }
  write_final(x + static_cast<long long>(row) * w, row, r, w / CHUNK, chunk_id, rank, p, out_id,
              out_val);
}

template <bool IN_SMEM>
cudaError_t launch_rows(const float* x, int b, int w, int r, int mode, int clamp,
                        const int* chunk_id, int* out_id, float* out_val,
                        unsigned long long* scratch, int dev, cudaStream_t st) {
  static std::atomic<unsigned long long> opted{0};
  const cudaError_t err = opt_in_smem(select_rows<IN_SMEM>, opted, dev);
  if (err != cudaSuccess) return err;
  int p2 = 1;
  while (p2 < r) p2 <<= 1;
  const size_t keys = IN_SMEM ? (static_cast<size_t>(w) * 4 + 15) & ~static_cast<size_t>(15) : 0;
  const size_t smem = keys + (mode == FINAL && r <= SORT_CAP ? static_cast<size_t>(p2) * 8 : 0);
  select_rows<IN_SMEM><<<b, THREADS, smem, st>>>(x, w, r, mode, clamp, chunk_id, out_id, out_val,
                                                 scratch);
  return cudaGetLastError();
}

}  // namespace

// x [b, w] f32 contiguous; 1 <= r <= w. mode 0 (FIRST): out_id [b, r] int32
// the kept positions clamped to `clamp`, ascending, out_val [b, r] their
// values or null. mode 1 (FINAL): w a multiple of 128, chunk_id [b, w / 128]
// int32, out_id [b, r] item ids (-1 past the candidates) and out_val [b, r]
// values, descending; scratch [b, r] uint64 where r > 2,048, else unused.
PPT_EXPORT int ppt_topk_select(const float* x, int b, int w, int r, int mode, int clamp,
                               const int* chunk_id, int* out_id, float* out_val,
                               unsigned long long* scratch, void* stream) {
  if (b <= 0 || w <= 0 || r <= 0 || r > w || out_id == nullptr) return cudaErrorInvalidValue;
  if (mode != FIRST && mode != FINAL) return cudaErrorInvalidValue;
  if (mode == FINAL &&
      (w % CHUNK != 0 || chunk_id == nullptr || out_val == nullptr ||
       (r > SORT_CAP && (scratch == nullptr || b > 65535))))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = w <= KEYS_CAP
            ? launch_rows<true>(x, b, w, r, mode, clamp, chunk_id, out_id, out_val, scratch, dev, st)
            : launch_rows<false>(x, b, w, r, mode, clamp, chunk_id, out_id, out_val, scratch, dev, st);
  if (err != cudaSuccess || mode == FIRST || r <= SORT_CAP) return err;
  sort_tiles<<<dim3((r + SORT_CAP - 1) / SORT_CAP, b), THREADS, 0, st>>>(scratch, r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rank_tiles<<<dim3((r + 255) / 256, b), 256, 0, st>>>(scratch, x, w, r, chunk_id, out_id, out_val);
  return cudaGetLastError();
}
