// The column sweep and the running top-R candidate lists shared by the kNN
// kernels (knn_topk.cu: 3xTF32; knn_topk_fast.cu: bf16).
//
// A block of 256 threads (two warpgroups) owns KNN_BR = 128 rows and sweeps
// every column tile of KNN_BC = 128 columns itself: blocks run in no order,
// so nothing may carry over between them. Each row keeps its R best (score,
// column) pairs so far, sorted, in shared memory. The order is a total one:
// higher score first, equal scores by smaller column. So the final list is
// the top-R of every column by that order, whatever order the candidates
// arrived in, and the plain version reproduces it exactly from the same
// scores. Self (column == row) and padding columns (>= n) are never
// inserted; slots no candidate reached keep (-1e30, -1).
//
// The product. A tile's scores are the sum over chunks of P::DK features.
// The chunks of every tile form one stream (tile 0's chunks, then tile 1's,
// ...) that 16-byte cp.async copies (eight a thread a chunk) feed through a
// ring of two 32 KB shared stages, one chunk ahead of the one being
// multiplied, with one block barrier a chunk. The ring runs across tile
// ends, so while one tile's scores are filtered the next tile's first chunk
// is already loading. Each stage holds the block's rows and the tile's
// columns K-major, each row's 16-byte pieces permuted as wgmma's 128-byte
// (bf16: 64 features a chunk) or 64-byte (TF32: 16 features) swizzle wants,
// so the tensor cores read both operands straight from shared memory: each
// warpgroup issues wgmma m64n128 on its 64 rows against the tile's 128
// columns, f32 accumulators in registers. Their layout is the documented
// one: warp q of a warpgroup holds its rows 16q + g and 16q + g + 8 (g =
// lane / 4) at columns 8j + 2t and 8j + 2t + 1 (t = lane % 4, j = 0..15), so
// every value's row and column are known from the lane.
//
// The selection, filtered in registers: the tile's scores never go to shared
// memory. After a tile's last chunk every thread tests its values against
// the R-th entry (score, column) of their row's list: first the 32 values of
// a row as one maximum, then, for a row where that passes, each value. A
// row's few values that beat it (after the first tiles well under one a row
// a tile: over the sweep a row's R-th entry changes ~R (1 + ln(N / R))
// times) are appended to the row's buffer of KNN_CAP slots, at a slot taken
// from the row's shared-memory integer counter. A buffer is merged into its
// list (one warp, every entry's place counted at once: knn_merge) once it is
// half full, and at the end of the sweep. (Inserting each survivor as it
// came, one warp per row walking the list, cost more than the product on an
// H100.) The slots' order depends on the order the threads ran in; the lists
// do not, since each is the top-R of what was appended under a total order.
// So the output is the same bits on every run (no float atomics anywhere).
// Overflow is handled, not assumed away: a value that finds its row's buffer
// full stays pending in a per-thread bit mask; the block merges the full
// buffers, re-reads the thresholds, and rescans the pending values (still in
// registers) until none is left. A list's R-th entry only rises, so a value
// that fails a test once is dropped for good, and no value that could reach
// a list is lost.
//
// Overlap: the kernels run two blocks on each SM (launch bounds; shared
// memory for R <= 31), so one block's filter and merges overlap the other's
// products; a second accumulator set in one block would not fit the 128
// registers that two blocks leave a thread. Measured on an H100 and not
// kept: a ring filled by TMA from a producer warp, with the two warpgroups
// free of block barriers (their filters warp-local), runs one block an SM
// and hides the filter's latency worse than two blocks do; filling the ring
// by cp.async from one producer warp could not issue the copies fast enough.
#pragma once

#include "tensor_core.cuh"

constexpr int KNN_BR = 128;  // rows a block owns
constexpr int KNN_BC = 128;  // columns per tile
constexpr int KNN_THREADS = 256;
constexpr int KNN_MAX_R = 128;          // K_PAD: at most 4 list entries a lane
constexpr int KNN_STAGES = 2;           // the cp.async ring
constexpr int KNN_STAGE_BYTES = 32768;  // one stage: both operands' chunks
constexpr int KNN_CAP = 16;             // survivor slots of a row
constexpr int KNN_ALIGN = 1024;         // the ring's alignment: the 128-byte swizzle's period

// Does (s, c) rank above (ts, tc)? Higher score first, then smaller column.
__device__ __forceinline__ bool knn_above(float s, int c, float ts, int tc) {
  return s > ts || (s == ts && c < tc);
}

// Bytes of the lists: score [KNN_BR][r] f32, then column [KNN_BR][r] int32.
__host__ __device__ constexpr size_t knn_list_bytes(int r) {
  return static_cast<size_t>(KNN_BR) * r * (sizeof(float) + sizeof(int));
}

// Dynamic shared memory of a block: room to align the ring, the ring, the
// survivor buffers (score, column), the row counters, the lists: 83,456 +
// 1,024 R bytes. At R = 28-29 (k = 20) 109.5-110.5 KB, two blocks on an SM;
// at R = 128 209.5 KB, one.
__host__ __device__ constexpr size_t knn_smem_bytes(int r) {
  return KNN_ALIGN + static_cast<size_t>(KNN_STAGES) * KNN_STAGE_BYTES +
         static_cast<size_t>(KNN_BR) * KNN_CAP * (sizeof(float) + sizeof(int)) +
         KNN_BR * sizeof(int) + knn_list_bytes(r);
}

// -- wgmma products ------------------------------------------------------------

// d += A B^T, wgmma m64n128k16: bf16 A [64][16] and B [128][16], K-major in
// shared memory (descriptors da, db); f32 accumulators in the layout above.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16][4], unsigned long long da,
                                           unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "n"(1));
}

// d += A B^T, wgmma m64n128k8: TF32 A [64][8] and B [128][8], K-major in
// shared memory (the tensor core reads each f32 truncated to TF32).
__device__ __forceinline__ void wgmma_tf32(float (&d)[16][4], unsigned long long da,
                                           unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "n"(1));
}

// -- the lists -----------------------------------------------------------------

struct KnnLists {
  float* ss;  // [KNN_BR][KNN_CAP] buffered survivor scores
  int* si;    // [KNN_BR][KNN_CAP] buffered survivor columns
  int* cnt;   // [KNN_BR] survivors appended since the row's last merge (may pass KNN_CAP)
  float* ls;  // [KNN_BR][r] list scores, descending
  int* li;    // [KNN_BR][r] list columns
  int r;
};

// Merge one row's m <= KNN_CAP buffered survivors (unsorted) into its sorted
// list of r entries, keeping the top r of the union. Called by a whole warp,
// one survivor a lane. A survivor's place in the union is the list entries
// above it (a binary search: they are a prefix of the list) plus the
// survivors above it; a list entry's is its own plus the survivors whose
// prefix ends at or before it. Each is written to its place if that is < r.
// The keys are distinct (one column each), so the places are.
__device__ __forceinline__ void knn_merge(float* ls, int* li, int r, const float* ss, const int* si,
                                          int m, int lane) {
  const bool has = lane < m;
  const float s = has ? ss[lane] : 0.f;
  const int c = has ? si[lane] : 0;
  int below = 0;  // list entries above this lane's survivor
  if (has) {
    int hi = r;
    while (below < hi) {
      const int mid = (below + hi) >> 1;
      if (knn_above(ls[mid], li[mid], s, c))
        below = mid + 1;
      else
        hi = mid;
    }
  }
  float vs[KNN_MAX_R / 32];
  int vi[KNN_MAX_R / 32], pos[KNN_MAX_R / 32];
#pragma unroll
  for (int u = 0; u < KNN_MAX_R / 32; ++u) {
    const int j = u * 32 + lane;
    pos[u] = j;
    if (j < r) {
      vs[u] = ls[j];
      vi[u] = li[j];
    }
  }
  int place = below;
  for (int k = 0; k < m; ++k) {
    const float sk = __shfl_sync(FULL_MASK, s, k);
    const int ck = __shfl_sync(FULL_MASK, c, k);
    const int bk = __shfl_sync(FULL_MASK, below, k);
    place += knn_above(sk, ck, s, c);
#pragma unroll
    for (int u = 0; u < KNN_MAX_R / 32; ++u) pos[u] += u * 32 + lane >= bk;
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < KNN_MAX_R / 32; ++u) {
    if (u * 32 + lane < r && pos[u] < r) {
      ls[pos[u]] = vs[u];
      li[pos[u]] = vi[u];
    }
  }
  if (has && place < r) {
    ls[place] = s;
    li[place] = c;
  }
  __syncwarp();
}

// Merge the buffers of the block's rows that hold at least `least`
// survivors (KNN_CAP: the full ones; 1: all) and empty them. Warp w owns
// rows 16w .. 16w + 15; every thread of the block calls it.
__device__ __forceinline__ void knn_merge_rows(const KnnLists& L, int least) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int mine = lane < 16 ? L.cnt[warp * 16 + lane] : 0;
  unsigned todo = __ballot_sync(FULL_MASK, lane < 16 && mine >= least);
  while (todo) {
    const int rr = warp * 16 + __ffs(todo) - 1;
    todo &= todo - 1;
    const int m = min(L.cnt[rr], KNN_CAP);
    knn_merge(L.ls + rr * L.r, L.li + rr * L.r, L.r, L.ss + rr * KNN_CAP, L.si + rr * KNN_CAP, m,
              lane);
    if (lane == 0) L.cnt[rr] = 0;
  }
}

// Filter one tile's accumulators acc (the wgmma layout above, rows row0 +
// ..., columns col0 + ...) into the row buffers; merge the buffers that are
// at least half full; if one overflowed, rescan until nothing is pending.
// Every thread of the block calls it. A survivor stays in its row's buffer
// until the buffer is half full (or the sweep ends), so the threshold a
// value is tested against (the list's R-th entry) may lag behind the buffer:
// more values pass, none is lost.
__device__ __forceinline__ void knn_filter(const float (&acc)[16][4], const KnnLists& L, int row0,
                                           int col0, int n) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rbase = (warp >> 2) * 64 + (warp & 3) * 16 + g, cbase = col0 + 2 * t;
  const int r = L.r;
  unsigned long long pending = ~0ull;  // bit 32h + 2j + c: value not yet settled
  for (;;) {
    bool over = false, ripe = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rbase + 8 * h, grow = row0 + row;
      const float ts = L.ls[row * r + r - 1];
      const int tc = L.li[row * r + r - 1];
      float mx = acc[0][2 * h];
#pragma unroll
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(acc[j][2 * h], acc[j][2 * h + 1]));
      // nothing of this row's 32 values can rank above (ts, tc): the usual case
      if (grow >= n || mx + 0.0f < ts) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float s = acc[j][2 * h + c] + 0.0f;  // -0 -> +0: ties compare as keys do
          if (s < ts) continue;  // most values, even in a row that passed
          const unsigned long long bit = 1ull << (32 * h + 2 * j + c);
          if (!(pending & bit)) continue;
          const int gcol = cbase + 8 * j + c;
          if (gcol < n && gcol != grow && knn_above(s, gcol, ts, tc)) {
            const int slot = atomicAdd(L.cnt + row, 1);
            if (slot >= KNN_CAP) {
              over = true;  // the buffer is full: stays pending for the next pass
              continue;
            }
            ripe |= slot >= KNN_CAP / 2 - 1;
            L.ss[row * KNN_CAP + slot] = s;
            L.si[row * KNN_CAP + slot] = gcol;
          }
          pending &= ~bit;  // appended, or never enters
        }
      }
    }
    if (!__syncthreads_or(over || ripe)) return;
    knn_merge_rows(L, KNN_CAP / 2);
    if (!__syncthreads_or(over)) return;
  }
}

// The block's lists are rows row0.. of out [n, r]: one contiguous stretch.
__device__ __forceinline__ void knn_write(const float* ls, const int* li, int r, int row0, int n,
                                          int* __restrict__ out_idx, float* __restrict__ out_score) {
  const long long base = static_cast<long long>(row0) * r;
  const int count = min(KNN_BR, n - row0) * r;
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    out_score[base + j] = ls[j];
    out_idx[base + j] = li[j];
  }
}

// The whole kernel body: the ring over every tile's chunks, P's product,
// the filter after each tile, the lists written at the end. P has DK
// (features a chunk), load(stage, row0, col0, k0, n, d) (every thread's
// share of one chunk of the block's rows and of the tile's columns, by
// cp_async16) and mma(stage, acc) (its warpgroup's wgmma on a landed stage,
// issued and committed as one group). One chunk loads while one is
// multiplied: at the top of each chunk the block waits for that chunk's
// copies and for the previous chunk's wgmma, so the stage the next copies go
// to is free.
template <class P>
__device__ __forceinline__ void knn_sweep(const P& p, int* __restrict__ out_idx,
                                          float* __restrict__ out_score, int n, int d, int r) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned char* ring = smem + ((KNN_ALIGN - (base & (KNN_ALIGN - 1))) & (KNN_ALIGN - 1));
  KnnLists L;
  L.ss = reinterpret_cast<float*>(ring + KNN_STAGES * KNN_STAGE_BYTES);
  L.si = reinterpret_cast<int*>(L.ss + KNN_BR * KNN_CAP);
  L.cnt = L.si + KNN_BR * KNN_CAP;
  L.ls = reinterpret_cast<float*>(L.cnt + KNN_BR);
  L.li = reinterpret_cast<int*>(L.ls + KNN_BR * r);
  L.r = r;

  const int row0 = blockIdx.x * KNN_BR;
  for (int j = threadIdx.x; j < KNN_BR * r; j += blockDim.x) {
    L.ls[j] = NEG_INF;
    L.li[j] = -1;
  }
  for (int j = threadIdx.x; j < KNN_BR; j += blockDim.x) L.cnt[j] = 0;

  const int chunks = (d + P::DK - 1) / P::DK;  // a tile's chunks
  const int steps = ((n + KNN_BC - 1) / KNN_BC) * chunks;
  // chunk s of the stream: tile s / chunks, features (s % chunks) * DK
  int ld_tile = 0, ld_chunk = 0;
  auto load_next = [&](int s) {
    p.load(ring + (s & 1) * KNN_STAGE_BYTES, row0, ld_tile * KNN_BC, ld_chunk * P::DK, n, d);
    if (++ld_chunk == chunks) {
      ld_chunk = 0;
      ++ld_tile;
    }
  };
  load_next(0);
  cp_async_commit();
  float acc[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;

  int chunk = 0, col0 = 0;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait();     // chunk s has landed (this thread's copies) ...
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // ... visible to wgmma
    wgmma_wait();        // chunk s - 1's products are done ...
    __syncthreads();     // ... for every thread: its stage is free
    if (s + 1 < steps) load_next(s + 1);
    cp_async_commit();
    p.mma(ring + (s & 1) * KNN_STAGE_BYTES, acc);  // runs while chunk s + 1 loads
    if (++chunk == chunks) {
      wgmma_wait();
      knn_filter(acc, L, row0, col0, n);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
      chunk = 0;
      col0 += KNN_BC;
    }
  }
  cp_async_wait();
  knn_merge_rows(L, 1);  // what the buffers still hold
  __syncthreads();
  knn_write(L.ls, L.li, r, row0, n, out_idx, out_score);
}

// Launch a knn_sweep kernel on (n + 127) / 128 blocks with its shared memory.
template <class Kernel, class... Args>
int knn_launch(Kernel kernel, int n, int r, void* stream, Args... args) {
  const size_t smem = knn_smem_bytes(r);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int blocks = (n + KNN_BR - 1) / KNN_BR;
  kernel<<<blocks, KNN_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}
