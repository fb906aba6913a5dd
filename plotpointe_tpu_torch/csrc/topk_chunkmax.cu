// Top-K retrieval phase 1: per-chunk maxima of the query-item scores, on the
// tensor cores.
//
// Replaces plotpointe_tpu/ops/topk_kernel.py::_chunkmax_kernel (launched in
// topk_mips_pallas). For queries Q [B, D] and a catalog X [N, D] (f32 or
// bf16, both in the table's type), writes out[b, c] = max over the items i of
// chunk c (i in [128c, min(128c + 128, N))) of the f32 score Q[b] . X[i].
// Items past N never count; out is a dense [B, ceil(N / 128)].
//
// Numerics. bf16 tables: one bf16 wgmma pass (each product exact in f32,
// f32 sums). f32 tables: 3xTF32, kernel 10's f32-faithful scheme: a value
// x splits into hi = x rounded to the nearest TF32 value (ties away from
// zero, the rule of ops/knn_kernel.split_tf32) and lo = x - hi (exact), and
// each 8 features sum lo_x.hi_q, then hi_x.lo_q, then hi_x.hi_q in f32
// accumulators (the tensor core reads lo truncated to TF32). The chunk max
// is within f32 rounding of the f32 score, not bit-equal to kernel 5's
// f32-FMA re-score; the top-K's chunk margin absorbs that, as the TPU
// kernel's margin absorbs its matrix unit's order of sums.
//
// What bounds it on this card: the catalog stream, N * D * itemsize bytes
// read once (498,196 x 128: 255 MB f32, 0.076 ms; 128 MB bf16, 0.038 ms at
// 3.35 TB/s). The operations (3 TF32 passes of 2 B N D at 495 TFLOP/s:
// 0.049 ms at B = 64) stay below it.
//
// Design. The catalog is the 64-row operand: each warpgroup of a 256-thread
// block takes 64 items of a 128-item chunk, and the query slab (8, 16, 32 or
// 64 queries: wgmma's N) is the other operand. So the catalog's operand
// comes from registers: each thread reads its fragment of a tile from shared
// memory in 16-byte loads and splits it into hi and lo in registers; no tile
// is rewritten in shared memory, and padding queries cost wgmma width in
// steps of 8, not 64 rows. The slab is split once, when a block stages it,
// in wgmma's 128-byte swizzled K-major layout, and stays for the whole walk.
// A thread's A fragment holds K positions t and t + 4 (TF32) or 2t, 2t + 1,
// 2t + 8, 2t + 9 (bf16) of its rows; the features of each 128-byte slice are
// permuted (k_feature_*) so that one 16-byte load of four (eight) adjacent
// features gives a thread its values for two k-steps, and the slab holds the
// queries in the same order: a dot product does not depend on it.
// Blocks stay resident (as many as fit an SM) and walk chunks blockIdx.x,
// blockIdx.x + gridDim.x, ...; each chunk's 128-byte slices of its 128 rows
// (32 f32 or 64 bf16 features: 16 KB) stream through a 4-stage cp.async ring,
// three stages in flight, across chunk ends, with one block barrier a slice.
// At a chunk's end each thread takes the max of its two rows, three
// shuffles give the warp's 16 rows, and shared memory the 8 warps': one f32
// per (query, chunk) leaves the SM; no [B, N] score reaches memory. No
// atomics: the same bits on every run.
#include <atomic>

#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int CM_THREADS = 256;  // two warpgroups: a chunk's items 0-63 and 64-127
constexpr int CM_STAGES = 4;
constexpr int CM_ROW = 128;                 // bytes of one row's slice in a stage
constexpr int CM_STAGE = CHUNK * CM_ROW;    // 16 KB
constexpr int CM_MAX_NQ = 64;               // queries a slab holds
constexpr int CM_ALIGN = 1024;              // the 128-byte swizzle's period
constexpr int CM_WARPS = CM_THREADS / 32;

// Features of one 128-byte slice: 32 f32 or 64 bf16.
template <typename T>
__host__ __device__ constexpr int slice_features() {
  return CM_ROW / static_cast<int>(sizeof(T));
}

// The feature (within its slice) at K position p of the slice. TF32 k-step
// s takes positions 8s..8s+7, and a thread's fragment positions t and t + 4
// of rows g and g + 8: a 16-byte load of features 16q + 4t .. + 3 gives
// steps 2q and 2q + 1 both. bf16 k-step s takes 16 positions, a thread's
// 2t, 2t + 1, 2t + 8, 2t + 9: a load of features 32q + 8t .. + 7 gives
// steps 2q and 2q + 1 both.
__host__ __device__ constexpr int k_feature(int p, bool f32) {
  return f32 ? 16 * (p >> 4) + 4 * (p & 3) + 2 * ((p >> 3) & 1) + ((p >> 2) & 1)
             : 32 * (p >> 5) + 8 * ((p & 7) >> 1) + 4 * ((p >> 4) & 1) + 2 * ((p >> 3) & 1) +
                   (p & 1);
}

// 16-byte piece c of stage row r lies at piece c ^ stage_swizzle(r): the 8
// lanes of a quarter-warp (rows 2k and 2k + 1, pieces t or 4 + t) then read
// 8 distinct bank groups, as do the 8 lanes that copy one row.
__device__ __forceinline__ int stage_swizzle(int r) { return ((r & 1) << 2) | ((r >> 1) & 3); }

// Bytes of a slab of nq queries at width d: one [nq][128 B] panel per slice,
// twice (hi, lo) for f32.
__host__ __device__ constexpr size_t slab_bytes(int nq, int d, bool f32) {
  return static_cast<size_t>((d + (f32 ? 32 : 64) - 1) / (f32 ? 32 : 64)) * nq * CM_ROW *
         (f32 ? 2 : 1);
}

// Dynamic shared memory of a block: room to align, the slab, the ring, the
// per-warp maxima.
__host__ __device__ constexpr size_t cm_smem(int nq, int d, bool f32) {
  return CM_ALIGN + slab_bytes(nq, d, f32) + static_cast<size_t>(CM_STAGES) * CM_STAGE +
         CM_WARPS * CM_MAX_NQ * sizeof(float);
}

// hi of split_tf32: x rounded to the nearest TF32 value, ties away from zero.
__device__ __forceinline__ unsigned tf32_hi(unsigned bits) { return (bits + 0x1000u) & ~0x1FFFu; }

// wgmma m64nNk8 (TF32) and m64nNk16 (bf16): d += A B^T with A [64][K] from
// registers (the fragment a) and B [N][K] K-major in shared memory
// (descriptor b); d in the documented layout: warp w of the warpgroup holds
// rows 16w + g and 16w + g + 8 (g = lane / 4) at columns 8j + 2t and
// 8j + 2t + 1 (t = lane % 4), d[4j + 2h + c] = (row 16w + g + 8h, column
// 8j + 2t + c).
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void tf32(float (&d)[4], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
  __device__ static __forceinline__ void bf16(float (&d)[4], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void tf32(float (&d)[8], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
  __device__ static __forceinline__ void bf16(float (&d)[8], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void tf32(float (&d)[16], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
  __device__ static __forceinline__ void bf16(float (&d)[16], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void tf32(float (&d)[32], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
  __device__ static __forceinline__ void bf16(float (&d)[32], const unsigned (&a)[4],
                                               unsigned long long b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
        " %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
  }
};


// Every thread's share of one stage: the 16-byte pieces of 128 rows' slice
// (features f0 ..), zeros past N and past D (d is a multiple of a piece).
template <typename T>
__device__ __forceinline__ void load_stage(unsigned char* stage, const T* __restrict__ x, int n,
                                           int d, long long item0, int f0) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < CHUNK * 8 / CM_THREADS; ++j) {
    const int id = threadIdx.x + CM_THREADS * j;
    const int r = id >> 3, c = id & 7;
    const long long item = item0 + r;
    const int f = f0 + c * V;
    const bool ok = item < n && f < d;
    cp_async16(stage + r * CM_ROW + 16 * (c ^ stage_swizzle(r)), ok ? x + item * d + f : x, ok);
  }
}

// The slab: queries q0 .. q0 + NQ - 1 (zeros past b and past d), slice k's
// panel at k * NQ * 128 bytes, row n's 16-byte piece at n * 128 + 16 (piece
// ^ n % 8) (wgmma's 128-byte swizzle), K positions in k_feature order. f32:
// the hi panels, then the lo panels.
template <typename T, int NQ>
__device__ __forceinline__ void stage_slab(unsigned char* slab, const T* __restrict__ q, int b,
                                           int q0, int d, int slices) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int FK = slice_features<T>();
  const int total = slices * NQ * FK;
  for (int i = threadIdx.x; i < total; i += CM_THREADS) {
    const int p = i % FK, rest = i / FK;
    const int nn = rest % NQ, k = rest / NQ;
    const int f = k * FK + k_feature(p, F32);
    const bool ok = q0 + nn < b && f < d;
    const int byte = p * static_cast<int>(sizeof(T));
    const int off = k * NQ * CM_ROW + nn * CM_ROW + 16 * ((byte >> 4) ^ (nn & 7)) + (byte & 15);
    if constexpr (F32) {
      const float v = ok ? q[static_cast<long long>(q0 + nn) * d + f] : 0.f;
      const unsigned hi = tf32_hi(__float_as_uint(v));
      *reinterpret_cast<unsigned*>(slab + off) = hi;
      *reinterpret_cast<float*>(slab + slices * NQ * CM_ROW + off) = v - __uint_as_float(hi);
    } else {  // the bf16 bits as they are
      *reinterpret_cast<unsigned short*>(slab + off) =
          ok ? reinterpret_cast<const unsigned short*>(q)[static_cast<long long>(q0 + nn) * d + f]
             : 0;
    }
  }
}

__device__ __forceinline__ unsigned word(const uint4& v, int i) {
  return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
}

template <typename T, int NQ>
__global__ void __launch_bounds__(CM_THREADS, 2)
    chunkmax(const T* __restrict__ x, const T* __restrict__ q, float* __restrict__ out, int n,
             int b, int d, int n_chunks) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int FK = slice_features<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned char* slab = smem + ((CM_ALIGN - (base & (CM_ALIGN - 1))) & (CM_ALIGN - 1));
  const int slices = (d + FK - 1) / FK;
  unsigned char* ring = slab + slab_bytes(NQ, d, F32);
  float* red = reinterpret_cast<float*>(ring + CM_STAGES * CM_STAGE);  // [8 warps][NQ]

  const int q0 = blockIdx.y * NQ;
  const int nq = min(NQ, b - q0);
  const int steps = ((n_chunks - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1) * slices;
  // step s of the stream: chunk blockIdx.x + (s / slices) * gridDim.x, slice s % slices
  auto load = [&](int s) {
    const long long chunk = blockIdx.x + static_cast<long long>(s / slices) * gridDim.x;
    load_stage(ring + (s % CM_STAGES) * CM_STAGE, x, n, d, chunk * CHUNK, (s % slices) * FK);
  };
#pragma unroll
  for (int s = 0; s < CM_STAGES - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  stage_slab<T, NQ>(slab, q, b, q0, d, slices);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slab, visible to wgmma

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;  // this thread's rows r0, r0 + 8
  float acc[NQ / 2];
#pragma unroll
  for (int i = 0; i < NQ / 2; ++i) acc[i] = 0.f;

  int k = 0;
  long long chunk = blockIdx.x;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait_pending<CM_STAGES - 2>();  // this thread's copies of step s have landed ...
    __syncthreads();  // ... everyone's; and step s - 1's stage is read by all: free
    if (s + CM_STAGES - 1 < steps) load(s + CM_STAGES - 1);
    cp_async_commit();
    const unsigned char* st = ring + (s % CM_STAGES) * CM_STAGE;
    uint4 v[2][2];  // [row r0, r0 + 8][piece t, 4 + t]
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
#pragma unroll
      for (int gp = 0; gp < 2; ++gp)
        v[h][gp] = *reinterpret_cast<const uint4*>(st + r * CM_ROW +
                                                   16 * ((4 * gp + t) ^ stage_swizzle(r)));
    }
    const unsigned long long dhi = wgmma_desc(slab + k * NQ * CM_ROW, CM_ROW, SWIZZLE_128B);
    wgmma_wait();  // the last step's products are done with their A registers
    if constexpr (F32) {
      const unsigned long long dlo =
          wgmma_desc(slab + (slices + k) * NQ * CM_ROW, CM_ROW, SWIZZLE_128B);
      unsigned hi[4][4], lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gp = j >> 1, sp = j & 1;
        // a0 (row g, K t), a1 (row g + 8, K t), a2 (row g, K t + 4), a3 (row g + 8, K t + 4)
        const unsigned raw[4] = {word(v[0][gp], 2 * sp), word(v[1][gp], 2 * sp),
                                 word(v[0][gp], 2 * sp + 1), word(v[1][gp], 2 * sp + 1)};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[j][i] = tf32_hi(raw[i]);
          lo[j][i] = __float_as_uint(__uint_as_float(raw[i]) - __uint_as_float(hi[j][i]));
        }
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // the small terms first, as kernel 10
        Wgmma<NQ>::tf32(acc, lo[j], dhi + 2 * j);
        Wgmma<NQ>::tf32(acc, hi[j], dlo + 2 * j);
        Wgmma<NQ>::tf32(acc, hi[j], dhi + 2 * j);
      }
    } else {
      unsigned a[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gp = j >> 1, sp = j & 1;
        // a0 (row g, K 2t..), a1 (row g + 8, K 2t..), a2 (row g, K 2t + 8..), a3 (row g + 8, ..)
        a[j][0] = word(v[0][gp], 2 * sp);
        a[j][1] = word(v[1][gp], 2 * sp);
        a[j][2] = word(v[0][gp], 2 * sp + 1);
        a[j][3] = word(v[1][gp], 2 * sp + 1);
      }
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) Wgmma<NQ>::bf16(acc, a[j], dhi + 2 * j);
    }
    wgmma_commit();
    if (++k < slices) continue;
    // the chunk's last slice: its max for each query of the slab
    wgmma_wait();
    const long long item0 = chunk * CHUNK;
    const bool in0 = item0 + r0 < n, in1 = item0 + r0 + 8 < n;
#pragma unroll
    for (int j = 0; j < NQ / 8; ++j) {
      float m0 = fmaxf(in0 ? acc[4 * j] : NEG_INF, in1 ? acc[4 * j + 2] : NEG_INF);
      float m1 = fmaxf(in0 ? acc[4 * j + 1] : NEG_INF, in1 ? acc[4 * j + 3] : NEG_INF);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(FULL_MASK, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(FULL_MASK, m1, o));
      }
      if (g == 0) {
        red[warp * NQ + 8 * j + 2 * t] = m0;
        red[warp * NQ + 8 * j + 2 * t + 1] = m1;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] = 0.f;
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < nq) {
      float m = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < CM_WARPS; ++w) m = fmaxf(m, red[w * NQ + threadIdx.x]);
      out[static_cast<long long>(q0 + threadIdx.x) * n_chunks + chunk] = m;
    }
    k = 0;
    chunk += gridDim.x;
  }
  cp_async_wait();
}

// The launch's host work is cached, so a call costs about one launch: per
// device its SM count and shared-memory limit; per kernel and device the
// shared-memory opt-in; per kernel the blocks an SM holds at the last
// shared-memory size asked about. Each cache entry is one atomic word.
constexpr int CM_MAX_DEVICES = 64;

struct DeviceLimits {
  int sms, smem_optin;
};

DeviceLimits device_limits(int dev) {
  static std::atomic<unsigned long long> memo[CM_MAX_DEVICES];  // (sms << 32) | optin, 0 unknown
  unsigned long long m = dev < CM_MAX_DEVICES ? memo[dev].load(std::memory_order_relaxed) : 0;
  if (m == 0) {
    int sms = 0, optin = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    m = (static_cast<unsigned long long>(sms) << 32) | static_cast<unsigned>(optin);
    if (dev < CM_MAX_DEVICES) memo[dev].store(m, std::memory_order_relaxed);
  }
  return {static_cast<int>(m >> 32), static_cast<int>(m & 0xffffffffu)};
}

template <typename T, int NQ>
cudaError_t launch(const void* x, const void* q, float* out, int n, int b, int d, int dev,
                   const DeviceLimits& lim, cudaStream_t st) {
  constexpr bool F32 = sizeof(T) == 4;
  const size_t smem = cm_smem(NQ, d, F32);
  static std::atomic<unsigned long long> opted{0};  // a bit per device
  const cudaError_t opt = opt_in_smem(chunkmax<T, NQ>, opted, dev);
  if (opt != cudaSuccess) return opt;
  static std::atomic<unsigned long long> fit{0};  // (smem << 8) | blocks an SM holds
  unsigned long long f = fit.load(std::memory_order_relaxed);
  if (f >> 8 != smem) {
    int per_sm = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chunkmax<T, NQ>, CM_THREADS, smem);
    if (err != cudaSuccess) return err;
    f = (static_cast<unsigned long long>(smem) << 8) | static_cast<unsigned>(per_sm > 1 ? per_sm : 1);
    fit.store(f, std::memory_order_relaxed);
  }
  const int n_chunks = (n + CHUNK - 1) / CHUNK;
  const int slabs = (b + NQ - 1) / NQ;
  const int per_slab = static_cast<int>(f & 0xff) * lim.sms / slabs;
  const int blocks = per_slab < 1 ? 1 : (per_slab < n_chunks ? per_slab : n_chunks);
  chunkmax<T, NQ><<<dim3(blocks, slabs), CM_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(q), out, n, b, d, n_chunks);
  return cudaGetLastError();
}

// The widest slab for b queries (8, 16, 32 or 64) that fits shared memory.
template <typename T>
cudaError_t dispatch(const void* x, const void* q, float* out, int n, int b, int d,
                     cudaStream_t st) {
  constexpr bool F32 = sizeof(T) == 4;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const DeviceLimits lim = device_limits(dev);
  const size_t limit = static_cast<size_t>(lim.smem_optin);
  int nq = b <= 8 ? 8 : (b <= 16 ? 16 : (b <= 32 ? 32 : 64));
  while (nq > 8 && cm_smem(nq, d, F32) > limit) nq >>= 1;
  if (cm_smem(nq, d, F32) > limit) return cudaErrorInvalidValue;
  switch (nq) {
    case 8: return launch<T, 8>(x, q, out, n, b, d, dev, lim, st);
    case 16: return launch<T, 16>(x, q, out, n, b, d, dev, lim, st);
    case 32: return launch<T, 32>(x, q, out, n, b, d, dev, lim, st);
    default: return launch<T, 64>(x, q, out, n, b, d, dev, lim, st);
  }
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

// Dynamic shared memory of the narrowest slab (8 f32 queries) at width d, for
// the wrapper's check: wider slabs are taken only where they fit.
PPT_EXPORT size_t ppt_topk_chunkmax_smem(int d) { return cm_smem(8, d, true); }
