// f32-faithful dense products on the tensor cores: three TF32 wgmma passes
// over a hi/lo split (3xTF32), for the HGT layer's typed products
// (ops/dense.py).
//
// Replaces no TPU kernel: the JAX package has no HGT, and a dense product is
// XLA's there. The layer's f32 products (C = A B + bias, its dX = dY B^T and
// dW = A^T dY) ran on cuBLAS's and CUTLASS's CUDA-core f32 kernels (TF32 is
// off), at ~45-55 TFLOP/s against the f32 pipe's 67.
//
// Numerics. Each f32 operand x is split into hi = x rounded to the nearest
// TF32 value (cvt.rna: ties away from zero, the 13 low mantissa bits zero)
// and lo = x - hi, itself rounded to TF32; hi + lo keeps ~22 of x's 24
// mantissa bits. Per k8 step the kernel sums lo_a.hi_b, then hi_a.lo_b,
// then hi_a.hi_b; lo.lo (<= 2^-22 |ab|) is dropped, as kernel 10
// (knn_topk.cu) drops it. The tensor cores' f32 accumulation is not
// round-to-nearest: summed there over all of K, the error grew with K, to 3x
// cuBLAS f32's at K 256 and 34x at K 8,752 (measured on an H100). So the
// tensor cores sum only one stage (32 of K: 12 wgmma into a fresh
// accumulator), and the CUDA cores add each stage's partial to an f32
// accumulator in registers, rounding to nearest (CUTLASS's promotion of
// fp8 sums, here for every stage). No atomics anywhere, every sum in a fixed
// order: the result is the same bits on every run.
//
// What bounds it on this card: the tensor cores, 3 TF32 passes at 495
// TFLOP/s (165 TFLOP/s of f32 products, 2.5x the CUDA-core f32 peak); at the
// HGT shapes (K 256, 768 or 1,280; N 256 to 1,280) the bytes, each operand
// read once and C written once, take half of that time or less.
//
// Design (sm_90a). A block of 256 threads (two warpgroups) owns 128 rows x
// 128 columns of C, each warpgroup 64 rows as one wgmma m64n128k8 TF32
// accumulator (64 registers a thread) beside its 64 promoted sums. K goes
// in stages of 32 through a 4-stage cp.async ring, two stages ahead:
// promote stage s - 1's partial, issue stage s's 12 wgmma, then, while they
// run, wait for stage s + 1, start stage s + 3's copies and prepare stage
// s + 1 (one block barrier a stage, two in mode 1).
//   - A (the register operand). Each thread reads its fragments from A's
//     raw rows (4 values a k8 step: rows g, g + 8, columns t, t + 4, as
//     wgmma's TF32 A layout), splits them in registers and issues wgmma
//     with A from registers (two register sets: one read by the tensor
//     cores while the other is filled).
//   - B (from shared memory, K-major, as wgmma's TF32 needs): a pair of hi
//     and lo panels a stage ([128 columns][32] f32, 128-byte rows under the
//     128-byte swizzle).
// The layer's wide operand Y (a product's output in the forward, its
// gradient in the backward) is addressed through a table of 128-column
// blocks (YBlocks), so the HGT layer's Y lives in row slices of its q and
// kv tables and is written and read there, with no copy in between.
// Mode 0, Y = A B (+ bias), the forward (B a weight [K, N]), and mode 3, C
// = Y B, dX (B a weight's transpose): B is small and is split once a call
// into hi and lo [N][K] (mode 2), so its panels are copied straight into
// the ring; mode 0 adds the bias in its epilogue; row tails are zero-filled
// on load and not stored. (Copying B raw and splitting it in the block
// instead, as mode 1 must, halves its bytes from the L2 but ran 1.1-1.2x
// slower at the HGT shapes on an H100.) Mode 1, C = A^T Y, dW (K the row
// count, C only 256 x 256..1,280): A^T's fragments are read down the raw
// rows' columns, and Y's raw [32][128] rows are split and transposed into a
// panel pair (two pairs, one per stage in flight); K is split across blocks
// so that ~one block runs on each SM, each writing its partial C to a
// scratch slab, and a second launch sums the slabs in split order.
//
// Measured on an H100 at the HGT shapes: 62-79 TFLOP/s, 1.33-1.61x cuBLAS
// f32 and 2.3-2.7x the 3-pass bound, at cuBLAS's own single-pass TF32 pace
// on these shapes; without its tensor-core work it still takes 77% of its
// time, without its loads 72%.
#include "tensor_core.cuh"

namespace {

constexpr int BM = 128;      // rows of C a block owns: a warpgroup's 64 each
constexpr int BN = 128;      // columns of C a block owns
constexpr int KS = 32;       // features a stage: 128-byte K-major rows
constexpr int STAGES = 4;    // the cp.async ring: loads run two stages ahead
constexpr int THREADS = 256;
constexpr int ALIGN = 1024;  // the panels' alignment: the 128-byte swizzle's period
constexpr int PANEL = BN * KS * 4;             // one [BN][KS] f32 panel: 16 KB
constexpr int A_LD = KS + 4;                   // A's raw rows [BM][A_LD] (mode 0): conflict-free fragments
constexpr int AT_LD = BM + 8;                  // A^T's raw rows [KS][AT_LD] (mode 1): likewise
constexpr int MAX_YB = 16;                     // column blocks a Y table holds: N or K up to 2,048

// Byte offset of row r's 16-byte eighth q in a panel of 128-byte rows under
// wgmma's 128-byte swizzle (as knn_topk_fast.cu's).
__device__ __forceinline__ int swz(int r, int q) { return r * 128 + 16 * (q ^ (r & 7)); }

// x rounded to the nearest TF32 value (ties away from zero), as its bits.
__device__ __forceinline__ unsigned rna_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// hi and lo (each TF32) of x.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}

template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d = (ACC ? d : 0) + A B^T, wgmma m64n128k8 TF32: A [64][8] from registers
// (a thread's rows g, g + 8 at columns t, t + 4: a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4)), B [128][8] K-major in shared memory
// (descriptor db); d's layout: rows g and g + 8 at columns 8j + 2t, 8j + 2t +
// 1 of the warp's 16 rows.
template <int ACC>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[16][4], const unsigned (&a)[4], unsigned long long db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(ACC));
}

// A stage's fragments of a thread: [k8 step][hi, lo][a0..a3].
struct Frag {
  unsigned v[KS / 8][2][4];
};

using Acc = float[16][4];  // a thread's accumulators

__device__ __forceinline__ void promote(Acc& sum, const Acc& part) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) sum[j][q] += part[j][q];
}

// Y as column blocks of 128: block j's rows start at p[j] and lie ld[j]
// floats apart (a contiguous [rows, w] matrix: p[j] = base + 128 j, ld[j] =
// w).
struct YBlocks {
  float* p[MAX_YB];
  int ld[MAX_YB];
};

// Modes 0 (C = A B + bias, C = Y) and 3 (C = Y B, A = Y) copy B's split
// panels into the ring; mode 1 (C = A^T Y, B = Y) splits B's raw rows.
template <int MODE>
struct Gemm {
  static constexpr bool SPLIT_B = MODE != 1;  // B comes split (modes 0, 3)
  // A stage of the ring. Modes 0, 3: B's hi and lo panels, then A's raw
  // rows; mode 1: B's raw rows, then A^T's (B's panel pairs lie before the
  // ring).
  static constexpr int B_BYTES = SPLIT_B ? 2 * PANEL : KS * BN * 4;
  static constexpr int A_BYTES = SPLIT_B ? BM * A_LD * 4 : KS * AT_LD * 4;
  static constexpr int STAGE = B_BYTES + A_BYTES;  // modes 0, 3: 51,200 B (50 x 1,024); mode 1: 33,792 B
  static constexpr int PAIRS = SPLIT_B ? 0 : 4 * PANEL;
  static constexpr size_t SMEM = ALIGN + PAIRS + static_cast<size_t>(STAGES) * STAGE;

  const float* a;   // mode 0: A [m, k]; mode 1: A^T's rows, [k, m]; mode 3: none (A = Y)
  const float* b0;  // modes 0, 3: B^T's hi [n, k]; mode 1: none (B = Y)
  const float* b1;  // modes 0, 3: B^T's lo [n, k]
  const YBlocks* y;  // the kernel's parameter (__grid_constant__: read in place)
  int m, n, k;
  int m0, n0, k_begin, k_end;
  unsigned char* ring;
  unsigned char* pairs;  // mode 1: two [hi | lo] panel pairs, stage s's at s & 1

  __device__ __forceinline__ unsigned char* slot(int s) const {
    return ring + (static_cast<unsigned>(s) % STAGES) * STAGE;
  }

  // B's hi panel for stage s (its lo panel follows it).
  __device__ __forceinline__ const unsigned char* panels(int s) const {
    return SPLIT_B ? slot(s) : pairs + (s & 1) * 2 * PANEL;
  }

  // Every thread's share of stage s's copies. Rows of K past the block's
  // end (mode 1's split) and rows of A past m are zero-filled.
  __device__ __forceinline__ void load(int s) const {
    unsigned char* st = slot(s);
    const int k0 = k_begin + s * KS;
    if (SPLIT_B) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {  // B hi and lo: 2 x 128 rows x 8 eighths
        const int idx = threadIdx.x + THREADS * i, op = idx >> 10, r = (idx >> 3) & 127, q = idx & 7;
        cp_async16(st + op * PANEL + swz(r, q), (op ? b1 : b0) + static_cast<long long>(n0 + r) * k + k0 + 4 * q,
                   true);
      }
      // A: 128 rows x 8 eighths; mode 3 reads Y's block holding features k0..k0 + 31
      const float* base = MODE == 3 ? y->p[k0 >> 7] + (k0 & 127) : a + k0;
      const long long ld = MODE == 3 ? y->ld[k0 >> 7] : k;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = threadIdx.x + THREADS * i, r = idx >> 3, q = idx & 7, row = m0 + r;
        const bool ok = row < m;
        cp_async16(st + B_BYTES + r * (A_LD * 4) + 16 * q, ok ? base + row * ld + 4 * q : base, ok);
      }
    } else {
      const float* base = y->p[blockIdx.x];  // B = Y: the block's 128 columns
      const long long ld = y->ld[blockIdx.x];
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // B: 32 rows x 32 quarters
        const int idx = threadIdx.x + THREADS * i, r = idx >> 5, q = idx & 31, row = k0 + r;
        const bool ok = row < k_end;
        cp_async16(st + r * (BN * 4) + 16 * q, ok ? base + row * ld + 4 * q : base, ok);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // A^T: 32 rows x 32 quarters
        const int idx = threadIdx.x + THREADS * i, r = idx >> 5, q = idx & 31, row = k0 + r;
        const bool ok = row < k_end;
        cp_async16(st + B_BYTES + r * (AT_LD * 4) + 16 * q,
                   ok ? a + static_cast<long long>(row) * m + m0 + 4 * q : a, ok);
      }
    }
  }

  // This thread's A fragments of stage s, split.
  __device__ __forceinline__ void frag(int s, Frag& f) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
    const float* ar = reinterpret_cast<const float*>(slot(s) + B_BYTES);
#pragma unroll
    for (int kk = 0; kk < KS / 8; ++kk) {
      float x[4];
      if (SPLIT_B) {
        x[0] = ar[r * A_LD + 8 * kk + t];
        x[1] = ar[(r + 8) * A_LD + 8 * kk + t];
        x[2] = ar[r * A_LD + 8 * kk + t + 4];
        x[3] = ar[(r + 8) * A_LD + 8 * kk + t + 4];
      } else {
        x[0] = ar[(8 * kk + t) * AT_LD + r];
        x[1] = ar[(8 * kk + t) * AT_LD + r + 8];
        x[2] = ar[(8 * kk + t + 4) * AT_LD + r];
        x[3] = ar[(8 * kk + t + 4) * AT_LD + r + 8];
      }
#pragma unroll
      for (int v = 0; v < 4; ++v) split(x[v], f.v[kk][0][v], f.v[kk][1][v]);
    }
  }

  // Mode 1: stage s's raw B rows [32][128], split and transposed into the
  // panel pair s & 1 (panel row c holds column c's 32 features). Thread t
  // owns column t % 128, eighths t / 128 + 2u (u = 0..3) of its features.
  __device__ __forceinline__ void transform(int s) const {
    const float* raw = reinterpret_cast<const float*>(slot(s));
    unsigned char* hi = pairs + (s & 1) * 2 * PANEL;
    const int c = threadIdx.x & (BN - 1);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int q = (threadIdx.x >> 7) + 2 * u;
      uint4 h, l;
      split(raw[(4 * q) * BN + c], h.x, l.x);
      split(raw[(4 * q + 1) * BN + c], h.y, l.y);
      split(raw[(4 * q + 2) * BN + c], h.z, l.z);
      split(raw[(4 * q + 3) * BN + c], h.w, l.w);
      *reinterpret_cast<uint4*>(hi + swz(c, q)) = h;
      *reinterpret_cast<uint4*>(hi + PANEL + swz(c, q)) = l;
    }
  }

  // Issue stage s's products (4 k8 steps, each 32 bytes further along the
  // rows, x 3 passes, the first into a fresh accumulator) as one wgmma
  // group.
  __device__ __forceinline__ void mma(int s, const Frag& f, Acc& acc) const {
    const unsigned char* hi = panels(s);
    const unsigned long long bh = wgmma_desc(hi, 128, SWIZZLE_128B);
    const unsigned long long bl = wgmma_desc(hi + PANEL, 128, SWIZZLE_128B);
    wgmma_fence();
    wgmma_tf32_rs<0>(acc, f.v[0][1], bh);  // lo_a.hi_b
    wgmma_tf32_rs<1>(acc, f.v[0][0], bl);  // hi_a.lo_b
    wgmma_tf32_rs<1>(acc, f.v[0][0], bh);  // hi_a.hi_b
#pragma unroll
    for (int kk = 1; kk < KS / 8; ++kk) {
      wgmma_tf32_rs<1>(acc, f.v[kk][1], bh + 2 * kk);
      wgmma_tf32_rs<1>(acc, f.v[kk][0], bl + 2 * kk);
      wgmma_tf32_rs<1>(acc, f.v[kk][0], bh + 2 * kk);
    }
    wgmma_commit();
  }

  // Prepare stage s, whose copies every thread has waited for and fenced
  // before a block barrier: its A fragments (into f) and, in mode 1, its
  // panel pair, visible to the tensor cores when this returns.
  __device__ __forceinline__ void prepare(int s, Frag& f) const {
    frag(s, f);
    if (!SPLIT_B) {
      transform(s);
      fence_async_shared();
      __syncthreads();
    }
  }

  // One stage (fragments cur): promote stage s - 1's partial, issue stage
  // s's products, then, while they run, wait for stage s + 1, free stage s -
  // 1's slot (and panel pair), start stage s + 3's copies into the slot, and
  // prepare stage s + 1 (fragments nxt). The partial is read only after a
  // full wait: ptxas serialises every wgmma of a kernel that reads an
  // accumulator of a group a partial wait may have left running.
  __device__ __forceinline__ void step(int s, int steps, const Frag& cur, Frag& nxt, Acc& part,
                                       Acc& sum) const {
    if (s > 0) {
      wgmma_wait_pending<0>();  // stage s - 1's products are done
      promote(sum, part);
    }
    mma(s, cur, part);
    if (s + 1 < steps) {
      cp_async_wait_pending<STAGES - 3>();  // stage s + 1 has landed (this thread's copies) ...
      fence_async_shared();                 // ... visible to the tensor cores
    }
    __syncthreads();  // ... every thread's, and every warpgroup is past stage s - 1
    if (s + STAGES - 1 < steps) load(s + STAGES - 1);
    cp_async_commit();
    if (s + 1 < steps) prepare(s + 1, nxt);
  }
};

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    tf32x3_gemm(const float* __restrict__ a, const float* __restrict__ b0, const float* __restrict__ b1,
                const float* __restrict__ bias, float* __restrict__ c, const __grid_constant__ YBlocks y, int m,
                int n, int k, int chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const unsigned base = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  unsigned char* aligned = smem + ((ALIGN - (base & (ALIGN - 1))) & (ALIGN - 1));

  Gemm<MODE> G;
  G.a = a;
  G.b0 = b0;
  G.b1 = b1;
  G.y = &y;
  G.m = m;
  G.n = n;
  G.k = k;
  G.n0 = blockIdx.x * BN;
  G.m0 = blockIdx.y * BM;
  G.k_begin = MODE == 1 ? blockIdx.z * chunk : 0;
  G.k_end = MODE == 1 ? min(k, G.k_begin + chunk) : k;
  G.pairs = aligned;
  G.ring = aligned + Gemm<MODE>::PAIRS;
  const int steps = (G.k_end - G.k_begin + KS - 1) / KS;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) G.load(s);
    cp_async_commit();
  }
  Acc part, sum;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) part[j][q] = sum[j][q] = 0.f;

  Frag fa, fb;
  cp_async_wait_pending<STAGES - 2>();  // stage 0 has landed (this thread's copies) ...
  fence_async_shared();
  __syncthreads();                      // ... every thread's
  G.prepare(0, fa);
  for (int s = 0; s < steps; s += 2) {  // two stages a pass, so each fragment set stays in registers
    G.step(s, steps, fa, fb, part, sum);
    if (s + 1 < steps) G.step(s + 1, steps, fb, fa, part, sum);
  }
  wgmma_wait_pending<0>();
  promote(sum, part);
  cp_async_wait();

  // Warp w of a warpgroup holds rows 16w + g and 16w + g + 8 of its 64, at
  // columns 8j + 2t and 8j + 2t + 1.
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int row = G.m0 + (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + g;
  // the block's 128 columns: mode 0 Y's block, mode 1 the split's slab, mode 3 C
  float* out = MODE == 0 ? y.p[blockIdx.x]
                         : c + (MODE == 1 ? static_cast<long long>(blockIdx.z) * m * n : 0) + G.n0;
  const long long ld = MODE == 0 ? y.ld[blockIdx.x] : n;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + 2 * t;
    float2 bb = make_float2(0.f, 0.f);
    if (MODE == 0 && bias != nullptr) bb = *reinterpret_cast<const float2*>(bias + G.n0 + col);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = row + 8 * e;
      if (r < m)
        *reinterpret_cast<float2*>(out + r * ld + col) = make_float2(sum[j][2 * e] + bb.x, sum[j][2 * e + 1] + bb.y);
    }
  }
}

// c = the sum over splits of ws [splits][count4] float4s, in split order.
__global__ void tf32x3_sum_splits(const float4* __restrict__ ws, float4* __restrict__ c, int splits,
                                  long long count4) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count4;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float4 s = ws[i];
    for (int p = 1; p < splits; ++p) {
      const float4 v = ws[p * count4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    c[i] = s;
  }
}

// hi, lo <- the split of src [rows, cols], as [rows, cols] or (transpose)
// [cols, rows], through a 32 x 32 tile in shared memory.
__global__ void tf32x3_split(const float* __restrict__ src, float* __restrict__ hi, float* __restrict__ lo,
                             int rows, int cols, int transpose) {
  __shared__ float tile[32][33];
  const int c0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, cc = c0 + threadIdx.x;
    tile[i][threadIdx.x] = r < rows && cc < cols ? src[static_cast<long long>(r) * cols + cc] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int orow = (transpose ? c0 : r0) + i, ocol = (transpose ? r0 : c0) + threadIdx.x;
    const int olim = transpose ? cols : rows, ld = transpose ? rows : cols;
    if (orow >= olim || ocol >= ld) continue;
    unsigned h, l;
    split(transpose ? tile[threadIdx.x][i] : tile[i][threadIdx.x], h, l);
    const long long o = static_cast<long long>(orow) * ld + ocol;
    hi[o] = __uint_as_float(h);
    lo[o] = __uint_as_float(l);
  }
}

std::atomic<unsigned long long> opted[4];

template <int MODE>
int launch_gemm(const float* a, const float* b0, const float* b1, const float* bias, float* c, const YBlocks& y,
                int m, int n, int k, int splits, int chunk, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = opt_in_smem(tf32x3_gemm<MODE>, opted[MODE], dev);
  if (err != cudaSuccess) return err;
  const dim3 grid(n / BN, MODE == 1 ? m / BM : (m + BM - 1) / BM, MODE == 1 ? splits : 1);
  tf32x3_gemm<MODE><<<grid, THREADS, Gemm<MODE>::SMEM, stream>>>(a, b0, b1, bias, c, y, m, n, k, chunk);
  return cudaGetLastError();
}

}  // namespace

// Y tables: yb holds nb (pointer, row stride) pairs as int64s, one a
// column block of 128 of Y, every pointer 16-byte aligned and every stride
// a multiple of 4 floats.
// mode 0: Y [m, n] = a [m, k] B (+ bias [n], or null), B given as the split
//   of B^T: b0 = hi, b1 = lo, both [n, k] (from mode 2); Y through yb (n /
//   128 blocks); m >= 1, k a multiple of 32.
// mode 3: c [m, n] = Y [m, k] B, B as in mode 0, Y through yb (k / 128
//   blocks); m >= 1, k a multiple of 128.
// mode 1: c [m, n] = a^T Y with a [k, m] and Y [k, n] through yb (n / 128
//   blocks); the k rows go in `splits` blocks of `chunk` rows (a multiple
//   of 32); with splits > 1 the partial products go to ws [splits, m, n] and
//   a second launch sums them into c in split order. m a multiple of 128.
// Modes 0, 1, 3: n a multiple of 128.
// mode 2: b0, b1 <- the hi and lo of a [m, n], as [m, n] (k == 0) or
//   transposed, [n, m] (k != 0).
// Every other pointer 16-byte aligned, every other tensor contiguous.
PPT_EXPORT int ppt_dense_3xtf32(int mode, const float* a, float* b0, float* b1, const float* bias, float* c,
                                float* ws, const long long* yb, int m, int n, int k, int splits, int chunk,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 2) {
    if (m < 1 || n < 1 || (m + 31) / 32 > 65535) return cudaErrorInvalidValue;
    const dim3 grid((n + 31) / 32, (m + 31) / 32);
    tf32x3_split<<<grid, dim3(32, 8), 0, st>>>(a, b0, b1, m, n, k != 0);
    return cudaGetLastError();
  }
  if (n < BN || n % BN || yb == nullptr) return cudaErrorInvalidValue;
  const int nb = (mode == 3 ? k : n) / 128;
  if (nb < 1 || nb > MAX_YB) return cudaErrorInvalidValue;
  YBlocks y = {};
  for (int j = 0; j < nb; ++j) {
    y.p[j] = reinterpret_cast<float*>(yb[2 * j]);
    y.ld[j] = static_cast<int>(yb[2 * j + 1]);
    if (yb[2 * j] % 16 || yb[2 * j + 1] % 4 || yb[2 * j + 1] < 128) return cudaErrorInvalidValue;
  }
  if (mode == 0 || mode == 3) {
    if (m < 1 || (m + BM - 1) / BM > 65535 || k < KS || k % (mode == 3 ? 128 : KS)) return cudaErrorInvalidValue;
    return mode == 0 ? launch_gemm<0>(a, b0, b1, bias, nullptr, y, m, n, k, 1, 0, st)
                     : launch_gemm<3>(nullptr, b0, b1, nullptr, c, y, m, n, k, 1, 0, st);
  }
  if (mode != 1 || m < BM || m % BM || k < 1 || splits < 1 || splits > 65535 || chunk < KS || chunk % KS ||
      static_cast<long long>(splits) * chunk < k || static_cast<long long>(splits - 1) * chunk >= k)
    return cudaErrorInvalidValue;
  const int err = launch_gemm<1>(a, nullptr, nullptr, nullptr, splits > 1 ? ws : c, y, m, n, k, splits, chunk, st);
  if (err != cudaSuccess || splits == 1) return err;
  const long long count4 = static_cast<long long>(m) * n / 4;
  const long long want = (count4 + 255) / 256;
  const int blocks = want < 4096 ? static_cast<int>(want) : 4096;
  tf32x3_sum_splits<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(ws), reinterpret_cast<float4*>(c),
                                            splits, count4);
  return cudaGetLastError();
}
