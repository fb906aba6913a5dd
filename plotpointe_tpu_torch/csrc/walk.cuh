// The edge-balanced walk over a CSR's piece/unit plan, shared by the
// gathering kernels (spmm_csr.cu, gat_fwd.cu, gat_bwd_src.cu).
//
// The plan (`ops/spmm_kernel.piece_plan`, built once per CSR and cached):
//   pieces  runs of at most CAP consecutive entries of one row, in entry
//           order (an empty row is one empty piece); `piece_ptr` bounds them
//   units   runs of consecutive pieces of about UNIT entries; `unit_ptr`
//           bounds them; one lane group walks one unit
// A piece whose row it covers whole writes its row's result in the walk; a
// piece of a split row writes a scratch slot, and a combine kernel sums a
// split row's slots in piece order. No atomics, a fixed order: the same bits
// on every run.
//
// The attention kernels give each block WALK_UNITS consecutive units, so
// its entries are one contiguous range. The block first stages that range's
// indices in shared memory with cp.async, then computes each entry's
// scalars once, block-wide, into shared memory; then each lane group walks
// its unit reading rows in 16-byte chunks.
#pragma once

#include "common.cuh"

// Units one attention walk block takes. A unit holds at most UNIT + CAP
// (128) entries, so a block at most 1,024, whose shared arrays (at most 17
// words an entry: kernel 8 at 8 heads with a mask) stay under 70 KB.
constexpr int WALK_UNITS = 8;
// Registers are capped so that 3 blocks of 32 * WALK_UNITS threads share an
// SM: on the H100 that made B2 faster than the compiler's own choice and
// kernel 8 no slower; a cap for 4 blocks spilled and was slower, and twice
// the rows in flight a lane was slower still.
constexpr int WALK_MIN_BLOCKS = 3;

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The destination of piece p: its row o >= 0, or scratch slot -1 - o of a
// split row (without a piece map every piece is its own row).
__device__ __forceinline__ int piece_dest(const int* piece_out, int p) {
  return piece_out == nullptr ? p : piece_out[p];
}

// A block's share of the plan: units [u0, u1) and their entries [e0, e0 + cnt).
struct BlockUnits {
  int u0, u1, e0, cnt;
};

__device__ __forceinline__ BlockUnits block_units(const int* piece_ptr, const int* unit_ptr,
                                                  int n_units) {
  BlockUnits b;
  b.u0 = blockIdx.x * WALK_UNITS;
  b.u1 = min(b.u0 + WALK_UNITS, n_units);
  b.e0 = piece_ptr[unit_ptr[b.u0]];
  b.cnt = piece_ptr[unit_ptr[b.u1]] - b.e0;
  return b;
}

// Copy n ints from g into s with cp.async, the whole block taking part.
__device__ __forceinline__ void stage_ints(int* s, const int* g, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) cp_async4(s + i, g + i);
}

// VEC floats of an f32 vector at p (16-byte aligned), for the row chunk of
// the same columns.
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 4) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + k));
    v[k] = a.x;
    v[k + 1] = a.y;
    v[k + 2] = a.z;
    v[k + 3] = a.w;
  }
}

template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 4)
    *reinterpret_cast<float4*>(p + k) = make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
}

// Opt a kernel into more than 48 KB of dynamic shared memory where it asks
// for that much.
template <typename K>
__host__ cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
