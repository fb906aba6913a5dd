// cp.async and wgmma helpers shared by the tensor-core kernels (knn.cuh's
// sweep of kernels 10 and 11; topk_chunkmax.cu).
#pragma once

#include "common.cuh"

// -- cp.async ------------------------------------------------------------------

// 16 bytes from src to shared dst, or 16 zero bytes where !valid (src is then
// not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed cp.async groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- wgmma ---------------------------------------------------------------------

constexpr int SWIZZLE_128B = 1, SWIZZLE_64B = 2;  // wgmma descriptor layout types

// Shared-memory descriptor of a K-major operand whose rows are `row_bytes`
// long (128: SWIZZLE_128B; 64: SWIZZLE_64B), 8-row groups 8 * row_bytes apart;
// p must lie at a multiple of 8 rows from a 1,024-byte aligned panel start.
__device__ __forceinline__ unsigned long long wgmma_desc(const void* p, int row_bytes, int layout) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  return static_cast<unsigned long long>((a >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<unsigned long long>((8 * row_bytes) >> 4) << 32) |
         (static_cast<unsigned long long>(layout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until this warpgroup's committed wgmma groups are done.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
