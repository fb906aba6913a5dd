// Shared helpers for the plotpointe_tpu_torch kernels (sm_90a, plain C ABI).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>

#define PPT_EXPORT extern "C" __attribute__((visibility("default")))

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr float NEG_INF = -1e30f;  // the JAX package's "minus infinity" for scores

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL_MASK, v, o));
  return v;
}

constexpr int CHUNK = 128;  // items per top-K chunk
constexpr int ROW_ILP = 4;  // 16-byte row loads a thread keeps in flight

// 16 bytes of a row widened to f32: 4 floats, or 8 bf16 values. Taken by
// value, so a caller's shared- or global-memory operand is read by one
// 16-byte load.
__device__ __forceinline__ void widen(const float4 a, float (&v)[4]) {
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

__device__ __forceinline__ void widen(const uint4 a, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

// One 16-byte load of a row from global memory, widened to f32 (`Raw` is
// the 16-byte type). The address must be 16-byte aligned.
template <typename T>
struct RowVec;

template <>
struct RowVec<float> {
  static constexpr int kElems = 4;
  using Raw = float4;
  __device__ static __forceinline__ void load(const float* p, float (&v)[4]) {
    widen(__ldg(reinterpret_cast<const float4*>(p)), v);
  }
};

template <>
struct RowVec<__nv_bfloat16> {
  static constexpr int kElems = 8;
  using Raw = uint4;
  __device__ static __forceinline__ void load(const __nv_bfloat16* p, float (&v)[8]) {
    widen(__ldg(reinterpret_cast<const uint4*>(p)), v);
  }
};

constexpr int PPT_MAX_DEVICES = 64;  // devices whose attributes are kept between calls

// The SM count of device dev, read once per device.
inline int device_sm_count(int dev) {
  static std::atomic<int> memo[PPT_MAX_DEVICES];  // 0: not read yet
  int sms = dev < PPT_MAX_DEVICES ? memo[dev].load(std::memory_order_relaxed) : 0;
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
    if (dev < PPT_MAX_DEVICES) memo[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// Opt `kernel` into the device's largest dynamic shared memory (the opt-in
// size less the kernel's static shared memory) once per device: `opted`
// holds a bit per device (one flag for each kernel instance), so a launch
// above 48 KB sets no attribute on later calls.
template <typename K>
cudaError_t opt_in_smem(K kernel, std::atomic<unsigned long long>& opted, int dev) {
  const unsigned long long bit = dev < PPT_MAX_DEVICES ? 1ull << dev : 0;
  if (opted.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - static_cast<int>(attr.sharedSizeBytes));
  if (err == cudaSuccess) opted.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

PPT_EXPORT const char* ppt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
