// Elementwise o = x * 2 + 1 over f32: the smoke check's proof that a kernel
// built from this package's sources compiles, launches and computes.
//
// Replaces plotpointe_tpu/tools/smoke_tpu.py::run_smoke.kernel (the Pallas
// `o_ref[:] = x_ref[:] * 2.0 + 1.0`, launched at :63-73).
//
// What bounds it: bytes, 8 per element (read x, write o); 2 operations per
// element. The smoke's [256, 128] is 256 KB: launch latency, not the bound.
//
// Design: a grid-stride loop, one 16-byte load and store (float4) per
// thread per step, the grid capped at a few blocks per SM; the n % 4 tail is
// taken by scalar steps. x * 2 is exact in f32, so one rounding, as on the
// TPU. At the smoke's size a call costs what the host spends to issue it,
// so the entry queries the SM count once, on its first call, and keeps it
// (the cap only sizes the grid: any count gives the same result).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
int sm_count = 0;  // the card's SMs, read on the first call

__global__ void affine(const float4* __restrict__ x, float4* __restrict__ o, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    const float4 v = __ldg(x + i);
    o[i] = make_float4(v.x * 2.f + 1.f, v.y * 2.f + 1.f, v.z * 2.f + 1.f, v.w * 2.f + 1.f);
  }
}

__global__ void affine_tail(const float* __restrict__ x, float* __restrict__ o, long long beg,
                            long long n) {
  const long long i = beg + threadIdx.x;
  if (i < n) o[i] = x[i] * 2.f + 1.f;
}

}  // namespace

// x, o [n] f32, 16-byte aligned, on the card.
PPT_EXPORT int ppt_smoke_affine(const float* x, float* o, long long n, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long n4 = n / 4;
  if (n4 > 0) {
    if (sm_count == 0) {
      int dev = 0, sms = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      sm_count = sms > 0 ? sms : 1;
    }
    const long long want = (n4 + THREADS - 1) / THREADS;
    const int blocks = static_cast<int>(want < 8LL * sm_count ? want : 8LL * sm_count);
    affine<<<blocks, THREADS, 0, st>>>(reinterpret_cast<const float4*>(x),
                                       reinterpret_cast<float4*>(o), n4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n4 * 4 < n) affine_tail<<<1, 32, 0, st>>>(x, o, n4 * 4, n);
  return cudaGetLastError();
}
