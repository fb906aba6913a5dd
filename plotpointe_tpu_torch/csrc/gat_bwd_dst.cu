// GAT attention backward, destination order (B1).
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_bwd_kernel (launched by
// _bwd_call). For each destination d with cotangent row g_d, and each in-edge
// s -> d (canonical id e):
//   x     = gs_s + gd_d                 (gs = round(h) . a_src, gd = h . a_dst)
//   lx    = lrelu(x, 0.2);  num = exp(clamp(lx, -10, 10))
//   deriv = num * 1[-10 < lx < 10] * (x > 0 ? 1 : 0.2)
//   ghs   = g_d . hs_s                  (hs: rows rounded to the row type)
//   de_e  = ((mask_e * ghs - godot_d) / (den_d + 1e-9)) * deriv
// and it emits de_sum_d = sum_e de_e, godot_d = g_d . out_d, and partial sums
// of de_e * hs_s (summed by the caller into d a_src). g, out, den, gs and gd
// are f32; the rows are bf16 or f32; every sum is f32.
//
// What bounds it: bytes. Each edge gathers one source row chosen by the
// graph (D * 2 bytes in bf16 rows, D * 4 in f32), far above the compulsory
// reads of g, out and the index arrays; the arithmetic is 4 FLOP per
// gathered element.
//
// Design: one warp per destination row, the walk of gat_fwd.cu's
// `aggregate`. Lanes hold D/32 features of g_d; godot_d is one warp
// reduction per row. The 32 lanes take 32 edges at a time for the scalar
// part (src index, logit, mask) with one coalesced load; then the warp walks
// those edges with several source rows in flight, one warp reduction per
// edge for ghs. The gather happens here by CSR index: no [E, D] stream.
// A fixed grid of warps strides over the rows and keeps de_e * hs_s in
// registers across its rows; each warp writes its partial row once and the
// caller sums the [warps, D] buffer in a fixed order. No atomics: the result
// is deterministic.
// Rows wider than STRIP (512) columns: ghs = g_d . hs_s spans the full row,
// so `row_dots` first writes ghs per edge and godot per row over the full
// rows; then the walk runs once per column strip of <= 512, reading ghs and
// godot instead of forming them, and each strip writes its columns of the
// partial rows (the first strip writes de_sum). Any multiple of 32 is taken.
// Known limit: a destination with thousands of in-edges (hot items) is one
// warp's serial loop, as in the forward.
#include "attention.cuh"

namespace {

// GIVEN: hs and partial are a column strip of rows `ld` apart (a wider row),
// and the per-edge g_d . hs_s (ghs_in) and per-row g_d . out_d (godot_in)
// over the full row are read instead of formed here; de_sum may be null.
// Else rows are VPL * 32 apart, a constant, and the walk forms both.
template <typename T, int VPL, bool GIVEN>
__global__ void bwd_dst(const T* __restrict__ hs, const float* __restrict__ gs,
                        const float* __restrict__ gd, const float* __restrict__ g,
                        const float* __restrict__ out, const float* __restrict__ den,
                        const int* __restrict__ row_ptr, const int* __restrict__ src,
                        const float* __restrict__ mask, float* __restrict__ de_sum,
                        float* __restrict__ godot_out, float* __restrict__ partial, int n,
                        long long ld, const float* __restrict__ ghs_in,
                        const float* __restrict__ godot_in) {
  // source rows in flight per warp: 32 registers of row values at any width
  constexpr int EDGE_ILP = VPL <= 4 ? 8 : (VPL <= 8 ? 4 : 2);
  const long long stride = GIVEN ? ld : VPL * 32;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS_PER_BLOCK;

  float pacc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) pacc[v] = 0.f;

  for (int row = warp; row < n; row += n_warps) {
    const int beg = row_ptr[row];
    const int end = row_ptr[row + 1];
    float gv[VPL];
    float go = 0.f;
    if constexpr (GIVEN) {
      go = godot_in[row];
    } else {
      const float* grow = g + static_cast<long long>(row) * stride + lane;
      const float* orow = out + static_cast<long long>(row) * stride + lane;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        gv[v] = grow[v * 32];
        go += gv[v] * orow[v * 32];
      }
      go = warp_sum(go);
    }
    const float g_d = gd[row];
    const float den_e = den[row] + EPS;
    float dsum = 0.f;

    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      int s = 0;
      float deriv = 0.f, m = 0.f, pe = 0.f;
      if (e < end) {
        s = src[e];
        if constexpr (GIVEN) pe = ghs_in[e];
        const float x = gs[s] + g_d;
        const float lx = x > 0.f ? x : LEAKY_SLOPE * x;
        const float num = expf(fminf(fmaxf(lx, -LOGIT_CLAMP), LOGIT_CLAMP));
        deriv = (lx > -LOGIT_CLAMP && lx < LOGIT_CLAMP) ? num * (x > 0.f ? 1.f : LEAKY_SLOPE) : 0.f;
        m = mask != nullptr ? mask[e] : 1.f;
      }
      const int cnt = min(32, end - base);
      float de_lane = 0.f;  // de of this lane's own edge
      for (int j = 0; j < cnt; j += EDGE_ILP) {
        int sj[EDGE_ILP];
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) sj[q] = __shfl_sync(FULL_MASK, s, j + q);
        float x[EDGE_ILP][VPL];
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
          const T* r = hs + static_cast<long long>(sj[q]) * stride + lane;
#pragma unroll
          for (int v = 0; v < VPL; ++v) x[q][v] = (j + q < cnt) ? to_f32(r[v * 32]) : 0.f;
        }
        float p[EDGE_ILP];
        if constexpr (GIVEN) {
#pragma unroll
          for (int q = 0; q < EDGE_ILP; ++q) p[q] = __shfl_sync(FULL_MASK, pe, j + q);
        } else {
#pragma unroll
          for (int q = 0; q < EDGE_ILP; ++q) {
            p[q] = 0.f;
#pragma unroll
            for (int v = 0; v < VPL; ++v) p[q] += gv[v] * x[q][v];
          }
#pragma unroll
          for (int q = 0; q < EDGE_ILP; ++q) p[q] = warp_sum(p[q]);
        }
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
          const float dq = __shfl_sync(FULL_MASK, deriv, j + q);
          const float mq = __shfl_sync(FULL_MASK, m, j + q);
          if (j + q < cnt) {
            const float de = ((mq * p[q] - go) / den_e) * dq;
#pragma unroll
            for (int v = 0; v < VPL; ++v) pacc[v] += de * x[q][v];
            if (lane == j + q) de_lane = de;
          }
        }
      }
      dsum += de_lane;
    }
    dsum = warp_sum(dsum);
    if (lane == 0) {
      if (!GIVEN || de_sum != nullptr) de_sum[row] = dsum;
      if constexpr (!GIVEN) godot_out[row] = go;
    }
  }
  float* prow = partial + static_cast<long long>(warp) * stride + lane;
#pragma unroll
  for (int v = 0; v < VPL; ++v) prow[v * 32] = pacc[v];
}

template <typename T>
cudaError_t launch(int vpl, dim3 grid, dim3 block, cudaStream_t st, const T* hs, const float* gs,
                   const float* gd, const float* g, const float* out, const float* den,
                   const int* row_ptr, const int* src, const float* mask, float* de_sum,
                   float* godot, float* partial, int n, long long ld, const float* ghs,
                   const float* godot_in) {
  switch (vpl) {
#define PPT_CASE(V)                                                                               \
  case V:                                                                                         \
    if (ghs != nullptr) {                                                                         \
      bwd_dst<T, V, true><<<grid, block, 0, st>>>(hs, gs, gd, g, out, den, row_ptr, src, mask,   \
                                                  de_sum, godot, partial, n, ld, ghs, godot_in); \
    } else {                                                                                      \
      bwd_dst<T, V, false><<<grid, block, 0, st>>>(hs, gs, gd, g, out, den, row_ptr, src, mask,  \
                                                   de_sum, godot, partial, n, ld, ghs, godot_in);\
    }                                                                                             \
    break;
    PPT_CASE(1) PPT_CASE(2) PPT_CASE(3) PPT_CASE(4) PPT_CASE(5) PPT_CASE(6) PPT_CASE(7)
    PPT_CASE(8) PPT_CASE(9) PPT_CASE(10) PPT_CASE(11) PPT_CASE(12) PPT_CASE(13) PPT_CASE(14)
    PPT_CASE(15) PPT_CASE(16)
#undef PPT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t backward(const T* hs, const float* gs, const float* gd, const float* g,
                     const float* out, const float* den, const int* row_ptr, const int* src,
                     const float* mask, float* de_sum, float* godot, float* partial, int n, int d,
                     int n_blocks, float* ghs, cudaStream_t st) {
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid(n_blocks);
  if (d <= STRIP) {
    return launch<T>(d / 32, grid, block, st, hs, gs, gd, g, out, den, row_ptr, src, mask,
                     de_sum, godot, partial, n, d, nullptr, nullptr);
  }
  if (n > 0) {
    row_dots<float, T><<<(n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK, block, 0, st>>>(
        g, hs, out, row_ptr, src, ghs, godot, n, d, d, d);
  }
  cudaError_t err = cudaGetLastError();
  for (int c0 = 0; c0 < d && err == cudaSuccess; c0 += STRIP) {
    const int w = d - c0 < STRIP ? d - c0 : STRIP;
    err = launch<T>(w / 32, grid, block, st, hs + c0, gs, gd, g, out, den, row_ptr, src, mask,
                    c0 == 0 ? de_sum : nullptr, nullptr, partial + c0, n, d, ghs, godot);
  }
  return err;
}

}  // namespace

// hs [n, d] rows (bf16 if hs_bf16, else f32); gs/gd/den [n] f32; g/out
// [n, d] f32; row_ptr [n + 1], src [E] int32 (CSR by destination); mask [E]
// f32 over canonical ids or null. Writes de_sum [n], godot [n] and partial
// [n_blocks * 8, d] f32. d must be a positive multiple of 32; above 512,
// ghs is an [E] f32 scratch buffer (per-edge g_d . hs_s), else unused.
PPT_EXPORT int ppt_gat_bwd_dst(const void* hs, int hs_bf16, const float* gs, const float* gd,
                               const float* g, const float* out, const float* den,
                               const int* row_ptr, const int* src, const float* mask,
                               float* de_sum, float* godot, float* partial, int n, int d,
                               int n_blocks, float* ghs, void* stream) {
  if (d <= 0 || d % 32 != 0 || n_blocks <= 0 || (d > STRIP && ghs == nullptr)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_bf16) {
    return backward<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(hs), gs, gd, g, out, den,
                                   row_ptr, src, mask, de_sum, godot, partial, n, d, n_blocks,
                                   ghs, st);
  }
  return backward<float>(static_cast<const float*>(hs), gs, gd, g, out, den, row_ptr, src, mask,
                         de_sum, godot, partial, n, d, n_blocks, ghs, st);
}
