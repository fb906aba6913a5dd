// Fused single-head GAT attention forward over a destination CSR.
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_fwd_kernel (launched by
// _fwd_call). Per edge s -> d:
//   logit = clamp(lrelu(hs_s . a_src + h_d . a_dst, 0.2), -10, 10)
//   num   = exp(logit)
//   den_d = sum num                 (unmasked)
//   out_d = sum mask * num * hs_s / (den_d + 1e-9)
// hs is h rounded to the row type (bf16 or f32); the destination term uses
// the f32 rows, as the TPU kernel does. All sums are f32.
//
// What bounds it: bytes. Each edge reads one source row (D * 2 bytes in
// bf16) chosen by the graph, so the traffic is a data-dependent gather of
// E rows, far above the compulsory N-row read; the arithmetic is 2 FLOP per
// gathered element.
//
// Design: two kernels on the caller's stream.
//   node_terms: one warp per node reads its f32 row once, writes the rounded
//     row (bf16 mode) and the two per-node logit terms gs = hs . a_src and
//     gd = h . a_dst, so no per-edge dot product is recomputed.
//   aggregate: one warp per destination row. The 32 lanes take 32 edges at a
//     time for the scalar part (src index load, logit, exp, mask) with one
//     coalesced load; then the warp walks those edges, each lane holding
//     D/32 features of the running sum in registers, several source rows
//     in flight (16 for D <= 128, 8 for D <= 256, 4 above). The gather
//     happens here by CSR index: no [E, D] gathered stream is written. No
//     atomics, a fixed order: deterministic.
// Rows wider than STRIP (512) columns: node_terms takes gs and gd from the
// full rows, then `aggregate` runs once per column strip of <= 512, every
// strip fed the same gs and gd (the weighted sum is separable by column);
// the first strip writes den. Any multiple of 32 is taken.
// Known limit: a destination with thousands of in-edges (hot items) is one
// warp's serial loop; splitting such rows across warps is later work.
#include "attention.cuh"

namespace {

template <typename T>
__global__ void node_terms(const float* __restrict__ h, const float* __restrict__ a_src,
                           const float* __restrict__ a_dst, T* __restrict__ hs,
                           float* __restrict__ gs, float* __restrict__ gd, int n, int d) {
  const int node = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= n) return;
  const float* row = h + static_cast<long long>(node) * d;
  float s = 0.f, t = 0.f;
  for (int f = lane; f < d; f += 32) {
    const float x = row[f];
    const float xr = round_to(x, hs);
    if (hs != nullptr) store_row(hs + static_cast<long long>(node) * d + f, x);
    s += xr * a_src[f];
    t += x * a_dst[f];
  }
  s = warp_sum(s);
  t = warp_sum(t);
  if (lane == 0) {
    gs[node] = s;
    gd[node] = t;
  }
}

// STRIPPED: hs and out are a column strip of rows `ld` apart (a wider row),
// and den_out may be null; else rows are VPL * 32 apart, a constant
template <typename T, int VPL, bool STRIPPED>
__global__ void aggregate(const T* __restrict__ hs, const float* __restrict__ gs,
                          const float* __restrict__ gd, const int* __restrict__ row_ptr,
                          const int* __restrict__ src, const float* __restrict__ mask,
                          float* __restrict__ out, float* __restrict__ den_out, int n,
                          long long ld) {
  // source rows in flight per warp: 64 registers of row values at any width
  constexpr int EDGE_ILP = VPL <= 4 ? 16 : (VPL <= 8 ? 8 : 4);
  const long long stride = STRIPPED ? ld : VPL * 32;
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int beg = row_ptr[row];
  const int end = row_ptr[row + 1];
  const float g_d = gd[row];

  float acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
  float den = 0.f;

  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int s = 0;
    float num = 0.f, w = 0.f;
    if (e < end) {
      s = src[e];
      float x = gs[s] + g_d;
      x = x > 0.f ? x : LEAKY_SLOPE * x;
      x = fminf(fmaxf(x, -LOGIT_CLAMP), LOGIT_CLAMP);
      num = expf(x);
      w = mask != nullptr ? num * mask[e] : num;
    }
    den += num;
    const int cnt = min(32, end - base);
    for (int j = 0; j < cnt; j += EDGE_ILP) {
      int sj[EDGE_ILP];
      float wj[EDGE_ILP];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        sj[q] = __shfl_sync(FULL_MASK, s, j + q);
        wj[q] = __shfl_sync(FULL_MASK, w, j + q);
      }
      float x[EDGE_ILP][VPL];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        const T* r = hs + static_cast<long long>(sj[q]) * stride + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v) x[q][v] = (j + q < cnt) ? to_f32(r[v * 32]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        if (j + q < cnt) {
#pragma unroll
          for (int v = 0; v < VPL; ++v) acc[v] += wj[q] * x[q][v];
        }
      }
    }
  }
  den = warp_sum(den);
  float* o = out + static_cast<long long>(row) * stride + lane;
#pragma unroll
  for (int v = 0; v < VPL; ++v) o[v * 32] = acc[v] / (den + EPS);
  if (lane == 0 && (!STRIPPED || den_out != nullptr)) den_out[row] = den;
}

template <typename T>
cudaError_t launch_aggregate(int vpl, dim3 grid, dim3 block, cudaStream_t st, const T* hs,
                             const float* gs, const float* gd, const int* row_ptr, const int* src,
                             const float* mask, float* out, float* den, int n, long long ld) {
  const bool stripped = ld != 32LL * vpl;
  switch (vpl) {
#define PPT_CASE(V)                                                                              \
  case V:                                                                                        \
    if (stripped) {                                                                              \
      aggregate<T, V, true><<<grid, block, 0, st>>>(hs, gs, gd, row_ptr, src, mask, out, den, n, \
                                                    ld);                                         \
    } else {                                                                                     \
      aggregate<T, V, false><<<grid, block, 0, st>>>(hs, gs, gd, row_ptr, src, mask, out, den,  \
                                                     n, ld);                                     \
    }                                                                                            \
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

// node_terms over the full rows, then one aggregate per column strip
template <typename T>
cudaError_t forward(const float* h, const float* a_src, const float* a_dst, const int* row_ptr,
                    const int* src, const float* mask, T* hs_out, const T* hs, float* gs,
                    float* gd, float* out, float* den, int n, int d, cudaStream_t st) {
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  node_terms<T><<<grid, block, 0, st>>>(h, a_src, a_dst, hs_out, gs, gd, n, d);
  cudaError_t err = cudaGetLastError();
  for (int c0 = 0; c0 < d && err == cudaSuccess; c0 += STRIP) {
    const int w = d - c0 < STRIP ? d - c0 : STRIP;
    err = launch_aggregate<T>(w / 32, grid, block, st, hs + c0, gs, gd, row_ptr, src, mask,
                              out + c0, c0 == 0 ? den : nullptr, n, d);
  }
  return err;
}

}  // namespace

// h [n, d] f32; a_src/a_dst [d] f32; row_ptr [n + 1], src [E] int32 (CSR by
// destination); mask [E] f32 or null; hs_bf16 [n, d] bf16 scratch (bf16 rows)
// or null (f32 rows: h itself is read); gs/gd [n] f32 scratch;
// out [n, d] f32; den [n] f32. d must be a positive multiple of 32.
PPT_EXPORT int ppt_gat_fwd(const float* h, const float* a_src, const float* a_dst,
                           const int* row_ptr, const int* src, const float* mask, void* hs_bf16,
                           float* gs, float* gd, float* out, float* den, int n, int d,
                           void* stream) {
  if (d <= 0 || d % 32 != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hs_bf16 != nullptr) {
    auto* hs = static_cast<__nv_bfloat16*>(hs_bf16);
    return forward<__nv_bfloat16>(h, a_src, a_dst, row_ptr, src, mask, hs, hs, gs, gd, out, den,
                                  n, d, st);
  }
  return forward<float>(h, a_src, a_dst, row_ptr, src, mask, nullptr, h, gs, gd, out, den, n, d,
                        st);
}
