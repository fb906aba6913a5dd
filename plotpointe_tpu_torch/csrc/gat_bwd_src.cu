// GAT attention backward, source order (B2).
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_bwd2_kernel (launched by
// _bwd2_call). For each source s and each out-edge s -> d (canonical id e),
// from per-node f32 tables (gs, gd, den, godot) and the cotangent rows
// rounded to the row type (gh):
//   x       = gs_s + gd_d;  lx = lrelu(x, 0.2);  num = exp(clamp(lx, -10, 10))
//   deriv   = num * 1[-10 < lx < 10] * (x > 0 ? 1 : 0.2)
//   ghs     = gh_d . hs_s
//   de_e    = ((mask_e * ghs - godot_d) / (den_d + 1e-9)) * deriv
//   alpha_e = mask_e * num / (den_d + 1e-9)
//   dh_s    = sum_e alpha_e * gh_d + (sum_e de_e) * a_src
// The de * a_src term is written once per row, as (sum_e de_e) * a_src,
// not per edge. de is recomputed here from the rounded cotangent, so in
// bf16 mode it differs slightly from B1's, as on the TPU.
//
// What bounds it: bytes. Each edge gathers one cotangent row chosen by the
// graph (D * 2 bytes in bf16 rows, D * 4 in f32) plus four per-node scalars
// and the mask bit of its canonical id; the compulsory traffic is one read
// of each table and one write of dh.
//
// Design: one warp per source row of the transpose CSR (t_ptr / t_dst /
// t_eid). The warp keeps its own rounded row and gs_s in registers. The 32
// lanes take 32 edges at a time for the scalar part (t_dst, t_eid, the
// per-node tables, mask[t_eid]); then the warp walks those edges with
// several cotangent rows in flight, one warp reduction per edge for ghs,
// and accumulates in f32 registers. Each row of dh is written once. No
// atomics: deterministic.
// Rows wider than STRIP (512) columns: ghs spans the full row, so
// `row_dots` first writes ghs per entry of the transpose CSR over the full
// rows; then the walk runs once per column strip of <= 512, reading ghs
// instead of forming it, and writes its columns of dh. Any multiple of 32.
// Known limit: the symmetric graph's hot sources are the forward's hot
// destinations (thousands of edges), each one warp's serial loop.
#include "attention.cuh"

namespace {

// GIVEN: a column strip of a wider row: dh rows are ld_out apart, and the
// per-entry gh_d . hs_s over the full row (ghs_in) is read instead of
// formed here. Else dh rows are VPL * 32 apart, a constant.
template <typename T, int VPL, bool GIVEN>
__global__ void bwd_src(const T* __restrict__ hs, const T* __restrict__ gh,
                        const float* __restrict__ a_src, const float* __restrict__ gs,
                        const float* __restrict__ gd, const float* __restrict__ den,
                        const float* __restrict__ godot, const int* __restrict__ t_ptr,
                        const int* __restrict__ t_dst, const int* __restrict__ t_eid,
                        const float* __restrict__ mask, float* __restrict__ dh, int n,
                        long long ld, long long ld_out, const float* __restrict__ ghs_in) {
  constexpr int EDGE_ILP = VPL <= 4 ? 8 : (VPL <= 8 ? 4 : 2);
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const int beg = t_ptr[row];
  const int end = t_ptr[row + 1];
  float hv[VPL], acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;
  if constexpr (!GIVEN) {
    const T* own = hs + row * ld + lane;
#pragma unroll
    for (int v = 0; v < VPL; ++v) hv[v] = to_f32(own[v * 32]);
  }
  const float gs_s = gs[row];
  float dsum = 0.f;

  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int dn = 0;
    float deriv = 0.f, m = 0.f, alpha = 0.f, go = 0.f, den_e = 1.f, pe = 0.f;
    if (e < end) {
      dn = t_dst[e];
      if constexpr (GIVEN) pe = ghs_in[e];
      const float x = gs_s + gd[dn];
      const float lx = x > 0.f ? x : LEAKY_SLOPE * x;
      const float num = expf(fminf(fmaxf(lx, -LOGIT_CLAMP), LOGIT_CLAMP));
      deriv = (lx > -LOGIT_CLAMP && lx < LOGIT_CLAMP) ? num * (x > 0.f ? 1.f : LEAKY_SLOPE) : 0.f;
      m = mask != nullptr ? mask[t_eid[e]] : 1.f;
      den_e = den[dn] + EPS;
      go = godot[dn];
      alpha = m * num / den_e;
    }
    const int cnt = min(32, end - base);
    float de_lane = 0.f;
    for (int j = 0; j < cnt; j += EDGE_ILP) {
      int dj[EDGE_ILP];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) dj[q] = __shfl_sync(FULL_MASK, dn, j + q);
      float y[EDGE_ILP][VPL];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        const T* r = gh + dj[q] * ld + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v) y[q][v] = (j + q < cnt) ? to_f32(r[v * 32]) : 0.f;
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
          for (int v = 0; v < VPL; ++v) p[q] += hv[v] * y[q][v];
        }
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) p[q] = warp_sum(p[q]);
      }
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        const float dq = __shfl_sync(FULL_MASK, deriv, j + q);
        const float mq = __shfl_sync(FULL_MASK, m, j + q);
        const float aq = __shfl_sync(FULL_MASK, alpha, j + q);
        const float goq = __shfl_sync(FULL_MASK, go, j + q);
        const float dnq = __shfl_sync(FULL_MASK, den_e, j + q);
        if (j + q < cnt) {
#pragma unroll
          for (int v = 0; v < VPL; ++v) acc[v] += aq * y[q][v];
          if (lane == j + q) de_lane = ((mq * p[q] - goq) / dnq) * dq;
        }
      }
    }
    dsum += de_lane;
  }
  dsum = warp_sum(dsum);
  float* o = dh + static_cast<long long>(row) * (GIVEN ? ld_out : VPL * 32) + lane;
#pragma unroll
  for (int v = 0; v < VPL; ++v) o[v * 32] = acc[v] + dsum * a_src[v * 32 + lane];
}

template <typename T>
cudaError_t launch(int vpl, dim3 grid, dim3 block, cudaStream_t st, const T* hs, const T* gh,
                   const float* a_src, const float* gs, const float* gd, const float* den,
                   const float* godot, const int* t_ptr, const int* t_dst, const int* t_eid,
                   const float* mask, float* dh, int n, long long ld, long long ld_out,
                   const float* ghs) {
  switch (vpl) {
#define PPT_CASE(V)                                                                              \
  case V:                                                                                        \
    if (ghs != nullptr) {                                                                        \
      bwd_src<T, V, true><<<grid, block, 0, st>>>(hs, gh, a_src, gs, gd, den, godot, t_ptr,     \
                                                  t_dst, t_eid, mask, dh, n, ld, ld_out, ghs);  \
    } else {                                                                                     \
      bwd_src<T, V, false><<<grid, block, 0, st>>>(hs, gh, a_src, gs, gd, den, godot, t_ptr,    \
                                                   t_dst, t_eid, mask, dh, n, ld, ld_out, ghs); \
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

template <typename T>
cudaError_t backward(const T* hs, const T* gh, const float* a_src, const float* gs,
                     const float* gd, const float* den, const float* godot, const int* t_ptr,
                     const int* t_dst, const int* t_eid, const float* mask, float* dh, int n,
                     int d, long long ld, float* ghs, cudaStream_t st) {
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  if (d <= STRIP) {
    return launch<T>(d / 32, grid, block, st, hs, gh, a_src, gs, gd, den, godot, t_ptr, t_dst,
                     t_eid, mask, dh, n, ld, d, nullptr);
  }
  row_dots<T, T><<<grid, block, 0, st>>>(hs, gh, nullptr, t_ptr, t_dst, ghs, nullptr, n, d, ld,
                                         ld);
  cudaError_t err = cudaGetLastError();
  for (int c0 = 0; c0 < d && err == cudaSuccess; c0 += STRIP) {
    const int w = d - c0 < STRIP ? d - c0 : STRIP;
    err = launch<T>(w / 32, grid, block, st, hs + c0, gh + c0, a_src + c0, gs, gd, den, godot,
                    t_ptr, t_dst, t_eid, mask, dh + c0, n, ld, d, ghs);
  }
  return err;
}

}  // namespace

// hs / gh [n, d] rows and cotangent rows at the row type (bf16 if bf16, else
// f32); a_src [d], gs/gd/den/godot [n] f32; t_ptr [n + 1], t_dst [E], t_eid
// [E] int32 (transpose CSR); mask [E] f32 over canonical ids or null.
// Writes dh [n, d] f32. d must be a positive multiple of 32; above 512, ghs
// is an [E] f32 scratch buffer (per-entry gh_d . hs_s), else unused. Row r
// of hs and of gh starts ld elements after row r - 1 (ld = d for contiguous
// rows; heads * d for one head's rows of an [n, heads, d] tensor).
PPT_EXPORT int ppt_gat_bwd_src(const void* hs, const void* gh, int bf16, const float* a_src,
                               const float* gs, const float* gd, const float* den,
                               const float* godot, const int* t_ptr, const int* t_dst,
                               const int* t_eid, const float* mask, float* dh, int n, int d,
                               int ld, float* ghs, void* stream) {
  if (d <= 0 || d % 32 != 0 || ld < d || (d > STRIP && ghs == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return backward<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(hs),
                                   static_cast<const __nv_bfloat16*>(gh), a_src, gs, gd, den,
                                   godot, t_ptr, t_dst, t_eid, mask, dh, n, d, ld, ghs, st);
  }
  return backward<float>(static_cast<const float*>(hs), static_cast<const float*>(gh), a_src, gs,
                         gd, den, godot, t_ptr, t_dst, t_eid, mask, dh, n, d, ld, ghs, st);
}
