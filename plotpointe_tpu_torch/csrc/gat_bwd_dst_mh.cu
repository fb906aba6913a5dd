// Head-packed multi-head GAT attention backward, destination order (B1 per
// head).
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_bwd_kernel_mh (launched by
// _bwd_call_mh). For each destination d with cotangent rows g_d,k, each
// in-edge s -> d (canonical id e) and each head k (mask row k):
//   x     = gs_s,k + gd_d,k             (gs = round(h) . a_src, gd = h . a_dst)
//   lx    = lrelu(x, 0.2);  num = exp(clamp(lx, -10, 10))
//   deriv = num * 1[-10 < lx < 10] * (x > 0 ? 1 : 0.2)
//   ghs   = g_d,k . hs_s,k              (hs: rows rounded to the row type)
//   de_e  = ((mask_k,e * ghs - godot_d,k) / (den_d,k + 1e-9)) * deriv
// and it emits de_sum[d, k] = sum_e de_e, godot[d, k] = g_d,k . out_d,k and
// partial sums of de_e * hs_s,k (summed by the caller into d a_src [H, D]).
// Each head is gat_bwd_dst.cu's function; the transpose pass (dh) is
// gat_bwd_src.cu once per head.
//
// What bounds it: bytes. Each edge gathers one source row of H * D values
// chosen by the graph; the arithmetic is 4 FLOP per gathered element.
//
// Design: one warp per destination row, as gat_bwd_dst.cu, with the whole
// [H * D] source row of each edge read once for every head. Lanes hold
// H * D / 32 values of g_d (value v of a lane belongs to head v / (D / 32),
// static); each edge takes H warp reductions (one ghs per head). A fixed
// grid of warps strides over the rows and keeps de_e * hs_s in registers;
// each warp writes one partial row of H * D and the caller sums the
// [warps, H * D] buffer in a fixed order. No atomics: deterministic.
#include "attention.cuh"

namespace {

template <typename T>
struct BwdArgs {
  const T* hs;         // [n, H * D] rows at the row type
  const float* gs;     // [n, H]
  const float* gd;     // [n, H]
  const float* g;      // [n, H * D]
  const float* out;    // [n, H * D]
  const float* den;    // [n, H]
  const int* row_ptr;  // [n + 1]
  const int* src;      // [E]
  const float* mask;   // [H, E] or null
  float* de_sum;       // [n, H]
  float* godot;        // [n, H]
  float* partial;      // [warps, H * D]
  int n;
  int n_edges;
};

template <typename T, int H, int VPH>
__global__ void bwd_dst_mh(BwdArgs<T> a) {
  constexpr int VPL = H * VPH;
  constexpr int HD = VPL * 32;
  // source rows in flight per warp: 32 registers of row values
  constexpr int EDGE_ILP = VPL <= 4 ? 8 : (VPL <= 8 ? 4 : (VPL <= 16 ? 2 : 1));
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int n_warps = gridDim.x * WARPS_PER_BLOCK;

  float pacc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) pacc[v] = 0.f;

  for (int row = warp; row < a.n; row += n_warps) {
    const int beg = a.row_ptr[row];
    const int end = a.row_ptr[row + 1];
    const float* grow = a.g + static_cast<long long>(row) * HD + lane;
    const float* orow = a.out + static_cast<long long>(row) * HD + lane;
    float gv[VPL], go[H], g_d[H], den_e[H], dsum[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      go[k] = 0.f;
      dsum[k] = 0.f;
      g_d[k] = a.gd[static_cast<long long>(row) * H + k];
      den_e[k] = a.den[static_cast<long long>(row) * H + k] + EPS;
    }
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      gv[v] = grow[v * 32];
      go[v / VPH] += gv[v] * orow[v * 32];
    }
#pragma unroll
    for (int k = 0; k < H; ++k) go[k] = warp_sum(go[k]);

    for (int base = beg; base < end; base += 32) {
      const int e = base + lane;
      int s = 0;
      float deriv[H], m[H];
#pragma unroll
      for (int k = 0; k < H; ++k) {
        deriv[k] = 0.f;
        m[k] = 0.f;
      }
      if (e < end) {
        s = a.src[e];
#pragma unroll
        for (int k = 0; k < H; ++k) {
          const float x = a.gs[static_cast<long long>(s) * H + k] + g_d[k];
          const float lx = x > 0.f ? x : LEAKY_SLOPE * x;
          const float num = expf(fminf(fmaxf(lx, -LOGIT_CLAMP), LOGIT_CLAMP));
          deriv[k] = (lx > -LOGIT_CLAMP && lx < LOGIT_CLAMP) ? num * (x > 0.f ? 1.f : LEAKY_SLOPE)
                                                              : 0.f;
          m[k] = a.mask != nullptr ? a.mask[static_cast<long long>(k) * a.n_edges + e] : 1.f;
        }
      }
      const int cnt = min(32, end - base);
      float de_lane[H];  // de of this lane's own edge, per head
#pragma unroll
      for (int k = 0; k < H; ++k) de_lane[k] = 0.f;
      for (int j = 0; j < cnt; j += EDGE_ILP) {
        int sj[EDGE_ILP];
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) sj[q] = __shfl_sync(FULL_MASK, s, j + q);
        float x[EDGE_ILP][VPL];
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
          const T* r = a.hs + static_cast<long long>(sj[q]) * HD + lane;
#pragma unroll
          for (int v = 0; v < VPL; ++v) x[q][v] = (j + q < cnt) ? to_f32(r[v * 32]) : 0.f;
        }
        float p[EDGE_ILP][H];
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
#pragma unroll
          for (int k = 0; k < H; ++k) p[q][k] = 0.f;
#pragma unroll
          for (int v = 0; v < VPL; ++v) p[q][v / VPH] += gv[v] * x[q][v];
#pragma unroll
          for (int k = 0; k < H; ++k) p[q][k] = warp_sum(p[q][k]);
        }
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
#pragma unroll
          for (int k = 0; k < H; ++k) {
            const float dq = __shfl_sync(FULL_MASK, deriv[k], j + q);
            const float mq = __shfl_sync(FULL_MASK, m[k], j + q);
            if (j + q < cnt) {
              const float de = ((mq * p[q][k] - go[k]) / den_e[k]) * dq;
#pragma unroll
              for (int u = 0; u < VPH; ++u) pacc[k * VPH + u] += de * x[q][k * VPH + u];
              if (lane == j + q) de_lane[k] = de;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < H; ++k) dsum[k] += de_lane[k];
    }
#pragma unroll
    for (int k = 0; k < H; ++k) dsum[k] = warp_sum(dsum[k]);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < H; ++k) {
        a.de_sum[static_cast<long long>(row) * H + k] = dsum[k];
        a.godot[static_cast<long long>(row) * H + k] = go[k];
      }
    }
  }
  float* prow = a.partial + static_cast<long long>(warp) * HD + lane;
#pragma unroll
  for (int v = 0; v < VPL; ++v) prow[v * 32] = pacc[v];
}

template <typename T, int H, int VPH>
cudaError_t launch_hv(dim3 grid, dim3 block, cudaStream_t st, const BwdArgs<T>& a) {
  if constexpr (H * VPH <= 32) {
    bwd_dst_mh<T, H, VPH><<<grid, block, 0, st>>>(a);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, int H>
cudaError_t launch_h(int vph, dim3 grid, dim3 block, cudaStream_t st, const BwdArgs<T>& a) {
  switch (vph) {
    case 1: return launch_hv<T, H, 1>(grid, block, st, a);
    case 2: return launch_hv<T, H, 2>(grid, block, st, a);
    case 4: return launch_hv<T, H, 4>(grid, block, st, a);
    case 8: return launch_hv<T, H, 8>(grid, block, st, a);
    case 16: return launch_hv<T, H, 16>(grid, block, st, a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch(int heads, int vph, dim3 grid, dim3 block, cudaStream_t st,
                   const BwdArgs<T>& a) {
  switch (heads) {
    case 2: return launch_h<T, 2>(vph, grid, block, st, a);
    case 3: return launch_h<T, 3>(vph, grid, block, st, a);
    case 4: return launch_h<T, 4>(vph, grid, block, st, a);
    case 5: return launch_h<T, 5>(vph, grid, block, st, a);
    case 6: return launch_h<T, 6>(vph, grid, block, st, a);
    case 7: return launch_h<T, 7>(vph, grid, block, st, a);
    case 8: return launch_h<T, 8>(vph, grid, block, st, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// hs [n, heads, d] rows (bf16 if hs_bf16, else f32); gs/gd/den [n, heads]
// f32; g/out [n, heads, d] f32; row_ptr [n + 1], src [E] int32 (CSR by
// destination); mask [heads, E] f32 over canonical ids or null. Writes
// de_sum [n, heads], godot [n, heads] and partial [n_blocks * 8, heads * d]
// f32. 2 <= heads <= 8; d a power of two in [32, 512]; heads * d <= 1024.
PPT_EXPORT int ppt_gat_bwd_dst_mh(const void* hs, int hs_bf16, const float* gs, const float* gd,
                                  const float* g, const float* out, const float* den,
                                  const int* row_ptr, const int* src, const float* mask,
                                  float* de_sum, float* godot, float* partial, int n, int heads,
                                  int d, int n_edges, int n_blocks, void* stream) {
  if (heads < 2 || heads > 8 || d < 32 || d > 512 || (d & (d - 1)) != 0 || heads * d > 1024 ||
      n_blocks <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid(n_blocks);
  const int vph = d / 32;
  if (hs_bf16) {
    const BwdArgs<__nv_bfloat16> a{static_cast<const __nv_bfloat16*>(hs), gs, gd, g, out, den,
                                   row_ptr, src, mask, de_sum, godot, partial, n, n_edges};
    return launch<__nv_bfloat16>(heads, vph, grid, block, st, a);
  }
  const BwdArgs<float> a{static_cast<const float*>(hs), gs, gd, g, out, den, row_ptr, src, mask,
                         de_sum, godot, partial, n, n_edges};
  return launch<float>(heads, vph, grid, block, st, a);
}
