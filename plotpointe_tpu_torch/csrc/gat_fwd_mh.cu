// Head-packed multi-head GAT attention forward over a destination CSR.
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_fwd_kernel_mh (launched by
// _fwd_call_mh). h is [n, H, D]; per edge s -> d and head k (mask row k):
//   logit_k = clamp(lrelu(hs_s,k . a_src_k + h_d,k . a_dst_k, 0.2), -10, 10)
//   num_k   = exp(logit_k)
//   den_d,k = sum num_k                 (unmasked)
//   out_d,k = sum mask_k * num_k * hs_s,k / (den_d,k + 1e-9)
// hs is h rounded to the row type (bf16 or f32); the destination term uses
// the f32 rows. All sums are f32. Each head is kernel 1's function.
//
// What bounds it: bytes. Each edge reads one source row of H * D values
// chosen by the graph; the arithmetic is 2 FLOP per gathered element.
//
// Design: the TPU kernel's point is that one stream of gathered rows serves
// every head; here one warp per destination reads each in-edge's whole
// [H * D] source row once, for all heads.
//   node_terms_mh: one warp per node writes the rounded rows (bf16 mode) and
//     the per-head logit terms gs[n, H] and gd[n, H].
//   aggregate_mh: one warp per destination. The 32 lanes take 32 edges at a
//     time for the scalar part (src index, H logits, H exps, H mask values);
//     then the warp walks those edges, each lane holding H * D / 32 values of
//     the running sums in registers (value v of a lane belongs to head
//     v / (D / 32), known at compile time), several rows in flight. Per-head
//     numerators, denominators and masks; no atomics, a fixed order.
// H and D / 32 are template parameters (2 <= H <= 8, D in {32, ..., 512} a
// power of two, H * D <= 1024), so the head of every register is static.
#include "attention.cuh"

namespace {

template <typename T>
__global__ void node_terms_mh(const float* __restrict__ h, const float* __restrict__ a_src,
                              const float* __restrict__ a_dst, T* __restrict__ hs,
                              float* __restrict__ gs, float* __restrict__ gd, int n, int heads,
                              int d) {
  const int node = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= n) return;
  const long long hd = static_cast<long long>(heads) * d;
  const float* row = h + node * hd;
  for (int k = 0; k < heads; ++k) {
    float s = 0.f, t = 0.f;
    for (int f = k * d + lane; f < (k + 1) * d; f += 32) {
      const float x = row[f];
      if (hs != nullptr) store_row(hs + node * hd + f, x);
      s += round_to(x, hs) * a_src[f];
      t += x * a_dst[f];
    }
    s = warp_sum(s);
    t = warp_sum(t);
    if (lane == 0) {
      gs[static_cast<long long>(node) * heads + k] = s;
      gd[static_cast<long long>(node) * heads + k] = t;
    }
  }
}

template <typename T>
struct FwdArgs {
  const T* hs;         // [n, H * D] rows at the row type
  const float* gs;     // [n, H]
  const float* gd;     // [n, H]
  const int* row_ptr;  // [n + 1]
  const int* src;      // [E]
  const float* mask;   // [H, E] or null
  float* out;          // [n, H * D]
  float* den;          // [n, H]
  int n;
  int n_edges;
};

template <typename T, int H, int VPH>
__global__ void aggregate_mh(FwdArgs<T> a) {
  constexpr int VPL = H * VPH;  // values of one row a lane holds
  constexpr int HD = VPL * 32;
  // source rows in flight per warp: 64 registers of row values
  constexpr int EDGE_ILP = VPL <= 4 ? 16 : (VPL <= 8 ? 8 : (VPL <= 16 ? 4 : 2));
  const int row = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= a.n) return;
  const int beg = a.row_ptr[row];
  const int end = a.row_ptr[row + 1];
  float g_d[H], den[H];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    g_d[k] = a.gd[static_cast<long long>(row) * H + k];
    den[k] = 0.f;
  }
  float acc[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) acc[v] = 0.f;

  for (int base = beg; base < end; base += 32) {
    const int e = base + lane;
    int s = 0;
    float w[H];
#pragma unroll
    for (int k = 0; k < H; ++k) w[k] = 0.f;
    if (e < end) {
      s = a.src[e];
#pragma unroll
      for (int k = 0; k < H; ++k) {
        float x = a.gs[static_cast<long long>(s) * H + k] + g_d[k];
        x = x > 0.f ? x : LEAKY_SLOPE * x;
        x = fminf(fmaxf(x, -LOGIT_CLAMP), LOGIT_CLAMP);
        const float num = expf(x);
        den[k] += num;
        w[k] = a.mask != nullptr ? num * a.mask[static_cast<long long>(k) * a.n_edges + e] : num;
      }
    }
    const int cnt = min(32, end - base);
    for (int j = 0; j < cnt; j += EDGE_ILP) {
      int sj[EDGE_ILP];
      float wj[EDGE_ILP][H];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        sj[q] = __shfl_sync(FULL_MASK, s, j + q);
#pragma unroll
        for (int k = 0; k < H; ++k) wj[q][k] = __shfl_sync(FULL_MASK, w[k], j + q);
      }
      float x[EDGE_ILP][VPL];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        const T* r = a.hs + static_cast<long long>(sj[q]) * HD + lane;
#pragma unroll
        for (int v = 0; v < VPL; ++v) x[q][v] = (j + q < cnt) ? to_f32(r[v * 32]) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        if (j + q < cnt) {
#pragma unroll
          for (int v = 0; v < VPL; ++v) acc[v] += wj[q][v / VPH] * x[q][v];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < H; ++k) den[k] = warp_sum(den[k]);
  float* o = a.out + static_cast<long long>(row) * HD + lane;
#pragma unroll
  for (int v = 0; v < VPL; ++v) o[v * 32] = acc[v] / (den[v / VPH] + EPS);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < H; ++k) a.den[static_cast<long long>(row) * H + k] = den[k];
  }
}

template <typename T, int H, int VPH>
cudaError_t launch_hv(dim3 grid, dim3 block, cudaStream_t st, const FwdArgs<T>& a) {
  if constexpr (H * VPH <= 32) {
    aggregate_mh<T, H, VPH><<<grid, block, 0, st>>>(a);
    return cudaGetLastError();
  } else {
    return cudaErrorInvalidValue;
  }
}

template <typename T, int H>
cudaError_t launch_h(int vph, dim3 grid, dim3 block, cudaStream_t st, const FwdArgs<T>& a) {
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
                   const FwdArgs<T>& a) {
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

// h [n, heads, d] f32; a_src/a_dst [heads, d] f32; row_ptr [n + 1], src [E]
// int32 (CSR by destination); mask [heads, E] f32 over canonical edge ids or
// null; hs_bf16 [n, heads, d] bf16 scratch (bf16 rows) or null (f32 rows: h
// itself is read); gs/gd [n, heads] f32 scratch; out [n, heads, d] f32; den
// [n, heads] f32. 2 <= heads <= 8; d a power of two in [32, 512];
// heads * d <= 1024.
PPT_EXPORT int ppt_gat_fwd_mh(const float* h, const float* a_src, const float* a_dst,
                              const int* row_ptr, const int* src, const float* mask,
                              void* hs_bf16, float* gs, float* gd, float* out, float* den, int n,
                              int heads, int d, int n_edges, void* stream) {
  if (heads < 2 || heads > 8 || d < 32 || d > 512 || (d & (d - 1)) != 0 || heads * d > 1024)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  const int vph = d / 32;
  if (hs_bf16 != nullptr) {
    auto* hs = static_cast<__nv_bfloat16*>(hs_bf16);
    node_terms_mh<__nv_bfloat16><<<grid, block, 0, st>>>(h, a_src, a_dst, hs, gs, gd, n, heads, d);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const FwdArgs<__nv_bfloat16> a{hs, gs, gd, row_ptr, src, mask, out, den, n, n_edges};
    return launch<__nv_bfloat16>(heads, vph, grid, block, st, a);
  }
  node_terms_mh<float><<<grid, block, 0, st>>>(h, a_src, a_dst, nullptr, gs, gd, n, heads, d);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const FwdArgs<float> a{h, gs, gd, row_ptr, src, mask, out, den, n, n_edges};
  return launch<float>(heads, vph, grid, block, st, a);
}
