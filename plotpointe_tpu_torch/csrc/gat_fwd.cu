// Fused GAT attention forward over a destination CSR, at 1 to 8 heads.
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_fwd_kernel (kernel 1, one
// head, launched by _fwd_call) and ::_fwd_kernel_mh (kernel 8, 2-8 heads
// packed in one row, launched by _fwd_call_mh), and serves
// plotpointe_tpu/ops/gat_kernel.py::_fused_layer_kernel (the v2 contract:
// kernel 1's function with an explicit mask). h is [n, H, D]; per edge
// s -> d and head k (mask row k):
//   logit_k = clamp(lrelu(hs_s,k . a_src_k + h_d,k . a_dst_k, 0.2), -10, 10)
//   num_k   = exp(logit_k)
//   den_d,k = sum num_k                 (unmasked)
//   out_d,k = sum mask_k * num_k * hs_s,k / (den_d,k + 1e-9)
// hs is h rounded to the row type (bf16 or f32); the destination term uses
// the f32 rows, as the TPU kernels do. All sums are f32.
//
// What bounds it: bytes. Each edge reads one source row of H * D values
// chosen by the graph, so the traffic is a data-dependent gather of E rows,
// far above the compulsory N-row read; the arithmetic is 2 FLOP per
// gathered element. At the training shapes the rounded-row table is larger
// than or near the 50 MB L2, so most gathered rows come from device memory.
//
// Design: one lane group reads each in-edge's source row (all heads of it)
// once, in 16-byte chunks (8 bf16 or 4 f32 values a lane a chunk); a group
// is as wide as a row's chunks rounded up to a power of two, up to a warp,
// and lanes past the row's chunks idle.
//   node_terms: one warp per node writes the rounded rows (bf16 mode) and
//     the per-head logit terms gs[n, H] and gd[n, H] from the full rows.
//   attention_walk: the edge-balanced walk of walk.cuh over the plan of
//     row_ptr. A block takes WALK_UNITS units: it stages its entries' src
//     and destination rows with cp.async, then computes each entry's H
//     numerators (and masked weights) once, block-wide, into shared memory.
//     Each lane group then walks its unit's entries as one flat run, several
//     rows in flight; a lane's chunk lies in one head, whose weight it reads
//     from shared memory. At each piece's end the group writes the piece's
//     sums: out = acc / (den + 1e-9) and den for a whole row, else (acc, den)
//     to a scratch slot. Softmax needs no running maximum here (logits are
//     clamped to +-10), so a split row's sums are plain partial sums.
//   attention_walk_combine: each split row's slots summed in piece order,
//     then the same epilogue.
// A single head wider than STRIP (512) runs the walk and the combine once
// per column strip of <= 512, every strip fed the same gs and gd (the
// weighted sum is separable by column); the first strip writes den. No
// atomics, a fixed order: the same bits on every run.
#include "attention.cuh"
#include "walk.cuh"

namespace {

// HEADS: 1 (kernel 1), or 0 for `heads` at run time (kernel 8). A lane loads
// ILP columns of a row before it stores their rounded values: at one head the
// plain loop was the faster on the H100, at two heads four columns ahead.
template <typename T, int HEADS>
__global__ void node_terms(const float* __restrict__ h, const float* __restrict__ a_src,
                           const float* __restrict__ a_dst, T* __restrict__ hs,
                           float* __restrict__ gs, float* __restrict__ gd, int n, int heads_rt,
                           int d) {
  constexpr int ILP = HEADS == 1 ? 1 : 4;
  const int heads = HEADS > 0 ? HEADS : heads_rt;
  const int node = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= n) return;
  const long long hd = static_cast<long long>(heads) * d;
  for (int k = 0; k < heads; ++k) {
    const long long off = node * hd + static_cast<long long>(k) * d;  // head k's row
    const float* row = h + off;
    const float *as = a_src + k * d, *ad = a_dst + k * d;
    float s = 0.f, t = 0.f;
    for (int f0 = lane; f0 < d; f0 += 32 * ILP) {
      float x[ILP], xs[ILP], xd[ILP];
#pragma unroll
      for (int u = 0; u < ILP; ++u) {
        const int f = f0 + 32 * u;
        x[u] = f < d ? row[f] : 0.f;
        xs[u] = f < d ? as[f] : 0.f;
        xd[u] = f < d ? ad[f] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < ILP; ++u) {  // columns lane, lane + 32, ... summed in order
        const int f = f0 + 32 * u;
        if (f >= d) break;
        if (hs != nullptr) store_row(hs + off + f, x[u]);
        s += round_to(x[u], hs) * xs[u];
        t += x[u] * xd[u];
      }
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
struct WalkArgs {
  const T* hs;           // rows at the row type, ld apart, 16-byte aligned (a strip's columns)
  const float* gs;       // [n, H]
  const float* gd;       // [n, H]
  const int* piece_ptr;  // the plan of row_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* src;      // [E]
  const int* erow;     // [E] each entry's row (its destination)
  const float* mask;   // [H, E] or null
  float* out;          // rows ld apart (a strip's columns)
  float* den;          // [n, H], or null (a strip after the first)
  float* scratch;      // [slots, H * D]
  float* scratch_den;  // [slots, H]
  int n_units, n_edges, heads, d;
  long long ld;  // elements between rows of hs and of out
  int nc;        // 16-byte chunks of a row (H * D values)
  int groups;    // lane groups a warp
  int stride;    // entries between the shared arrays (odd)
};

// C: 16-byte chunks a lane holds of one row (ceil(nc / 32))
template <typename T, int C>
__global__ void __launch_bounds__(32 * WALK_UNITS, WALK_MIN_BLOCKS) attention_walk(WalkArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  // rows in flight per lane: 32 row values in registers at most
  constexpr int FIT = 32 / (C * VEC);
  constexpr int EDGE_ILP = FIT > 8 ? 8 : (FIT < 1 ? 1 : FIT);
  extern __shared__ int smem[];
  const int H = a.heads, st = a.stride;
  int* s_src = smem;
  float* s_num = reinterpret_cast<float*>(smem + st);  // [H][st]
  float* s_w = a.mask != nullptr ? s_num + H * st : s_num;  // [H][st] masked weights
  int* s_row = smem + st;  // staged rows, each overwritten by head 0's numerator

  const BlockUnits b = block_units(a.piece_ptr, a.unit_ptr, a.n_units);
  stage_ints(s_src, a.src + b.e0, b.cnt);
  stage_ints(s_row, a.erow + b.e0, b.cnt);
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < b.cnt; i += blockDim.x) {
    const long long s = s_src[i], r = s_row[i];
    for (int k = 0; k < H; ++k) {
      float x = a.gs[s * H + k] + a.gd[r * H + k];
      x = x > 0.f ? x : LEAKY_SLOPE * x;
      const float num = expf(fminf(fmaxf(x, -LOGIT_CLAMP), LOGIT_CLAMP));
      s_num[k * st + i] = num;
      if (a.mask != nullptr)
        s_w[k * st + i] = num * a.mask[static_cast<long long>(k) * a.n_edges + b.e0 + i];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int span = 32 / a.groups;  // lanes one row spans: nc rounded up to a power of two
  const int grp = lane / span;
  const int c0 = lane - grp * span;
  const int u = b.u0 + (threadIdx.x >> 5) * a.groups + grp;
  if (u >= b.u1) return;
  const long long w = static_cast<long long>(H) * a.d;  // a scratch row
  int head[C];      // the head of each of this lane's chunks
  bool first[C];    // the chunk starts its head: it writes den
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int col = (c0 + 32 * c) * VEC;
    const bool valid = c0 + 32 * c < a.nc;
    head[c] = valid ? col / a.d : 0;  // a chunk past the row: zeros, weighted by head 0
    first[c] = valid && col % a.d == 0;
  }
  int p = a.unit_ptr[u];
  const int p_end = a.unit_ptr[u + 1];
  int pe = a.piece_ptr[p + 1];
  const int e_end = a.piece_ptr[p_end];

  float acc[C][VEC], dacc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    dacc[c] = 0.f;
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;
  }

  // write piece p's sums and start the next piece
  auto flush = [&]() {
    const int o = piece_dest(a.piece_out, p);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int ch = c0 + 32 * c;
      if (ch < a.nc) {
        if (o >= 0) {
          float v[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = acc[c][k] / (dacc[c] + EPS);
          store_f32(a.out + o * a.ld + ch * VEC, v);
          if (first[c] && a.den != nullptr) a.den[static_cast<long long>(o) * H + head[c]] = dacc[c];
        } else {
          const long long slot = -1LL - o;
          store_f32(a.scratch + slot * w + ch * VEC, acc[c]);
          if (first[c]) a.scratch_den[slot * H + head[c]] = dacc[c];
        }
      }
      dacc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;
    }
    ++p;
  };

  for (int e = a.piece_ptr[p]; e < e_end; e += EDGE_ILP) {
    float xv[EDGE_ILP][C][VEC];
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      const T* r = a.hs + (e + q < e_end ? s_src[e + q - b.e0] : 0) * a.ld;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = c0 + 32 * c;
        if (e + q < e_end && ch < a.nc) {
          RowVec<T>::load(r + ch * VEC, xv[q][c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) xv[q][c][k] = 0.f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      if (e + q < e_end) {
        while (e + q == pe) {  // the piece (and any empty ones after it) ended
          flush();
          pe = a.piece_ptr[p + 1];
        }
        const int i = e + q - b.e0;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float wt = s_w[head[c] * st + i];
          dacc[c] += s_num[head[c] * st + i];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[c][k] += wt * xv[q][c][k];
        }
      }
    }
  }
  while (p < p_end) flush();  // the last piece, then trailing empty ones
}

// out/den of each split row from its scratch slots, summed in piece order;
// one thread per (split row, 4 columns); out rows ld4 float4s apart, den
// null for a strip after the first
__global__ void attention_walk_combine(const float4* __restrict__ scratch,
                                       const float* __restrict__ scratch_den,
                                       const int* __restrict__ split_rows,
                                       const int* __restrict__ split_ptr, float4* __restrict__ out,
                                       float* __restrict__ den, int n_split, int heads, int d,
                                       long long ld4) {
  const int hd4 = heads * d / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_split) * hd4) return;
  const int r = static_cast<int>(i / hd4);
  const int c = static_cast<int>(i - static_cast<long long>(r) * hd4);
  const int k = c * 4 / d;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float dn = 0.f;
  for (int s = split_ptr[r]; s < split_ptr[r + 1]; ++s) {
    const float4 v = scratch[static_cast<long long>(s) * hd4 + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    dn += scratch_den[static_cast<long long>(s) * heads + k];
  }
  const long long row = split_rows[r];
  const float q = dn + EPS;
  out[row * ld4 + c] = make_float4(acc.x / q, acc.y / q, acc.z / q, acc.w / q);
  if (den != nullptr && c * 4 % d == 0) den[row * heads + k] = dn;
}

template <typename T>
cudaError_t launch_walk(const WalkArgs<T>& a, size_t smem, cudaStream_t st) {
  const dim3 block(32 * WALK_UNITS / a.groups);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((a.nc + 31) / 32) {
#define PPT_CASE(C)                                              \
  case C:                                                        \
    if constexpr (C * RowVec<T>::kElems <= 32) {                 \
      err = allow_smem(attention_walk<T, C>, smem);              \
      if (err != cudaSuccess) return err;                        \
      attention_walk<T, C><<<grid, block, smem, st>>>(a);        \
      err = cudaGetLastError();                                  \
    }                                                            \
    break;
    PPT_CASE(1) PPT_CASE(2) PPT_CASE(3) PPT_CASE(4) PPT_CASE(5) PPT_CASE(6) PPT_CASE(7)
    PPT_CASE(8)
#undef PPT_CASE
    default:
      break;
  }
  return err;
}

// The forward's arguments, as ppt_gat_fwd takes them.
struct FwdArgs {
  const float *h, *a_src, *a_dst;
  const int *piece_ptr, *piece_out, *unit_ptr, *src, *erow;
  const float* mask;
  void* hs_bf16;
  float *gs, *gd, *out, *den, *scratch, *scratch_den;
  const int *split_rows, *split_ptr;
  int n, heads, d, n_edges, n_units, n_split, stride;
};

// node_terms over the full rows, then the walk and the combine over the
// whole [H * D] row or, for one head wider than STRIP, once per strip
template <typename T>
cudaError_t forward_walk(const FwdArgs& f, T* hs_out, const T* hs, cudaStream_t st) {
  const dim3 block(32 * WARPS_PER_BLOCK);
  const dim3 grid((f.n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
  if (f.heads == 1)
    node_terms<T, 1><<<grid, block, 0, st>>>(f.h, f.a_src, f.a_dst, hs_out, f.gs, f.gd, f.n, 1, f.d);
  else
    node_terms<T, 0><<<grid, block, 0, st>>>(f.h, f.a_src, f.a_dst, hs_out, f.gs, f.gd, f.n,
                                             f.heads, f.d);
  cudaError_t err = cudaGetLastError();
  const int width = f.heads * f.d;
  const int strip = f.heads == 1 ? STRIP : width;
  const size_t smem = static_cast<size_t>(f.stride) * 4 * (1 + f.heads * (f.mask != nullptr ? 2 : 1));
  for (int c0 = 0; c0 < width && err == cudaSuccess; c0 += strip) {
    const int w = width - c0 < strip ? width - c0 : strip;  // this pass's columns
    const int nc = w * static_cast<int>(sizeof(T)) / 16;
    int span = 1;
    while (span < nc && span < 32) span <<= 1;
    const WalkArgs<T> a{hs + c0, f.gs, f.gd, f.piece_ptr, f.piece_out, f.unit_ptr, f.src, f.erow,
                        f.mask, f.out + c0, c0 == 0 ? f.den : nullptr, f.scratch,
                        f.scratch_den, f.n_units, f.n_edges, f.heads, w / f.heads, width, nc,
                        32 / span, f.stride};
    err = launch_walk(a, smem, st);
    if (err != cudaSuccess || f.n_split == 0) continue;
    const long long threads = static_cast<long long>(f.n_split) * w / 4;
    attention_walk_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
        reinterpret_cast<const float4*>(f.scratch), f.scratch_den, f.split_rows, f.split_ptr,
        reinterpret_cast<float4*>(f.out + c0), c0 == 0 ? f.den : nullptr, f.n_split, f.heads,
        w / f.heads, width / 4);
    err = cudaGetLastError();
  }
  return err;
}

// Validate the arguments and run the forward at the row type.
inline int run_forward(const FwdArgs& f, cudaStream_t st) {
  if (f.stride % 2 == 0 ||
      (f.n_split > 0 && (f.piece_out == nullptr || f.scratch == nullptr || f.scratch_den == nullptr)))
    return cudaErrorInvalidValue;
  if (f.n == 0) return cudaSuccess;
  if (f.hs_bf16 != nullptr) {
    auto* hs = static_cast<__nv_bfloat16*>(f.hs_bf16);
    return forward_walk<__nv_bfloat16>(f, hs, hs, st);
  }
  return forward_walk<float>(f, nullptr, f.h, st);
}

}  // namespace

// h [n, heads, d] f32 (16-byte aligned); a_src/a_dst [heads, d] f32; the
// plan of row_ptr (piece_ptr, piece_out, unit_ptr, as spmm_csr.cu takes
// it); src [E] and erow [E] int32 (each entry's source and destination);
// mask [heads, E] f32 over canonical edge ids or null; hs_bf16 [n, heads, d]
// bf16 scratch (bf16 rows) or null (f32 rows: h itself is read); gs/gd
// [n, heads] f32 scratch; out [n, heads, d] f32; den [n, heads] f32;
// scratch [slots, heads * d] (one head: [slots, min(d, 512)]) and
// scratch_den [slots, heads] f32; split_rows [n_split], split_ptr
// [n_split + 1] int32. stride: an odd number of entries >= the most entries
// a block's WALK_UNITS units hold. One head: d a positive multiple of 32.
// 2 <= heads <= 8: d a power of two in [32, 512], heads * d <= 1024.
PPT_EXPORT int ppt_gat_fwd(const float* h, const float* a_src, const float* a_dst,
                           const int* piece_ptr, const int* piece_out, const int* unit_ptr,
                           const int* src, const int* erow, const float* mask, void* hs_bf16,
                           float* gs, float* gd, float* out, float* den, float* scratch,
                           float* scratch_den, const int* split_rows, const int* split_ptr, int n,
                           int heads, int d, int n_edges, int n_units, int n_split, int stride,
                           void* stream) {
  const bool one = heads == 1 && d > 0 && d % 32 == 0;
  const bool packed = heads >= 2 && heads <= 8 && d >= 32 && d <= 512 && (d & (d - 1)) == 0 &&
                      heads * d <= 1024;
  if (!one && !packed) return cudaErrorInvalidValue;
  const FwdArgs f{h, a_src, a_dst, piece_ptr, piece_out, unit_ptr, src, erow, mask, hs_bf16, gs,
                  gd, out, den, scratch, scratch_den, split_rows, split_ptr, n, heads, d, n_edges,
                  n_units, n_split, stride};
  return run_forward(f, static_cast<cudaStream_t>(stream));
}
