// HGT edge attention forward over a destination CSR.
//
// Port-only (the JAX package has no HGT). Over the relation-stacked table
// kv [S, 2, H, D] (K' then V' of each source under its edge's relation, at
// the row type), q [n, H, D] f32 and the prior p [3, H]; per edge s -> t
// of relation r and head h, ps = p[r, h] * scale:
//   logit  = ps * (q_t,h . K'_s,h)
//   lse_t  = log sum_e exp(logit)        over all of t's in-edges, every relation
//   out_t  = sum_e exp(logit - lse_t) V'_s,h     (0, lse -inf: no in-edges)
// kv is bf16 or f32, everything else f32, every sum f32.
//
// What bounds it: bytes. Each edge gathers one stacked row of 2 H D values
// (K' and V', contiguous) chosen by the graph; the compulsory traffic reads
// q and writes out once. The arithmetic is 4 FLOP a gathered pair of values
// (the dot's multiply-add and the weighted sum's).
//
// Design: the edge-balanced walk of walk.cuh over the plan of row_ptr, one
// warp a unit (hgt.cuh's lanes). A block stages its entries' stacked rows
// in shared memory with cp.async. At a piece's start a warp loads the
// target's q row and restarts its sums; then it gathers several entries'
// rows at once, forms each lane's part of each logit, sums each head's
// parts with a butterfly (every lane of a head gets the same bits) and
// folds the batch into an online softmax: the running maximum m, the sum l
// of exp(logit - m) and the weighted V' sum, rescaled by exp(m_old - m)
// when m grows. At a piece's end a row held whole writes out = acc / l and
// lse = m + log l; a split row's piece writes (acc, m, l) to a scratch slot,
// and a combine kernel merges a split row's slots in piece order. No
// atomics, a fixed order: the same bits on every run.
#include "hgt.cuh"

namespace {

template <typename T>
struct FwdArgs {
  const float* q;        // [n, W], W = H * D
  const T* kv;           // [S, 2W]
  const float* p;        // [3, H]
  const int* piece_ptr;  // the plan of row_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* src;    // [E] stacked rows
  const int* erow;   // [E] each entry's target
  float* out;        // [n, W]
  float* lse;        // [n, H]
  float* scratch;    // [slots, W]
  float* scratch_ml; // [slots, 2, H]: (m, l)
  int n_units, heads, d;
  RowLayout l;  // of the K' half
  int stride;   // entries between the shared arrays (odd)
  int off1, off2;
  float scale;
};

// CK: 16-byte chunks a lane holds of the K' half (as many of V')
template <typename T, int CK>
__global__ void __launch_bounds__(32 * WALK_UNITS, 2) hgt_fwd_walk(FwdArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  constexpr int ILP = CK * VEC <= 8 ? 4 : 2;  // entries' rows in flight
  extern __shared__ int smem[];
  const int H = a.heads;
  const long long W = static_cast<long long>(H) * a.d;
  int* s_src = smem;

  const BlockUnits b = block_units(a.piece_ptr, a.unit_ptr, a.n_units);
  stage_ints(s_src, a.src + b.e0, b.cnt);
  cp_async_wait_all();
  __syncthreads();

  const Lane<CK, VEC> ln(a.l, a.d);
  const int u = b.u0 + ln.gid;
  if (u >= b.u1) return;
  float pr[CK][HGT_REL];  // p * scale of this lane's heads
#pragma unroll
  for (int c = 0; c < CK; ++c)
#pragma unroll
    for (int r = 0; r < HGT_REL; ++r) pr[c][r] = a.p[r * H + ln.head[c]] * a.scale;
  int p = a.unit_ptr[u];
  const int p_end = a.unit_ptr[u + 1];
  const int e_beg = a.piece_ptr[p];
  const int e_end = a.piece_ptr[p_end];
  int pe = 0;  // the current piece's end
  float qv[CK][VEC], acc[CK][VEC], mx[CK], sm[CK];

  // piece p's target row of q, and its sums restarted
  auto begin = [&]() {
    pe = a.piece_ptr[p + 1];
    const int o = piece_dest(a.piece_out, p);
    const long long row = o >= 0 ? o : a.erow[a.piece_ptr[p]];  // split rows' pieces hold entries
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      mx[c] = -INFINITY;
      sm[c] = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;
      load_f32(a.q + row * W + (ln.c0 + 32 * c) * VEC, qv[c]);
    }
  };
  // write piece p's result, then start the next piece
  auto next = [&]() {
    const int o = piece_dest(a.piece_out, p);
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const int col = (ln.c0 + 32 * c) * VEC;
      if (o >= 0) {
        float v[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = sm[c] > 0.f ? acc[c][k] / sm[c] : 0.f;
        store_f32(a.out + o * W + col, v);
        if (ln.first[c]) a.lse[static_cast<long long>(o) * H + ln.head[c]] = mx[c] + logf(sm[c]);
      } else {
        const long long slot = -1LL - o;
        store_f32(a.scratch + slot * W + col, acc[c]);
        if (ln.first[c]) {
          a.scratch_ml[slot * 2 * H + ln.head[c]] = mx[c];
          a.scratch_ml[slot * 2 * H + H + ln.head[c]] = sm[c];
        }
      }
    }
    if (++p < p_end) begin();
  };

  begin();
  for (int e = e_beg; e < e_end; e += ILP) {
    const int nq = min(ILP, e_end - e);
    float xk[ILP][CK][VEC], xv[ILP][CK][VEC];
    int rel[ILP];
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      const int s = q < nq ? s_src[e + q - b.e0] : 0;
      rel[q] = relation_of(s, a.off1, a.off2);
      const T* r = a.kv + static_cast<long long>(s) * 2 * W;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = (ln.c0 + 32 * c) * VEC;
        if (q < nq) {
          RowVec<T>::load(r + col, xk[q][c]);
          RowVec<T>::load(r + W + col, xv[q][c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) xk[q][c][k] = xv[q][c][k] = 0.f;
        }
      }
    }
    for (int q0 = 0; q0 < nq;) {
      while (e + q0 == pe) next();  // the piece (and any empty ones after it) ended
      const int q1 = min(nq, pe - e);  // entries q0 .. q1 - 1 of the batch lie in this piece
      float sc[ILP][CK];
#pragma unroll
      for (int q = 0; q < ILP; ++q)
#pragma unroll
        for (int c = 0; c < CK; ++c) sc[q][c] = q >= q0 && q < q1 ? dot_part(qv[c], xk[q][c]) : 0.f;
      head_sums(sc, ln.head, ln.gmask, a.l.red, false);
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float top = mx[c];
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          if (q >= q0 && q < q1) {
            sc[q][c] *= of_relation(pr[c], rel[q]);
            top = fmaxf(top, sc[q][c]);
          }
        }
        const float corr = expf(mx[c] - top);  // 0 while the piece had no entry (mx -inf)
        sm[c] *= corr;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[c][k] *= corr;
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          if (q >= q0 && q < q1) {
            const float w = expf(sc[q][c] - top);
            sm[c] += w;
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[c][k] = fmaf(w, xv[q][c][k], acc[c][k]);
          }
        }
        mx[c] = top;
      }
      q0 = q1;
    }
  }
  while (p < p_end) next();  // the last piece, then trailing empty ones
}

// out/lse of each split row from its scratch slots (acc, m, l), merged in
// piece order; one thread per (split row, 4 columns)
__global__ void hgt_fwd_combine(const float4* __restrict__ scratch, const float* __restrict__ ml,
                                const int* __restrict__ split_rows, const int* __restrict__ split_ptr,
                                float4* __restrict__ out, float* __restrict__ lse, int n_split, int heads,
                                int d) {
  const int w4 = heads * d / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_split) * w4) return;
  const int r = static_cast<int>(i / w4);
  const int c = static_cast<int>(i - static_cast<long long>(r) * w4);
  const int k = c * 4 / d;
  const int s0 = split_ptr[r], s1 = split_ptr[r + 1];
  float top = -INFINITY;
  for (int s = s0; s < s1; ++s) top = fmaxf(top, ml[static_cast<long long>(s) * 2 * heads + k]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float l = 0.f;
  for (int s = s0; s < s1; ++s) {
    const float w = expf(ml[static_cast<long long>(s) * 2 * heads + k] - top);
    const float4 v = scratch[static_cast<long long>(s) * w4 + c];
    l = fmaf(ml[static_cast<long long>(s) * 2 * heads + heads + k], w, l);
    acc.x = fmaf(w, v.x, acc.x);
    acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z);
    acc.w = fmaf(w, v.w, acc.w);
  }
  const long long row = split_rows[r];
  out[row * w4 + c] = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  if (c * 4 % d == 0) lse[row * heads + k] = top + logf(l);
}

template <typename T>
cudaError_t forward(const FwdArgs<T>& a, const int* split_rows, const int* split_ptr, int n_split,
                    cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.stride) * 4;
  const dim3 block(32 * WALK_UNITS);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = cudaSuccess;
  if (a.n_units > 0) {
    switch (a.l.nc / 32) {
#define HGT_CASE(CK)                                            \
  case CK:                                                      \
    if constexpr (CK * RowVec<T>::kElems <= 16) {                \
      err = allow_smem(hgt_fwd_walk<T, CK>, smem);               \
      if (err != cudaSuccess) return err;                       \
      hgt_fwd_walk<T, CK><<<grid, block, smem, st>>>(a);         \
      err = cudaGetLastError();                                 \
    }                                                           \
    break;
      HGT_CASE(1) HGT_CASE(2) HGT_CASE(4)
#undef HGT_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess || n_split == 0) return err;
  const long long threads = static_cast<long long>(n_split) * a.heads * a.d / 4;
  hgt_fwd_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(a.scratch), a.scratch_ml, split_rows, split_ptr,
      reinterpret_cast<float4*>(a.out), a.lse, n_split, a.heads, a.d);
  return cudaGetLastError();
}

}  // namespace

// q [n, heads, d] f32; kv [S, 2, heads, d] rows at the row type (bf16 if
// bf16, else f32); both 16-byte aligned; p [3, heads] f32; the plan of
// row_ptr (piece_ptr, piece_out, unit_ptr, as spmm_csr.cu takes it); src
// [E] (stacked rows) and erow [E] (targets) int32. Writes out [n, heads, d]
// and lse [n, heads] f32. scratch [slots, heads * d] and scratch_ml [slots,
// 2, heads] f32; split_rows [n_split], split_ptr [n_split + 1] int32.
// stride: an odd number of entries >= the most entries a block's WALK_UNITS
// units hold. off1, off2: the first stacked rows of relations 1 and 2;
// scale: 1 / sqrt(D) of the model. Shapes as hgt.cuh's hgt_shape_ok.
PPT_EXPORT int ppt_hgt_fwd(const float* q, const void* kv, int bf16, const float* p,
                           const int* piece_ptr, const int* piece_out, const int* unit_ptr,
                           const int* src, const int* erow, float* out, float* lse, float* scratch,
                           float* scratch_ml, const int* split_rows, const int* split_ptr, int n,
                           int heads, int d, int n_units, int n_split, int stride, int off1, int off2,
                           float scale, void* stream) {
  if (!hgt_shape_ok(heads, d, stride) ||
      (n_split > 0 && (piece_out == nullptr || scratch == nullptr || scratch_ml == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const FwdArgs<__nv_bfloat16> f{q, static_cast<const __nv_bfloat16*>(kv), p, piece_ptr, piece_out,
                                   unit_ptr, src, erow, out, lse, scratch, scratch_ml, n_units, heads, d,
                                   row_layout(heads, d, 8), stride, off1, off2, scale};
    return forward(f, split_rows, split_ptr, n_split, st);
  }
  const FwdArgs<float> f{q, static_cast<const float*>(kv), p, piece_ptr, piece_out, unit_ptr, src, erow,
                         out, lse, scratch, scratch_ml, n_units, heads, d, row_layout(heads, d, 4),
                         stride, off1, off2, scale};
  return forward(f, split_rows, split_ptr, n_split, st);
}
