// HGT edge attention backward, destination order (B1).
//
// Port-only. For each target t with cotangent rows g_t, each in-edge s ->
// t (canonical id e) of relation r and each head h, with ps, the logit and
// lse as in hgt_fwd.cu:
//   alpha = exp(ps (q_t . K'_s) - lse_t)
//   ds    = alpha (g_t . V'_s - g_t . out_t)
//   c     = ds ps
// it emits dq_t = sum_e c K'_s, one partial row a block of dp [3, H] (dp[r,
// h] = sum over r's edges of ds (q_t . K'_s) scale; the caller sums the
// rows) and each edge's (c | alpha) [E, 2H], which B2 (hgt_bwd_src.cu)
// reads. kv is bf16 or f32; q, g, out, lse and p are f32; every sum is f32.
//
// What bounds it: bytes. Each edge gathers one stacked row of 2 H D values
// (K' and V') chosen by the graph and writes its 2 H scalars; the
// compulsory traffic reads q, g and out once and writes dq once.
//
// Design: the forward's walk (hgt_fwd.cu). At a piece's start the warp
// loads the target's q, g and out rows and lse and forms g . out per head,
// so every piece of a split row forms the same bits. Then it gathers the
// entries' rows, forms each lane's parts of each logit (the forward's
// instructions: the same bits) and of g . V', and sums each head's parts
// with a butterfly. Each lane keeps its heads' dp terms in registers across
// its unit; at the end the block sums its warps' in warp order through
// shared memory and writes one partial row. At a piece's end the warp writes
// dq for a whole row, else its sum to a scratch slot; a combine kernel sums
// a split row's slots in piece order. No atomics, a fixed order: the same
// bits on every run.
#include "hgt.cuh"

namespace {

template <typename T>
struct BwdArgs {
  const float* q;        // [n, W], W = H * D
  const T* kv;           // [S, 2W]
  const float* p;        // [3, H]
  const float* g;        // [n, W]
  const float* out;      // [n, W]
  const float* lse;      // [n, H]
  const int* piece_ptr;  // the plan of row_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* src;   // [E] stacked rows
  const int* erow;  // [E] each entry's target
  float* dq;        // [n, W]
  float* partial;   // [blocks, 3, H]
  float* edge;      // [E, 2H]: (c | alpha)
  float* scratch;   // [slots, W]
  int n_units, heads, d;
  RowLayout l;  // of the K' half
  int stride;   // entries between the shared arrays (odd)
  int off1, off2;
  float scale;
};

// CK: 16-byte chunks a lane holds of the K' half (as many of V')
template <typename T, int CK>
__global__ void __launch_bounds__(32 * WALK_UNITS, 2) hgt_bwd_dst_walk(BwdArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  constexpr int ILP = CK * VEC <= 8 ? 4 : 2;  // entries' rows in flight
  extern __shared__ __align__(16) int smem[];
  const int H = a.heads;
  const long long W = static_cast<long long>(H) * a.d;
  int* s_src = smem;

  const BlockUnits b = block_units(a.piece_ptr, a.unit_ptr, a.n_units);
  stage_ints(s_src, a.src + b.e0, b.cnt);
  cp_async_wait_all();
  __syncthreads();

  const Lane<CK, VEC> ln(a.l, a.d);
  const int u = b.u0 + ln.gid;
  float pacc[CK][HGT_REL];  // this lane's heads' dp terms over its unit
#pragma unroll
  for (int c = 0; c < CK; ++c)
#pragma unroll
    for (int r = 0; r < HGT_REL; ++r) pacc[c][r] = 0.f;

  if (u < b.u1) {  // a warp past the plan's end keeps zeros for the block's sum
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
    float qv[CK][VEC], gv[CK][VEC], dqa[CK][VEC], go[CK], ls[CK];

    // piece p's target terms: q, g, lse and g . out at this lane's chunks,
    // and dq restarted
    auto begin = [&]() {
      pe = a.piece_ptr[p + 1];
      const int o = piece_dest(a.piece_out, p);
      const long long row = o >= 0 ? o : a.erow[a.piece_ptr[p]];  // split rows' pieces hold entries
      float dot[1][CK];
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const long long col = (ln.c0 + 32 * c) * VEC;
        float ov[VEC];
        load_f32(a.q + row * W + col, qv[c]);
        load_f32(a.g + row * W + col, gv[c]);
        load_f32(a.out + row * W + col, ov);
        ls[c] = a.lse[row * H + ln.head[c]];
        dot[0][c] = dot_part(gv[c], ov);
#pragma unroll
        for (int k = 0; k < VEC; ++k) dqa[c][k] = 0.f;
      }
      head_sums(dot, ln.head, ln.gmask, a.l.red, false);
#pragma unroll
      for (int c = 0; c < CK; ++c) go[c] = dot[0][c];
    };
    // write piece p's dq, then start the next piece
    auto next = [&]() {
      const int o = piece_dest(a.piece_out, p);
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = (ln.c0 + 32 * c) * VEC;
        store_f32(o >= 0 ? a.dq + o * W + col : a.scratch + (-1LL - o) * W + col, dqa[c]);
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
        float s[2 * ILP][CK];  // q . K' parts, then g . V' parts
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
#pragma unroll
          for (int c = 0; c < CK; ++c) {
            const bool in = q >= q0 && q < q1;
            s[q][c] = in ? dot_part(qv[c], xk[q][c]) : 0.f;
            s[ILP + q][c] = in ? dot_part(gv[c], xv[q][c]) : 0.f;
          }
        }
        head_sums(s, ln.head, ln.gmask, a.l.red, false);
#pragma unroll
        for (int q = 0; q < ILP; ++q) {
          if (q >= q0 && q < q1) {
            const long long eid = e + q;
#pragma unroll
            for (int c = 0; c < CK; ++c) {
              const float ps = of_relation(pr[c], rel[q]);
              const float qk = s[q][c];
              const float al = expf(qk * ps - ls[c]);
              const float ds = al * (s[ILP + q][c] - go[c]);
              const float cc = ds * ps;
#pragma unroll
              for (int k = 0; k < VEC; ++k) dqa[c][k] = fmaf(cc, xk[q][c][k], dqa[c][k]);
              const float dp = ds * qk * a.scale;
#pragma unroll
              for (int r = 0; r < HGT_REL; ++r) pacc[c][r] += rel[q] == r ? dp : 0.f;
              if (ln.first[c]) {
                a.edge[eid * 2 * H + ln.head[c]] = cc;
                a.edge[eid * 2 * H + H + ln.head[c]] = al;
              }
            }
          }
        }
        q0 = q1;
      }
    }
    while (p < p_end) next();  // the last piece, then trailing empty ones
  }

  // the block's partial row of dp: its warps' terms summed in warp order
  __syncthreads();  // every warp's walk is done: the entry array is free
  float* s_dp = reinterpret_cast<float*>(smem);  // [WALK_UNITS][3][H]
#pragma unroll
  for (int c = 0; c < CK; ++c)
    if (ln.first[c])
#pragma unroll
      for (int r = 0; r < HGT_REL; ++r) s_dp[(ln.gid * HGT_REL + r) * H + ln.head[c]] = pacc[c][r];
  __syncthreads();
  for (int col = threadIdx.x; col < HGT_REL * H; col += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < WALK_UNITS; ++j) sum += s_dp[j * HGT_REL * H + col];
    a.partial[static_cast<long long>(blockIdx.x) * HGT_REL * H + col] = sum;
  }
}

template <typename T>
cudaError_t backward(const BwdArgs<T>& a, const int* split_rows, const int* split_ptr, int n_split,
                     cudaStream_t st) {
  const size_t entries = static_cast<size_t>(a.stride);
  const size_t dp_rows = static_cast<size_t>(WALK_UNITS) * HGT_REL * a.heads;
  const size_t smem = (entries > dp_rows ? entries : dp_rows) * 4;
  const dim3 block(32 * WALK_UNITS);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = cudaSuccess;
  if (a.n_units > 0) {
    switch (a.l.nc / 32) {
#define HGT_CASE(CK)                                            \
  case CK:                                                      \
    if constexpr (CK * RowVec<T>::kElems <= 16) {                \
      err = allow_smem(hgt_bwd_dst_walk<T, CK>, smem);               \
      if (err != cudaSuccess) return err;                       \
      hgt_bwd_dst_walk<T, CK><<<grid, block, smem, st>>>(a);         \
      err = cudaGetLastError();                                 \
    }                                                           \
    break;
      HGT_CASE(1) HGT_CASE(2) HGT_CASE(4)
#undef HGT_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return err;
  return launch_sum_slots(a.scratch, split_rows, split_ptr, nullptr, a.dq, n_split, a.heads * a.d, st);
}

}  // namespace

// q, g, out [n, heads, d] f32 and kv [S, 2, heads, d] at the row type (bf16
// if bf16, else f32), all 16-byte aligned; p [3, heads] and lse [n, heads]
// f32; the plan of row_ptr (piece_ptr, piece_out, unit_ptr); src [E] and
// erow [E] int32. Writes dq [n, heads, d] f32, partial [blocks, 3, heads]
// f32 (blocks = ceil(n_units / WALK_UNITS)) and edge [E, 2 heads] f32 (c |
// alpha). scratch [slots, heads * d] f32; split_rows, split_ptr int32.
// stride, off1, off2, scale and the shapes as ppt_hgt_fwd.
PPT_EXPORT int ppt_hgt_bwd_dst(const float* q, const void* kv, int bf16, const float* p, const float* g,
                               const float* out, const float* lse, const int* piece_ptr,
                               const int* piece_out, const int* unit_ptr, const int* src,
                               const int* erow, float* dq, float* partial, float* edge, float* scratch,
                               const int* split_rows, const int* split_ptr, int n, int heads, int d,
                               int n_units, int n_split, int stride, int off1, int off2, float scale,
                               void* stream) {
  if (!hgt_shape_ok(heads, d, stride) || (n_split > 0 && (piece_out == nullptr || scratch == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const BwdArgs<__nv_bfloat16> f{q, static_cast<const __nv_bfloat16*>(kv), p, g, out, lse, piece_ptr,
                                   piece_out, unit_ptr, src, erow, dq, partial, edge, scratch, n_units,
                                   heads, d, row_layout(heads, d, 8), stride, off1, off2, scale};
    return backward(f, split_rows, split_ptr, n_split, st);
  }
  const BwdArgs<float> f{q, static_cast<const float*>(kv), p, g, out, lse, piece_ptr, piece_out,
                         unit_ptr, src, erow, dq, partial, edge, scratch, n_units, heads, d,
                         row_layout(heads, d, 4), stride, off1, off2, scale};
  return backward(f, split_rows, split_ptr, n_split, st);
}
