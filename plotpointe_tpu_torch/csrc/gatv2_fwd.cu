// GATv2 attention forward over a destination CSR, at 1 to 8 heads.
//
// Port-only (the JAX package has no GATv2). Rows are [n, H, D]; per edge
// s -> d (canonical id e) and head k:
//   z       = rl_s,k + xr_d,k                  (D values; rl: xl at the row type)
//   score   = a_k . lrelu(z, 0.2)
//   num     = exp(clamp(score, -10, 10))
//   den_d,k = sum num                          (unmasked)
//   out_d,k = sum m_k,e * num * rl_s,k / (den_d,k + 1e-9)
// m the dropout multiplier of gatv2.cuh's hash. rl is bf16 or f32, xr and a
// f32; every sum is f32. Unlike GAT's logit (gat_fwd.cu), this one does not
// split into per-node terms: every edge does D-wide work per head.
//
// What bounds it: bytes. Each edge gathers one source row of H * D values
// chosen by the graph; the compulsory traffic reads xr and writes out once.
// The arithmetic is 6 FLOP a gathered value (the add, the LeakyReLU, the
// logit's FMA and the weighted sum's).
//
// Design: the edge-balanced walk of walk.cuh over the plan of row_ptr. A
// block takes WALK_UNITS units: it stages its entries' src with cp.async and
// their dropout multipliers, block-wide, in shared memory. Each lane group
// (gatv2.cuh's layout) walks its unit. At a piece's start it loads the
// destination's xr row; then it gathers the entries' source rows, several in
// flight, forms each lane's part of each logit, and sums each head's parts
// with a butterfly over the head's lanes (every lane of the head gets the
// same bits), so every lane of a head sums the same num. A batch of rows in
// flight that crosses a piece's end is taken in two runs, the second after
// the next piece's xr is loaded. At a piece's end the group writes out =
// acc / (den + 1e-9) and den for a whole row, else (acc, den) to a scratch
// slot; a combine kernel sums a split row's slots in piece order. Softmax
// needs no running maximum (logits are clamped). No atomics, a fixed order:
// the same bits on every run.
#include "gatv2.cuh"

namespace {

template <typename T>
struct FwdArgs {
  const T* rl;           // [n, W] rows at the row type, W = H * D
  const float* xr;       // [n, W]
  const float* a;        // [W]
  const int* piece_ptr;  // the plan of row_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* src;    // [E]
  const int* erow;   // [E] each entry's destination
  float* out;        // [n, W]
  float* den;        // [n, H]
  float* scratch;    // [slots, W]
  float* scratch_den;  // [slots, H]
  int n_units, heads, d;
  RowLayout l;
  int stride;  // entries between the shared arrays (odd)
  Drop drop;
};

// C: 16-byte chunks a lane holds of one row
template <typename T, int C>
__global__ void __launch_bounds__(32 * WALK_UNITS, C * RowVec<T>::kElems >= 32 ? 1 : 2)
    gatv2_fwd_walk(FwdArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  constexpr int FIT = 32 / (C * VEC);  // source row values in registers: 32 at most
  constexpr int EDGE_ILP = FIT > 4 ? 4 : (FIT < 1 ? 1 : FIT);
  extern __shared__ int smem[];
  const int H = a.heads, st = a.stride;
  const long long W = static_cast<long long>(H) * a.d;
  int* s_src = smem;
  float* s_m = reinterpret_cast<float*>(smem + st);  // [H][st] with dropout

  const BlockUnits b = block_units(a.piece_ptr, a.unit_ptr, a.n_units);
  stage_ints(s_src, a.src + b.e0, b.cnt);
  if (a.drop.masked)
    for (int i = threadIdx.x; i < b.cnt; i += blockDim.x)
      for (int k = 0; k < H; ++k) s_m[k * st + i] = keep_of(a.drop, b.e0 + i, k);
  cp_async_wait_all();
  __syncthreads();

  const Lane<C, VEC> ln(a.l, a.d);
  const int u = b.u0 + ln.gid;
  if (u >= b.u1) return;
  float av[C][VEC];  // a at this lane's columns
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (ln.live[c]) {
      load_f32(a.a + (ln.c0 + 32 * c) * VEC, av[c]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) av[c][k] = 0.f;
    }
  }
  int p = a.unit_ptr[u];
  const int p_end = a.unit_ptr[u + 1];
  const int e_beg = a.piece_ptr[p];
  const int e_end = a.piece_ptr[p_end];
  int pe = 0;  // the current piece's end
  float xv[C][VEC], acc[C][VEC], dacc[C];

  // piece p's destination row of xr, and its sums restarted
  auto begin = [&]() {
    pe = a.piece_ptr[p + 1];
    const int o = piece_dest(a.piece_out, p);
    const long long row = o >= 0 ? o : a.erow[a.piece_ptr[p]];  // split rows' pieces hold entries
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dacc[c] = 0.f;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;
      if (ln.live[c]) {
        load_f32(a.xr + row * W + (ln.c0 + 32 * c) * VEC, xv[c]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) xv[c][k] = 0.f;
      }
    }
  };
  // write piece p's sums, then start the next piece
  auto next = [&]() {
    const int o = piece_dest(a.piece_out, p);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!ln.live[c]) continue;
      const int col = (ln.c0 + 32 * c) * VEC;
      if (o >= 0) {
        float v[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[k] = acc[c][k] / (dacc[c] + EPS);
        store_f32(a.out + o * W + col, v);
        if (ln.first[c]) a.den[static_cast<long long>(o) * H + ln.head[c]] = dacc[c];
      } else {
        const long long slot = -1LL - o;
        store_f32(a.scratch + slot * W + col, acc[c]);
        if (ln.first[c]) a.scratch_den[slot * H + ln.head[c]] = dacc[c];
      }
    }
    if (++p < p_end) begin();
  };

  begin();
  for (int e = e_beg; e < e_end; e += EDGE_ILP) {
    const int nq = min(EDGE_ILP, e_end - e);
    float x[EDGE_ILP][C][VEC];
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      const T* r = a.rl + static_cast<long long>(q < nq ? s_src[e + q - b.e0] : 0) * W;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (q < nq && ln.live[c]) {
          RowVec<T>::load(r + (ln.c0 + 32 * c) * VEC, x[q][c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) x[q][c][k] = 0.f;
        }
      }
    }
    for (int q0 = 0; q0 < nq;) {
      while (e + q0 == pe) next();  // the piece (and any empty ones after it) ended
      const int q1 = min(nq, pe - e);  // entries q0 .. q1 - 1 of the batch lie in this piece
      float sc[EDGE_ILP][C];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q)
#pragma unroll
        for (int c = 0; c < C; ++c) sc[q][c] = q >= q0 && q < q1 ? score_part(x[q][c], xv[c], av[c]) : 0.f;
      head_sums(sc, ln.head, ln.gmask, a.l.red, ln.merge);
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        if (q >= q0 && q < q1) {
          const int i = e + q - b.e0;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float num = expf(fminf(fmaxf(sc[q][c], -LOGIT_CLAMP), LOGIT_CLAMP));
            const float w = a.drop.masked ? s_m[ln.head[c] * st + i] * num : num;
            dacc[c] += num;
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[c][k] = fmaf(w, x[q][c][k], acc[c][k]);
          }
        }
      }
      q0 = q1;
    }
  }
  while (p < p_end) next();  // the last piece, then trailing empty ones
}

// out/den of each split row from its scratch slots, summed in piece order;
// one thread per (split row, 4 columns)
__global__ void gatv2_fwd_combine(const float4* __restrict__ scratch,
                                  const float* __restrict__ scratch_den,
                                  const int* __restrict__ split_rows,
                                  const int* __restrict__ split_ptr, float4* __restrict__ out,
                                  float* __restrict__ den, int n_split, int heads, int d) {
  const int w4 = heads * d / 4;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_split) * w4) return;
  const int r = static_cast<int>(i / w4);
  const int c = static_cast<int>(i - static_cast<long long>(r) * w4);
  const int k = c * 4 / d;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float dn = 0.f;
  for (int s = split_ptr[r]; s < split_ptr[r + 1]; ++s) {
    const float4 v = scratch[static_cast<long long>(s) * w4 + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    dn += scratch_den[static_cast<long long>(s) * heads + k];
  }
  const long long row = split_rows[r];
  const float q = dn + EPS;
  out[row * w4 + c] = make_float4(acc.x / q, acc.y / q, acc.z / q, acc.w / q);
  if (c * 4 % d == 0) den[row * heads + k] = dn;
}

template <typename T>
cudaError_t forward(const FwdArgs<T>& a, const int* split_rows, const int* split_ptr, int n_split,
                    cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.stride) * 4 * (1 + (a.drop.masked ? a.heads : 0));
  const dim3 block(32 * WALK_UNITS / a.l.groups);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = cudaErrorInvalidValue;
  if (a.n_units > 0) {
    switch ((a.l.nc + 31) / 32) {
#define PPT_CASE(C)                                              \
  case C:                                                        \
    if constexpr (C * RowVec<T>::kElems <= 32) {                 \
      err = allow_smem(gatv2_fwd_walk<T, C>, smem);              \
      if (err != cudaSuccess) return err;                        \
      gatv2_fwd_walk<T, C><<<grid, block, smem, st>>>(a);        \
      err = cudaGetLastError();                                  \
    }                                                            \
    break;
      PPT_CASE(1) PPT_CASE(2) PPT_CASE(3) PPT_CASE(4) PPT_CASE(5) PPT_CASE(6) PPT_CASE(7)
      PPT_CASE(8)
#undef PPT_CASE
      default:
        break;
    }
  } else {
    err = cudaSuccess;
  }
  if (err != cudaSuccess || n_split == 0) return err;
  const long long threads = static_cast<long long>(n_split) * a.heads * a.d / 4;
  gatv2_fwd_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(a.scratch), a.scratch_den, split_rows, split_ptr,
      reinterpret_cast<float4*>(a.out), a.den, n_split, a.heads, a.d);
  return cudaGetLastError();
}

}  // namespace

// rl [n, heads, d] rows at the row type (bf16 if bf16, else f32) and xr
// [n, heads, d] f32, 16-byte aligned; a [heads, d] f32; the plan of row_ptr
// (piece_ptr, piece_out, unit_ptr, as spmm_csr.cu takes it); src [E] and
// erow [E] int32 (each entry's source and destination). Writes out [n,
// heads, d] and den [n, heads] f32. scratch [slots, heads * d] and
// scratch_den [slots, heads] f32; split_rows [n_split], split_ptr [n_split
// + 1] int32. stride: an odd number of entries >= the most entries a
// block's WALK_UNITS units hold. 1 <= heads <= 8, d a power of two >= 32,
// heads * d <= 1024. masked, seed, thresh, scale, id_offset: the dropout
// (gatv2.cuh's Drop).
PPT_EXPORT int ppt_gatv2_fwd(const void* rl, int bf16, const float* xr, const float* a,
                             const int* piece_ptr, const int* piece_out, const int* unit_ptr,
                             const int* src, const int* erow, float* out, float* den,
                             float* scratch, float* scratch_den, const int* split_rows,
                             const int* split_ptr, int n, int heads, int d, int n_units,
                             int n_split, int stride, int masked, unsigned seed, unsigned thresh,
                             float scale, long long id_offset, void* stream) {
  if (!gatv2_shape_ok(heads, d, stride) ||
      (n_split > 0 && (piece_out == nullptr || scratch == nullptr || scratch_den == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Drop drop{masked, seed, thresh, scale, id_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const FwdArgs<__nv_bfloat16> f{static_cast<const __nv_bfloat16*>(rl), xr, a, piece_ptr, piece_out,
                                   unit_ptr, src, erow, out, den, scratch, scratch_den, n_units,
                                   heads, d, row_layout(heads, d, 8), stride, drop};
    return forward(f, split_rows, split_ptr, n_split, st);
  }
  const FwdArgs<float> f{static_cast<const float*>(rl), xr, a, piece_ptr, piece_out, unit_ptr, src,
                         erow, out, den, scratch, scratch_den, n_units, heads, d,
                         row_layout(heads, d, 4), stride, drop};
  return forward(f, split_rows, split_ptr, n_split, st);
}
