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
// Design: the edge-balanced walk of walk.cuh over the plan of the transpose
// CSR (t_ptr / t_dst / t_eid; erow names each entry's source row). A block
// takes WALK_UNITS units: it stages its entries' t_dst, source rows and
// t_eid with cp.async, then computes each entry's scalars (mask, deriv,
// alpha, godot_d, den_d + 1e-9) once, block-wide, into shared memory. Each
// lane group, as wide as a row's 16-byte chunks rounded up to a power of two
// (16 lanes for bf16 at D 128: two groups a warp), walks its unit's entries
// as one flat run with several cotangent rows in flight, the entry's own
// row hs_s beside each (read again for each entry of a piece: from L1 after
// the first). It forms each entry's ghs by a reduction inside the group
// (every lane gets the same bits), so every lane sums the same de. At each
// piece's end the group writes dh = acc + (sum de) * a_src for a whole row,
// else (acc, sum de) to a scratch slot; a combine kernel sums a split row's
// slots in piece order, then applies the same epilogue. Softmax needs no
// running maximum (logits are clamped), so the split is plain partial sums.
// No atomics: the same bits on every run.
// Rows wider than STRIP (512) columns: ghs spans the full row, so
// `row_dots` first writes ghs per entry of the transpose CSR over the full
// rows (one warp per row); then the walk runs once per column strip of
// <= 512, staging ghs instead of forming it, and writes its columns of dh.
// Any multiple of 32.
#include "attention.cuh"
#include "walk.cuh"

namespace {

template <typename T>
struct WalkArgs {
  const T* hs;  // [n, ld] rows, 16-byte aligned, ld a multiple of 16 bytes
  const T* gh;
  const float* a_src;
  const float* gs;
  const float* gd;
  const float* den;
  const float* godot;
  const int* piece_ptr;  // the plan of t_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* t_dst;
  const int* t_eid;
  const int* erow;     // [E] each entry's source row
  const float* mask;   // [E] over canonical ids, or null
  const float* ghs;    // [E] gh_d . hs_s over the full rows (column strips), or null
  float* dh;           // [n, ld_out]
  float* scratch;      // [slots, W]
  float* scratch_de;   // [slots]
  long long ld, ld_out;
  int n_units;
  int nc;      // 16-byte chunks of a (strip of a) row: W = nc * VEC
  int span;    // lanes of a group: a power of two >= min(nc, 32)
  int groups;  // lane groups a warp: 32 / span
  int stride;  // entries between the shared arrays (odd)
};

// C: 16-byte chunks a lane holds of one row; GIVEN: ghs is read, not formed
template <typename T, int C, bool GIVEN>
__global__ void __launch_bounds__(32 * WALK_UNITS, WALK_MIN_BLOCKS) bwd_src_units(WalkArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  constexpr int FIT = 32 / (C * VEC);  // cotangent values in registers: 32 at most
  constexpr int EDGE_ILP = FIT > 8 ? 8 : (FIT < 1 ? 1 : FIT);
  extern __shared__ int smem[];
  const int st = a.stride;
  int* s_dst = smem;
  int* s_row = smem + st;
  float* s_m = reinterpret_cast<float*>(smem + 2 * st);  // staged t_eid first
  float* s_deriv = s_m + st;
  float* s_alpha = s_m + 2 * st;
  float* s_go = s_m + 3 * st;
  float* s_den = s_m + 4 * st;
  float* s_p = s_m + 5 * st;  // GIVEN: ghs

  const BlockUnits b = block_units(a.piece_ptr, a.unit_ptr, a.n_units);
  stage_ints(s_dst, a.t_dst + b.e0, b.cnt);
  stage_ints(s_row, a.erow + b.e0, b.cnt);
  if (a.mask != nullptr) stage_ints(reinterpret_cast<int*>(s_m), a.t_eid + b.e0, b.cnt);
  if constexpr (GIVEN)
    stage_ints(reinterpret_cast<int*>(s_p), reinterpret_cast<const int*>(a.ghs + b.e0), b.cnt);
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < b.cnt; i += blockDim.x) {
    const int dn = s_dst[i];
    const float x = a.gs[s_row[i]] + a.gd[dn];
    const float lx = x > 0.f ? x : LEAKY_SLOPE * x;
    const float num = expf(fminf(fmaxf(lx, -LOGIT_CLAMP), LOGIT_CLAMP));
    const float m = a.mask != nullptr ? a.mask[reinterpret_cast<const int*>(s_m)[i]] : 1.f;
    const float den_e = a.den[dn] + EPS;
    s_m[i] = m;
    const bool inside = lx > -LOGIT_CLAMP && lx < LOGIT_CLAMP;
    s_deriv[i] = inside ? num * (x > 0.f ? 1.f : LEAKY_SLOPE) : 0.f;
    s_alpha[i] = m * num / den_e;
    s_go[i] = a.godot[dn];
    s_den[i] = den_e;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / a.span;
  const int c0 = lane - grp * a.span;
  const int u = b.u0 + (threadIdx.x >> 5) * a.groups + grp;
  if (u >= b.u1) return;  // a whole group leaves: no other group's shuffles name its lanes
  const unsigned gmask = a.span == 32 ? FULL_MASK : ((1u << a.span) - 1u) << (grp * a.span);
  const long long w = static_cast<long long>(a.nc) * VEC;  // scratch row width
  float as[C][VEC];  // a_src at this lane's columns
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ch = c0 + 32 * c;
    if (ch < a.nc) {
      load_f32(a.a_src + ch * VEC, as[c]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) as[c][k] = 0.f;
    }
  }
  int p = a.unit_ptr[u];
  const int p_end = a.unit_ptr[u + 1];
  int pe = a.piece_ptr[p + 1];
  const int e_end = a.piece_ptr[p_end];

  float acc[C][VEC], dsum = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;

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
          for (int k = 0; k < VEC; ++k) v[k] = acc[c][k] + dsum * as[c][k];
          store_f32(a.dh + o * a.ld_out + ch * VEC, v);
        } else {
          store_f32(a.scratch + (-1LL - o) * w + ch * VEC, acc[c]);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;
    }
    if (o < 0 && c0 == 0) a.scratch_de[-1LL - o] = dsum;
    dsum = 0.f;
    ++p;
  };

  for (int e = a.piece_ptr[p]; e < e_end; e += EDGE_ILP) {
    float y[EDGE_ILP][C][VEC];
    float pq[EDGE_ILP];
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      const bool live = e + q < e_end;
      const int i = e + q - b.e0;
      const T* g = a.gh + (live ? s_dst[i] : 0) * a.ld;
      const T* hr = a.hs + (live ? s_row[i] : 0) * a.ld;
      pq[q] = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = c0 + 32 * c;
        if (live && ch < a.nc) {
          RowVec<T>::load(g + ch * VEC, y[q][c]);
          if constexpr (!GIVEN) {
            float x[VEC];
            RowVec<T>::load(hr + ch * VEC, x);
#pragma unroll
            for (int k = 0; k < VEC; ++k) pq[q] += x[k] * y[q][c][k];
          }
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) y[q][c][k] = 0.f;
        }
      }
    }
    if constexpr (GIVEN) {
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) pq[q] = e + q < e_end ? s_p[e + q - b.e0] : 0.f;
    } else {
      for (int o = a.span >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) pq[q] += __shfl_xor_sync(gmask, pq[q], o);
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
        dsum += ((s_m[i] * pq[q] - s_go[i]) / s_den[i]) * s_deriv[i];
        const float al = s_alpha[i];
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[c][k] += al * y[q][c][k];
      }
    }
  }
  while (p < p_end) flush();  // the last piece, then trailing empty ones
}

// dh of each split row from its scratch slots, summed in piece order, plus
// (sum de) * a_src; one thread per (split row, 4 columns)
__global__ void bwd_src_combine(const float4* __restrict__ scratch,
                                const float* __restrict__ scratch_de,
                                const int* __restrict__ split_rows,
                                const int* __restrict__ split_ptr,
                                const float* __restrict__ a_src, float* __restrict__ dh,
                                int n_split, int w4, long long ld_out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= static_cast<long long>(n_split) * w4) return;
  const int r = static_cast<int>(i / w4);
  const int c = static_cast<int>(i - static_cast<long long>(r) * w4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float ds = 0.f;
  for (int s = split_ptr[r]; s < split_ptr[r + 1]; ++s) {
    const float4 v = scratch[static_cast<long long>(s) * w4 + c];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    ds += scratch_de[s];
  }
  const float4 as = reinterpret_cast<const float4*>(a_src)[c];
  *reinterpret_cast<float4*>(dh + split_rows[r] * ld_out + 4 * c) =
      make_float4(acc.x + ds * as.x, acc.y + ds * as.y, acc.z + ds * as.z, acc.w + ds * as.w);
}

template <typename T, bool GIVEN>
cudaError_t launch_walk(const WalkArgs<T>& a, size_t smem, cudaStream_t st) {
  const dim3 block(32 * WALK_UNITS / a.groups);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((a.nc + 31) / 32) {
#define PPT_CASE(C)                                                  \
  case C:                                                            \
    if constexpr (C * RowVec<T>::kElems <= 16) { /* strips <= 512 */ \
      err = allow_smem(bwd_src_units<T, C, GIVEN>, smem);            \
      if (err != cudaSuccess) return err;                            \
      bwd_src_units<T, C, GIVEN><<<grid, block, smem, st>>>(a);      \
      err = cudaGetLastError();                                      \
    }                                                                \
    break;
    PPT_CASE(1) PPT_CASE(2) PPT_CASE(3) PPT_CASE(4)
#undef PPT_CASE
    default:
      break;
  }
  return err;
}

// lanes of a group for a row of nc chunks: a power of two, at most 32
int span_of(int nc) {
  int s = 1;
  while (s < nc && s < 32) s <<= 1;
  return s;
}

template <typename T>
cudaError_t backward(WalkArgs<T> a, const int* t_ptr, const int* split_rows,
                     const int* split_ptr, int n, int d, int n_split, float* ghs,
                     cudaStream_t st) {
  constexpr int VEC = RowVec<T>::kElems;
  const size_t smem = static_cast<size_t>(a.stride) * 4 * (d > STRIP ? 8 : 7);
  cudaError_t err = cudaSuccess;
  if (d > STRIP) {
    const dim3 block(32 * WARPS_PER_BLOCK);
    const dim3 grid((n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
    row_dots<T, T><<<grid, block, 0, st>>>(a.hs, a.gh, nullptr, t_ptr, a.t_dst, ghs, nullptr, n, d,
                                           a.ld, a.ld);
    err = cudaGetLastError();
    a.ghs = ghs;
  }
  const T* hs = a.hs;
  const T* gh = a.gh;
  const float* a_src = a.a_src;
  float* dh = a.dh;
  for (int c0 = 0; c0 < d && err == cudaSuccess; c0 += STRIP) {
    const int w = d - c0 < STRIP ? d - c0 : STRIP;
    a.hs = hs + c0;
    a.gh = gh + c0;
    a.a_src = a_src + c0;
    a.dh = dh + c0;
    a.nc = w / VEC;
    a.span = span_of(a.nc);
    a.groups = 32 / a.span;
    err = d > STRIP ? launch_walk<T, true>(a, smem, st) : launch_walk<T, false>(a, smem, st);
    if (err == cudaSuccess && n_split > 0) {
      const long long threads = static_cast<long long>(n_split) * (w / 4);
      bwd_src_combine<<<static_cast<unsigned>((threads + 255) / 256), 256, 0, st>>>(
          reinterpret_cast<const float4*>(a.scratch), a.scratch_de, split_rows, split_ptr,
          a.a_src, a.dh, n_split, w / 4, a.ld_out);
      err = cudaGetLastError();
    }
  }
  return err;
}

}  // namespace

// hs / gh [n, ld] rows and cotangent rows at the row type (bf16 if bf16, else
// f32), 16-byte aligned, ld a multiple of 16 bytes (ld = d for contiguous
// rows; heads * d for one head's rows of an [n, heads, d] tensor); a_src
// [d], gs/gd/den/godot [n] f32; the plan of t_ptr (piece_ptr, piece_out,
// unit_ptr, as spmm_csr.cu takes it); t_ptr [n + 1], t_dst [E], t_eid [E]
// int32 (transpose CSR) and erow [E] int32 (each entry's source); mask [E]
// f32 over canonical ids or null. Writes dh [n, d] f32. scratch [slots,
// min(d, 512)] and scratch_de [slots] f32; split_rows [n_split], split_ptr
// [n_split + 1] int32. stride: an odd number of entries >= the most entries
// a block's WALK_UNITS units hold. d must be a positive multiple of 32;
// above 512, ghs is an [E] f32 scratch buffer (per-entry gh_d . hs_s), else
// unused.
PPT_EXPORT int ppt_gat_bwd_src(const void* hs, const void* gh, int bf16, const float* a_src,
                               const float* gs, const float* gd, const float* den,
                               const float* godot, const int* piece_ptr, const int* piece_out,
                               const int* unit_ptr, const int* t_ptr, const int* t_dst,
                               const int* t_eid, const int* erow, const float* mask, float* dh,
                               float* scratch, float* scratch_de, const int* split_rows,
                               const int* split_ptr, int n, int d, int ld, int n_units,
                               int n_split, int stride, float* ghs, void* stream) {
  if (d <= 0 || d % 32 != 0 || ld < d || ld % (bf16 ? 8 : 4) != 0 || stride % 2 == 0 ||
      (d > STRIP && ghs == nullptr) ||
      (n_split > 0 && (piece_out == nullptr || scratch == nullptr || scratch_de == nullptr))) {
    return cudaErrorInvalidValue;
  }
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const WalkArgs<__nv_bfloat16> a{
        static_cast<const __nv_bfloat16*>(hs), static_cast<const __nv_bfloat16*>(gh), a_src, gs,
        gd, den, godot, piece_ptr, piece_out, unit_ptr, t_dst, t_eid, erow, mask, nullptr, dh,
        scratch, scratch_de, ld, d, n_units, 0, 0, 0, stride};
    return backward(a, t_ptr, split_rows, split_ptr, n, d, n_split, ghs, st);
  }
  const WalkArgs<float> a{static_cast<const float*>(hs), static_cast<const float*>(gh), a_src,
                          gs, gd, den, godot, piece_ptr, piece_out, unit_ptr, t_dst, t_eid, erow,
                          mask, nullptr, dh, scratch, scratch_de, ld, d, n_units, 0, 0, 0, stride};
  return backward(a, t_ptr, split_rows, split_ptr, n, d, n_split, ghs, st);
}
