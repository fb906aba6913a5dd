// HGT edge attention backward, source order (B2).
//
// Port-only. For each stacked source row s and each of its edges s -> t
// (canonical id e), from B1's per-edge (c | alpha) per head
// (hgt_bwd_dst.cu) and the f32 rows q and g of the target:
//   dK'_s = sum_e c_e q_t,   dV'_s = sum_e alpha_e g_t
// per head, in the walk's order, written as one row [dK' | dV'] of 2 H D
// f32 values a stacked row. The row type of the forward plays no part: q
// and g are f32.
//
// What bounds it: bytes. Each edge gathers the target's q and g rows (2 H
// D f32 values, chosen by the graph) and its 2 H scalars by canonical id;
// the compulsory traffic writes dkv once.
//
// Design: the edge-balanced walk of walk.cuh over the plan of the transpose
// CSR (t_ptr / t_dst / t_eid), one warp a unit. A block takes WALK_UNITS
// units and stages its entries' t_dst and t_eid with cp.async. Each lane
// holds chunks c0, c0 + 32, ... of a W-wide f32 row (hgt.cuh) of both
// halves and walks its unit's entries as one flat run, several rows in
// flight, reading its heads' (c, alpha): no sum crosses lanes. At each
// piece's end the warp writes the row whole, else its sum to a scratch
// slot; a combine kernel sums a split row's slots in piece order. No
// atomics: the same bits on every run.
#include "hgt.cuh"

namespace {

struct SrcArgs {
  const float* q;        // [n, W], W = H * D
  const float* g;        // [n, W]
  const float* edge;     // [E, 2H]: (c | alpha)
  const int* piece_ptr;  // the plan of t_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* t_dst;  // [E]
  const int* t_eid;  // [E]
  float* dkv;        // [S, 2W]
  float* scratch;    // [slots, 2W]
  int n_units, heads, d;
  RowLayout l;  // of a W-wide f32 row
  int stride;   // entries between the shared arrays (odd)
};

// CK: 16-byte chunks a lane holds of each half
template <int CK>
__global__ void __launch_bounds__(32 * WALK_UNITS, 2) hgt_bwd_src_walk(SrcArgs a) {
  constexpr int VEC = 4;
  constexpr int ILP = CK <= 2 ? 4 : 2;  // entries' rows in flight
  extern __shared__ int smem[];
  const int H = a.heads, st = a.stride;
  const long long W = static_cast<long long>(H) * a.d;
  int* s_dst = smem;
  int* s_eid = smem + st;

  const BlockUnits b = block_units(a.piece_ptr, a.unit_ptr, a.n_units);
  stage_ints(s_dst, a.t_dst + b.e0, b.cnt);
  stage_ints(s_eid, a.t_eid + b.e0, b.cnt);
  cp_async_wait_all();
  __syncthreads();

  const Lane<CK, VEC> ln(a.l, a.d);
  const int u = b.u0 + ln.gid;
  if (u >= b.u1) return;
  int p = a.unit_ptr[u];
  const int p_end = a.unit_ptr[u + 1];
  int pe = a.piece_ptr[p + 1];
  const int e_end = a.piece_ptr[p_end];

  float ak[CK][VEC], av[CK][VEC];
#pragma unroll
  for (int c = 0; c < CK; ++c)
#pragma unroll
    for (int k = 0; k < VEC; ++k) ak[c][k] = av[c][k] = 0.f;

  // write piece p's sums and start the next piece
  auto flush = [&]() {
    const int o = piece_dest(a.piece_out, p);
    float* row = o >= 0 ? a.dkv + o * 2 * W : a.scratch + (-1LL - o) * 2 * W;
#pragma unroll
    for (int c = 0; c < CK; ++c) {
      const int col = (ln.c0 + 32 * c) * VEC;
      store_f32(row + col, ak[c]);
      store_f32(row + W + col, av[c]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) ak[c][k] = av[c][k] = 0.f;
    }
    ++p;
  };

  for (int e = a.piece_ptr[p]; e < e_end; e += ILP) {
    float yq[ILP][CK][VEC], yg[ILP][CK][VEC], cc[ILP][CK], al[ILP][CK];
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      const bool in = e + q < e_end;
      const int i = e + q - b.e0;
      const long long t = in ? s_dst[i] : 0;
      const long long eid = in ? s_eid[i] : 0;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = (ln.c0 + 32 * c) * VEC;
        if (in) {
          load_f32(a.q + t * W + col, yq[q][c]);
          load_f32(a.g + t * W + col, yg[q][c]);
          cc[q][c] = __ldg(a.edge + eid * 2 * H + ln.head[c]);
          al[q][c] = __ldg(a.edge + eid * 2 * H + H + ln.head[c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) yq[q][c][k] = yg[q][c][k] = 0.f;
          cc[q][c] = al[q][c] = 0.f;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < ILP; ++q) {
      if (e + q < e_end) {
        while (e + q == pe) {  // the piece (and any empty ones after it) ended
          flush();
          pe = a.piece_ptr[p + 1];
        }
#pragma unroll
        for (int c = 0; c < CK; ++c)
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            ak[c][k] = fmaf(cc[q][c], yq[q][c][k], ak[c][k]);
            av[c][k] = fmaf(al[q][c], yg[q][c][k], av[c][k]);
          }
      }
    }
  }
  while (p < p_end) flush();  // the last piece, then trailing empty ones
}

cudaError_t backward(const SrcArgs& a, const int* split_rows, const int* split_ptr, int n_split,
                     cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.stride) * 4 * 2;
  const dim3 block(32 * WALK_UNITS);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = cudaSuccess;
  if (a.n_units > 0) {
    switch (a.l.nc / 32) {
#define HGT_CASE(CK)                                      \
  case CK:                                                \
    err = allow_smem(hgt_bwd_src_walk<CK>, smem);         \
    if (err != cudaSuccess) return err;                   \
    hgt_bwd_src_walk<CK><<<grid, block, smem, st>>>(a);   \
    err = cudaGetLastError();                             \
    break;
      HGT_CASE(2) HGT_CASE(4)
#undef HGT_CASE
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (err != cudaSuccess) return err;
  return launch_sum_slots(a.scratch, split_rows, split_ptr, nullptr, a.dkv, n_split,
                          2 * a.heads * a.d, st);
}

}  // namespace

// q, g [n, heads, d] f32 rows (16-byte aligned); edge [E, 2 heads] f32 as
// ppt_hgt_bwd_dst writes it; the plan of t_ptr (piece_ptr, piece_out,
// unit_ptr) over the n_rows stacked rows; t_dst [E] and t_eid [E] int32 (the
// transpose CSR). Writes dkv [n_rows, 2, heads, d] f32. scratch [slots, 2
// heads d] f32; split_rows, split_ptr int32. stride and the shapes as
// ppt_hgt_fwd.
PPT_EXPORT int ppt_hgt_bwd_src(const float* q, const float* g, const float* edge, const int* piece_ptr,
                               const int* piece_out, const int* unit_ptr, const int* t_dst,
                               const int* t_eid, float* dkv, float* scratch, const int* split_rows,
                               const int* split_ptr, int n_rows, int heads, int d, int n_units,
                               int n_split, int stride, void* stream) {
  if (!hgt_shape_ok(heads, d, stride) || (n_split > 0 && (piece_out == nullptr || scratch == nullptr)))
    return cudaErrorInvalidValue;
  if (n_rows == 0) return cudaSuccess;
  const SrcArgs f{q, g, edge, piece_ptr, piece_out, unit_ptr, t_dst, t_eid, dkv, scratch, n_units, heads, d,
                  row_layout(heads, d, 4), stride};
  return backward(f, split_rows, split_ptr, n_split, static_cast<cudaStream_t>(stream));
}
