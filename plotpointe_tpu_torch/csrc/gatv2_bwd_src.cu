// GATv2 attention backward, source order (B2), at 1 to 8 heads.
//
// Port-only. For each source s and each out-edge s -> d (canonical id e),
// from B1's per-edge (al_e, ds_e) per head and signs of z (gatv2_bwd_dst.cu)
// and the f32 cotangent rows g:
//   dxl_s = sum_e al_e * g_d + ds_e * lrelu'(z_e) * a
// (lrelu' = 1 where z > 0, else 0.2), per head, in the walk's order. The
// row type (bf16 or f32 rows in the forward) sets only the chunks: VEC
// values a chunk, as B1 packed the signs.
//
// What bounds it: bytes. Each edge gathers one f32 cotangent row of H * D
// values chosen by the graph plus its scalars (8 H bytes) and signs (H * D /
// VEC bytes) by canonical id; the compulsory traffic writes dxl once.
// Without the signs it would gather xr_d too, as many bytes again.
//
// Design: the edge-balanced walk of walk.cuh over the plan of the transpose
// CSR (t_ptr / t_dst / t_eid). A block takes WALK_UNITS units and stages
// its entries' t_dst and t_eid with cp.async. Each lane group (gatv2.cuh's
// layout) walks its unit's entries as one flat run, several rows in flight,
// each lane reading its chunk's signs byte and its head's (al, ds): no sum
// crosses lanes. At each piece's end the group writes dxl for a whole row,
// else its sum to a scratch slot; a combine kernel sums a split row's slots
// in piece order. No atomics: the same bits on every run.
#include "gatv2.cuh"

namespace {

template <typename T>
struct SrcArgs {
  const float* g;               // [n, W] cotangent rows, W = H * D
  const float* a;               // [W]
  const float2* edge;           // [E, H]: (al, ds)
  const unsigned char* signs;   // [E, nc]
  const int* piece_ptr;         // the plan of t_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* t_dst;  // [E]
  const int* t_eid;  // [E]
  float* dxl;        // [n, W]
  float* scratch;    // [slots, W]
  int n_units, heads, d;
  RowLayout l;
  int stride;  // entries between the shared arrays (odd)
};

// C: 16-byte chunks a lane holds of one row
template <typename T, int C>
__global__ void __launch_bounds__(32 * WALK_UNITS, C * RowVec<T>::kElems >= 32 ? 1 : 2)
    gatv2_bwd_src_walk(SrcArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  constexpr int FIT = 32 / (C * VEC);  // cotangent values in registers: 32 at most
  constexpr int EDGE_ILP = FIT > 8 ? 8 : (FIT < 1 ? 1 : FIT);
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
  int pe = a.piece_ptr[p + 1];
  const int e_end = a.piece_ptr[p_end];

  float acc[C][VEC];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;

  // write piece p's sums and start the next piece
  auto flush = [&]() {
    const int o = piece_dest(a.piece_out, p);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (ln.live[c]) {
        const int col = (ln.c0 + 32 * c) * VEC;
        store_f32(o >= 0 ? a.dxl + o * W + col : a.scratch + (-1LL - o) * W + col, acc[c]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[c][k] = 0.f;
    }
    ++p;
  };

  for (int e = a.piece_ptr[p]; e < e_end; e += EDGE_ILP) {
    float y[EDGE_ILP][C][VEC];
    float2 es[EDGE_ILP][C];
    unsigned sb[EDGE_ILP][C];
#pragma unroll
    for (int q = 0; q < EDGE_ILP; ++q) {
      const bool in = e + q < e_end;
      const int i = e + q - b.e0;
      const float* g = a.g + static_cast<long long>(in ? s_dst[i] : 0) * W;
      const long long eid = in ? s_eid[i] : 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = ln.c0 + 32 * c;
        if (in && ln.live[c]) {
          load_f32(g + ch * VEC, y[q][c]);
          sb[q][c] = __ldg(a.signs + eid * a.l.nc + ch);
          es[q][c] = __ldg(a.edge + eid * H + ln.head[c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) y[q][c][k] = 0.f;
          sb[q][c] = 0;
          es[q][c] = make_float2(0.f, 0.f);
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
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float al = es[q][c].x, ds = es[q][c].y, dsn = LEAKY_SLOPE * es[q][c].y;
#pragma unroll
          for (int k = 0; k < VEC; ++k)
            acc[c][k] = fmaf(al, y[q][c][k], fmaf((sb[q][c] >> k) & 1u ? ds : dsn, av[c][k], acc[c][k]));
        }
      }
    }
  }
  while (p < p_end) flush();  // the last piece, then trailing empty ones
}

template <typename T>
cudaError_t backward(const SrcArgs<T>& a, const int* split_rows, const int* split_ptr, int n_split,
                     cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.stride) * 4 * 2;
  const dim3 block(32 * WALK_UNITS / a.l.groups);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = a.n_units > 0 ? cudaErrorInvalidValue : cudaSuccess;
  if (a.n_units > 0) {
    switch ((a.l.nc + 31) / 32) {
#define PPT_CASE(C)                                              \
  case C:                                                        \
    if constexpr (C * RowVec<T>::kElems <= 32) {                 \
      err = allow_smem(gatv2_bwd_src_walk<T, C>, smem);          \
      if (err != cudaSuccess) return err;                        \
      gatv2_bwd_src_walk<T, C><<<grid, block, smem, st>>>(a);    \
      err = cudaGetLastError();                                  \
    }                                                            \
    break;
      PPT_CASE(1) PPT_CASE(2) PPT_CASE(3) PPT_CASE(4) PPT_CASE(5) PPT_CASE(6) PPT_CASE(7)
      PPT_CASE(8)
#undef PPT_CASE
      default:
        break;
    }
  }
  if (err != cudaSuccess) return err;
  return launch_sum_slots(a.scratch, split_rows, split_ptr, nullptr, a.dxl, n_split, a.heads * a.d, st);
}

}  // namespace

// g [n, heads, d] f32 cotangent rows, 16-byte aligned; bf16: the forward's
// rows were bf16 (chunks of 8 values), else f32 (4); a [heads, d] f32
// (16-byte aligned); edge [E, heads, 2]
// f32 and signs [E, heads * d / VEC] bytes as ppt_gatv2_bwd_dst writes
// them; the plan of t_ptr (piece_ptr, piece_out, unit_ptr); t_dst [E] and
// t_eid [E] int32 (the transpose CSR). Writes dxl [n, heads, d] f32.
// scratch [slots, heads * d] f32; split_rows, split_ptr int32. stride: an
// odd number of entries >= the most entries a block's WALK_UNITS units
// hold. Shapes as ppt_gatv2_fwd.
PPT_EXPORT int ppt_gatv2_bwd_src(const float* g, int bf16, const float* a, const float* edge,
                                 const unsigned char* signs, const int* piece_ptr,
                                 const int* piece_out, const int* unit_ptr, const int* t_dst,
                                 const int* t_eid, float* dxl, float* scratch,
                                 const int* split_rows, const int* split_ptr, int n, int heads, int d,
                                 int n_units, int n_split, int stride, void* stream) {
  if (!gatv2_shape_ok(heads, d, stride) ||
      (n_split > 0 && (piece_out == nullptr || scratch == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float2* e2 = reinterpret_cast<const float2*>(edge);
  if (bf16) {
    const SrcArgs<__nv_bfloat16> f{g, a, e2, signs, piece_ptr,
                                   piece_out, unit_ptr, t_dst, t_eid, dxl, scratch, n_units, heads, d,
                                   row_layout(heads, d, 8), stride};
    return backward(f, split_rows, split_ptr, n_split, st);
  }
  const SrcArgs<float> f{g, a, e2, signs, piece_ptr, piece_out, unit_ptr,
                         t_dst, t_eid, dxl, scratch, n_units, heads, d, row_layout(heads, d, 4),
                         stride};
  return backward(f, split_rows, split_ptr, n_split, st);
}
