// GATv2 attention backward, destination order (B1), at 1 to 8 heads.
//
// Port-only. For each destination d with cotangent rows g_d,k, each in-edge
// s -> d (canonical id e) and each head k, with z, score, num and m as in
// gatv2_fwd.cu:
//   dnum  = (m * g_d . rl_s - g_d . out_d) / (den_d + 1e-9)
//   ds_e  = dnum * num * 1[-10 < score < 10]
//   al_e  = m * num / (den_d + 1e-9)
// and it emits dxr_d = a_k * sum_e ds_e lrelu'(z) (lrelu' = 1 where z > 0,
// else 0.2), one partial row a block of da [H, D] = sum_e ds_e lrelu(z)
// (the caller sums the rows), each edge's (al, ds) per head [E, H, 2] and
// the signs of its z: byte j of edge e holds 1[z > 0] of the row's values
// j * VEC .. j * VEC + VEC - 1 in bits 0 .. VEC - 1 ([E, H * D / VEC]
// bytes), which B2 (gatv2_bwd_src.cu) reads in place of the z it cannot form
// without gathering xr. rl is bf16 or f32; xr, g, out, den and a are f32;
// every sum is f32.
//
// What bounds it: bytes. Each edge gathers one source row of H * D values
// chosen by the graph and writes its scalars and signs (8 H + H * D / VEC
// bytes); the compulsory traffic reads xr, g and out once.
//
// Design: the forward's walk (gatv2_fwd.cu) with the backward's sums. At a
// piece's start the group loads the destination's g, out and xr rows and
// den, and forms g . out per head, so every piece of a split row forms the
// same bits; it prefetches the next row's into the L2. Then it gathers the
// entries' source rows, forms each lane's parts of each logit (the
// forward's instructions: the same bits) and of g . rl, and sums each
// head's parts with a butterfly. Each lane keeps ds * lrelu(z) in registers
// across its unit; at the end the block sums its groups' rows in group
// order through shared memory and writes one partial row. At a piece's end
// the group writes dxr for a whole row, else its sum to a scratch slot; a
// combine kernel sums a split row's slots in piece order and multiplies by
// a. No atomics, a fixed order: the same bits on every run.
#include "gatv2.cuh"

namespace {

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// VEC floats at p with the streaming hint: read once, they should not push
// gathered rows out of the L2
template <int VEC>
__device__ __forceinline__ void load_f32_once(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p + k));
    v[k] = t.x;
    v[k + 1] = t.y;
    v[k + 2] = t.z;
    v[k + 3] = t.w;
  }
}

template <typename T>
struct BwdArgs {
  const T* rl;           // [n, W] rows at the row type, W = H * D
  const float* xr;       // [n, W]
  const float* a;        // [W]
  const float* g;        // [n, W]
  const float* out;      // [n, W]
  const float* den;      // [n, H]
  const int* piece_ptr;  // the plan of row_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* src;         // [E]
  const int* erow;        // [E] each entry's destination
  float* dxr;             // [n, W]
  float* partial;         // [blocks, W]
  float2* edge;           // [E, H]: (al, ds)
  unsigned char* signs;   // [E, nc]
  float* scratch;         // [slots, W]
  int n, n_units, heads, d;
  RowLayout l;
  int stride;  // entries between the shared arrays (odd)
  Drop drop;
};

// C: 16-byte chunks a lane holds of one row
template <typename T, int C>
__global__ void __launch_bounds__(32 * WALK_UNITS, C * RowVec<T>::kElems >= 16 ? 1 : 2)
    gatv2_bwd_dst_walk(BwdArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  constexpr int FIT = 32 / (C * VEC);  // source row values in registers: 32 at most
  constexpr int EDGE_ILP = FIT > 4 ? 4 : (FIT < 1 ? 1 : FIT);
  extern __shared__ __align__(16) int smem[];
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
  float av[C][VEC];    // a at this lane's columns
  float pacc[C][VEC];  // sum of ds * lrelu(z) over this lane's unit
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) pacc[c][k] = 0.f;
    if (ln.live[c]) {
      load_f32(a.a + (ln.c0 + 32 * c) * VEC, av[c]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) av[c][k] = 0.f;
    }
  }

  if (u < b.u1) {  // a group past the plan's end keeps zeros for the block's sum
    int p = a.unit_ptr[u];
    const int p_end = a.unit_ptr[u + 1];
    const int e_beg = a.piece_ptr[p];
    const int e_end = a.piece_ptr[p_end];
    int pe = 0;  // the current piece's end
    float gv[C][VEC], xv[C][VEC], t[C][VEC], go[C], dn[C], rdn[C];

    // piece p's destination terms: g_d, xr_d, den_d + 1e-9, its reciprocal
    // and g_d . out_d at this lane's chunks, and the sums restarted; the
    // next row's g, out and xr prefetched
    auto begin = [&]() {
      pe = a.piece_ptr[p + 1];
      const int o = piece_dest(a.piece_out, p);
      const long long row = o >= 0 ? o : a.erow[a.piece_ptr[p]];  // split rows' pieces hold entries
      float dot[1][C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const long long col = (ln.c0 + 32 * c) * VEC;
        dot[0][c] = 0.f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) t[c][k] = 0.f;
        if (ln.live[c]) {
          float ov[VEC];
          load_f32_once<VEC>(a.g + row * W + col, gv[c]);
          load_f32_once<VEC>(a.out + row * W + col, ov);
          load_f32(a.xr + row * W + col, xv[c]);
          dn[c] = a.den[row * H + ln.head[c]] + EPS;
          rdn[c] = 1.f / dn[c];
          if (row + 1 < a.n) {
            prefetch_l2(a.g + (row + 1) * W + col);
            prefetch_l2(a.out + (row + 1) * W + col);
            prefetch_l2(a.xr + (row + 1) * W + col);
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k) dot[0][c] = fmaf(gv[c][k], ov[k], dot[0][c]);
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) gv[c][k] = xv[c][k] = 0.f;
          dn[c] = rdn[c] = 1.f;
        }
      }
      head_sums(dot, ln.head, ln.gmask, a.l.red, ln.merge);
#pragma unroll
      for (int c = 0; c < C; ++c) go[c] = dot[0][c];
    };
    // write piece p's dxr, then start the next piece
    auto next = [&]() {
      const int o = piece_dest(a.piece_out, p);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!ln.live[c]) continue;
        const int col = (ln.c0 + 32 * c) * VEC;
        if (o >= 0) {
          float v[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) v[k] = av[c][k] * t[c][k];
          store_f32(a.dxr + o * W + col, v);
        } else {
          store_f32(a.scratch + (-1LL - o) * W + col, t[c]);
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
        float s[2 * EDGE_ILP][C];  // the logits' parts, then g . rl's
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            s[q][c] = s[EDGE_ILP + q][c] = 0.f;
            if (q >= q0 && q < q1) {
              s[q][c] = score_part(x[q][c], xv[c], av[c]);
#pragma unroll
              for (int k = 0; k < VEC; ++k) s[EDGE_ILP + q][c] = fmaf(gv[c][k], x[q][c][k], s[EDGE_ILP + q][c]);
            }
          }
        }
        head_sums(s, ln.head, ln.gmask, a.l.red, ln.merge);
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
          if (q >= q0 && q < q1) {
            const int i = e + q - b.e0;
            const long long eid = e + q;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int k = ln.head[c];
              const float sc = s[q][c];
              const float num = expf(fminf(fmaxf(sc, -LOGIT_CLAMP), LOGIT_CLAMP));
              const float m = a.drop.masked ? s_m[k * st + i] : 1.f;
              const float dnum = div_by(m * s[EDGE_ILP + q][c] - go[c], dn[c], rdn[c]);
              const float ds = sc > -LOGIT_CLAMP && sc < LOGIT_CLAMP ? dnum * num : 0.f;
              const float dsn = LEAKY_SLOPE * ds;
              unsigned bits = 0;
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const float z = x[q][c][v] + xv[c][v];
                const bool pos = z > 0.f;
                t[c][v] += pos ? ds : dsn;
                pacc[c][v] = fmaf(ds, pos ? z : LEAKY_SLOPE * z, pacc[c][v]);
                bits |= static_cast<unsigned>(pos) << v;
              }
              if (ln.live[c]) a.signs[eid * a.l.nc + ln.c0 + 32 * c] = static_cast<unsigned char>(bits);
              if (ln.first[c]) a.edge[eid * H + k] = make_float2(div_by(m * num, dn[c], rdn[c]), ds);
            }
          }
        }
        q0 = q1;
      }
    }
    while (p < p_end) next();  // the last piece, then trailing empty ones
  }

  // the block's partial row of da: its groups' rows summed in group order
  __syncthreads();  // every group's walk is done: the entry arrays are free
  float* s_acc = reinterpret_cast<float*>(smem);  // [WALK_UNITS][W]
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (ln.live[c]) store_f32(s_acc + ln.gid * W + (ln.c0 + 32 * c) * VEC, pacc[c]);
  __syncthreads();
  float* prow = a.partial + blockIdx.x * W;
  for (int col = threadIdx.x; col < W; col += blockDim.x) {
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < WALK_UNITS; ++j) sum += s_acc[j * W + col];
    prow[col] = sum;
  }
}

template <typename T>
cudaError_t backward(const BwdArgs<T>& a, const int* split_rows, const int* split_ptr, int n_split,
                     cudaStream_t st) {
  const size_t smem_entries = static_cast<size_t>(a.stride) * 4 * (1 + (a.drop.masked ? a.heads : 0));
  const size_t smem_rows = static_cast<size_t>(WALK_UNITS) * a.heads * a.d * 4;
  const size_t smem = smem_entries > smem_rows ? smem_entries : smem_rows;
  const dim3 block(32 * WALK_UNITS / a.l.groups);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = a.n_units > 0 ? cudaErrorInvalidValue : cudaSuccess;
  if (a.n_units > 0) {
    switch ((a.l.nc + 31) / 32) {
#define PPT_CASE(C)                                              \
  case C:                                                        \
    if constexpr (C * RowVec<T>::kElems <= 32) {                 \
      err = allow_smem(gatv2_bwd_dst_walk<T, C>, smem);          \
      if (err != cudaSuccess) return err;                        \
      gatv2_bwd_dst_walk<T, C><<<grid, block, smem, st>>>(a);    \
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
  return launch_sum_slots(a.scratch, split_rows, split_ptr, a.a, a.dxr, n_split, a.heads * a.d, st);
}

}  // namespace

// rl [n, heads, d] rows at the row type (bf16 if bf16, else f32); xr, g,
// out [n, heads, d] f32; all 16-byte aligned; a [heads, d] and den [n,
// heads] f32; the plan of row_ptr (piece_ptr, piece_out, unit_ptr); src
// [E] and erow [E] int32. Writes dxr [n, heads, d] f32, partial [blocks,
// heads * d] f32 (blocks = ceil(n_units / WALK_UNITS)), edge [E, heads, 2]
// f32 (al, ds) and signs [E, heads * d / VEC] bytes (VEC 8 for bf16 rows, 4
// for f32). scratch [slots, heads * d] f32; split_rows, split_ptr int32.
// stride: an odd number of entries >= the most entries a block's
// WALK_UNITS units hold. Shapes and dropout as ppt_gatv2_fwd.
PPT_EXPORT int ppt_gatv2_bwd_dst(const void* rl, int bf16, const float* xr, const float* a,
                                 const float* g, const float* out, const float* den,
                                 const int* piece_ptr, const int* piece_out, const int* unit_ptr,
                                 const int* src, const int* erow, float* dxr, float* partial,
                                 float* edge, unsigned char* signs, float* scratch,
                                 const int* split_rows, const int* split_ptr, int n, int heads, int d,
                                 int n_units, int n_split, int stride, int masked, unsigned seed,
                                 unsigned thresh, float scale, long long id_offset, void* stream) {
  if (!gatv2_shape_ok(heads, d, stride) ||
      (n_split > 0 && (piece_out == nullptr || scratch == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const Drop drop{masked, seed, thresh, scale, id_offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* e2 = reinterpret_cast<float2*>(edge);
  if (bf16) {
    const BwdArgs<__nv_bfloat16> f{static_cast<const __nv_bfloat16*>(rl), xr, a, g, out, den,
                                   piece_ptr, piece_out, unit_ptr, src, erow, dxr, partial, e2,
                                   signs, scratch, n, n_units, heads, d, row_layout(heads, d, 8),
                                   stride, drop};
    return backward(f, split_rows, split_ptr, n_split, st);
  }
  const BwdArgs<float> f{static_cast<const float*>(rl), xr, a, g, out, den, piece_ptr, piece_out,
                         unit_ptr, src, erow, dxr, partial, e2, signs, scratch, n, n_units, heads,
                         d, row_layout(heads, d, 4), stride, drop};
  return backward(f, split_rows, split_ptr, n_split, st);
}
