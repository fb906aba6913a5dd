// GAT attention backward, destination order, at 1 to 8 heads: B1 (kernel 2)
// and its head-packed form (kernel 9).
//
// Replaces plotpointe_tpu/ops/gat_fused.py::_bwd_kernel (kernel 2, one head,
// launched by _bwd_call) and ::_bwd_kernel_mh (kernel 9, 2-8 heads packed in
// one row, launched by _bwd_call_mh). The rows are [n, H, D]; for each
// destination d with cotangent rows g_d,k, each in-edge s -> d (canonical id
// e) and each head k (mask row k):
//   x     = gs_s,k + gd_d,k             (gs = round(h) . a_src, gd = h . a_dst)
//   lx    = lrelu(x, 0.2);  num = exp(clamp(lx, -10, 10))
//   deriv = num * 1[-10 < lx < 10] * (x > 0 ? 1 : 0.2)
//   ghs   = g_d,k . hs_s,k              (hs: rows rounded to the row type)
//   de_e  = ((mask_k,e * ghs - godot_d,k) / (den_d,k + 1e-9)) * deriv
// and it emits de_sum[d, k] = sum_e de_e, godot[d, k] = g_d,k . out_d,k and
// one partial row a block of d a_src [H, D] = sum_e de_e * hs_s,k (the caller
// sums the rows). g, out, den, gs and gd are f32; the rows are bf16 or f32;
// every sum is f32.
//
// What bounds it: bytes. Each edge gathers one source row of H * D values
// chosen by the graph (2 bytes a value in bf16 rows, 4 in f32), on top of
// the compulsory reads of g and out (f32) and the index arrays; the
// arithmetic is 4 FLOP per gathered element.
//
// Design: the edge-balanced walk of walk.cuh over the plan of row_ptr, the
// forward's walk (gat_fwd.cu) with the dot products of the backward. A block
// takes WALK_UNITS units: it stages its entries' src and destination rows
// with cp.async, then computes each entry's H derivatives (and mask values)
// once, block-wide, into shared memory. Each lane group, as wide as a row's
// 16-byte chunks rounded up to a power of two (at most a warp), walks its
// unit. At each piece's start it loads the destination's g_d (f32, 16-byte
// loads) and den_d, and forms godot_d from g_d and out_d, so every piece of
// a split row forms it with the same bits. Then it reads the entries' source
// rows in 16-byte chunks, several in flight, and takes each entry's ghs per
// head as a butterfly over that head's lanes of the group: every lane of a
// head gets the same bits, so every lane of it sums the same de. A batch of
// rows in flight that crosses a piece's end is taken in two runs, the second
// after the next piece's destination terms are loaded. At a piece's end the
// group writes de_sum and godot for a whole row, else to a scratch slot; a
// combine kernel sums a split row's slots in piece order. Each lane keeps
// de_e * hs_s in registers across its whole unit; at the end the block sums
// its groups' rows in group order through shared memory and writes one
// partial row. No atomics, a fixed order: the same bits on every run.
// At a piece's start the group waits on g_d and out_d with no gather in
// flight, so it prefetches the next row's into the L2 (the next piece's,
// unless a split row goes on), and reads both with the streaming hint (read
// once: they should not push gathered rows out of the L2). The divide by
// den_d + 1e-9 is a reciprocal taken once a piece and, for each de, x * r
// corrected by one FMA: the division's bits outside the underflow range,
// without its cost for every entry. On the H100 each of the three made the
// kernel faster (PERF.md section 6).
// A single head wider than STRIP (512): ghs spans the full row, so
// `row_dots` first writes ghs per edge and godot per row over the full rows;
// then the walk runs once per column strip of <= 512, staging ghs and
// reading godot instead of forming them, and writes its columns of the
// partial rows (the first strip writes de_sum). Any multiple of 32.
#include "attention.cuh"
#include "walk.cuh"

namespace {

// VEC floats of an f32 row at p (16-byte aligned) with the streaming hint:
// the row is read once, so it should not push gathered rows out of the L2
template <int VEC>
__device__ __forceinline__ void load_f32_once(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; k += 4) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p + k));
    v[k] = a.x;
    v[k + 1] = a.y;
    v[k + 2] = a.z;
    v[k + 3] = a.w;
  }
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

template <typename T>
struct WalkArgs {
  const T* hs;             // rows at the row type, ld apart, 16-byte aligned (a strip's columns)
  const float* g;          // cotangent rows, ld apart (a strip's columns)
  const float* out;        // forward output rows, ld apart (a strip's columns)
  const float* gs;         // [n, H]
  const float* gd;         // [n, H]
  const float* den;        // [n, H]
  const int* piece_ptr;    // the plan of row_ptr
  const int* piece_out;
  const int* unit_ptr;
  const int* src;          // [E]
  const int* erow;         // [E] each entry's row (its destination)
  const float* mask;       // [H, E] or null
  const float* ghs;        // GIVEN: [E] g_d . hs_s over the full rows
  const float* godot_in;   // GIVEN: [n] g_d . out_d over the full rows
  float* de_sum;           // [n, H], or null (a strip after the first)
  float* godot;            // [n, H], or null (GIVEN: row_dots wrote it)
  float* partial;          // [blocks, ld] (a strip's columns)
  float* scratch;          // [slots, 2, H]: a split row's piece sums of de, then its godot
  int n, n_units, n_edges, heads, d;  // d: a head's columns in this pass
  long long ld;  // elements between rows of hs, g, out and partial
  int nc;        // 16-byte chunks of a (strip of a) row: W = nc * VEC
  int span;      // lanes of a group: a power of two >= min(nc, 32)
  int groups;    // lane groups a warp: 32 / span
  int red;       // lanes one head's chunks take in a register slot: a power of two <= span
  int stride;    // entries between the shared arrays (odd)
};

// v[q][c] holds this lane's part of head[c]'s sum for entry q; afterwards
// the head's whole sum, the same bits in every lane of the head: a butterfly
// over the `red` lanes that hold the head's chunks of slot c, then, where one
// head takes several slots of every lane (`merge`), the slots of a head
// added in slot order.
template <int Q, int C>
__device__ __forceinline__ void head_sums(float (&v)[Q][C], const int (&head)[C], unsigned gmask,
                                          int red, bool merge) {
  for (int o = red >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int c = 0; c < C; ++c) v[q][c] += __shfl_xor_sync(gmask, v[q][c], o);
  }
  if (C > 1 && merge) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float t[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        t[c] = 0.f;
#pragma unroll
        for (int c2 = 0; c2 < C; ++c2)
          if (head[c2] == head[c]) t[c] += v[q][c2];
      }
#pragma unroll
      for (int c = 0; c < C; ++c) v[q][c] = t[c];
    }
  }
}

// C: 16-byte chunks a lane holds of one row; GIVEN: ghs and godot are read
// (a column strip of one head), not formed
template <typename T, int C, bool GIVEN>
__global__ void __launch_bounds__(32 * WALK_UNITS, WALK_MIN_BLOCKS) bwd_dst_walk(WalkArgs<T> a) {
  constexpr int VEC = RowVec<T>::kElems;
  constexpr int FIT = 32 / (C * VEC);  // source row values in registers: 32 at most
  constexpr int EDGE_ILP = FIT > 8 ? 8 : (FIT < 1 ? 1 : FIT);
  extern __shared__ __align__(16) int smem[];
  const int H = a.heads, st = a.stride;
  int* s_src = smem;
  float* s_deriv = reinterpret_cast<float*>(smem + st);  // [H][st]
  float* s_m = s_deriv + H * st;                          // [H][st] with a mask
  float* s_p = s_m + (a.mask != nullptr ? H * st : 0);    // GIVEN: [st] ghs
  int* s_row = smem + st;  // staged rows, each overwritten by head 0's deriv

  const BlockUnits b = block_units(a.piece_ptr, a.unit_ptr, a.n_units);
  stage_ints(s_src, a.src + b.e0, b.cnt);
  stage_ints(s_row, a.erow + b.e0, b.cnt);
  if constexpr (GIVEN)
    stage_ints(reinterpret_cast<int*>(s_p), reinterpret_cast<const int*>(a.ghs + b.e0), b.cnt);
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < b.cnt; i += blockDim.x) {
    const long long s = s_src[i], r = s_row[i];
    for (int k = 0; k < H; ++k) {
      const float x = a.gs[s * H + k] + a.gd[r * H + k];
      const float lx = x > 0.f ? x : LEAKY_SLOPE * x;
      const float num = expf(fminf(fmaxf(lx, -LOGIT_CLAMP), LOGIT_CLAMP));
      const bool inside = lx > -LOGIT_CLAMP && lx < LOGIT_CLAMP;
      s_deriv[k * st + i] = inside ? num * (x > 0.f ? 1.f : LEAKY_SLOPE) : 0.f;
      if (a.mask != nullptr)
        s_m[k * st + i] = a.mask[static_cast<long long>(k) * a.n_edges + b.e0 + i];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int grp = lane / a.span;
  const int c0 = lane - grp * a.span;
  const int gid = (threadIdx.x >> 5) * a.groups + grp;  // the group's place in the block
  const int u = b.u0 + gid;
  const unsigned gmask = a.span == 32 ? FULL_MASK : ((1u << a.span) - 1u) << (grp * a.span);
  const bool merge = a.d / VEC > 32;  // a head takes several slots of every lane
  int head[C];    // the head of each of this lane's chunks
  bool live[C];   // the chunk lies in the row
  bool first[C];  // the chunk starts its head: its lane writes the head's sums
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int ch = c0 + 32 * c;
    live[c] = ch < a.nc;
    head[c] = live[c] ? ch * VEC / a.d : 0;  // a chunk past the row: zeros, under head 0
    first[c] = live[c] && ch * VEC % a.d == 0;
  }
  float pacc[C][VEC];  // sum of de_e * hs_s over this lane's unit
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < VEC; ++k) pacc[c][k] = 0.f;

  if (u < b.u1) {  // a group past the plan's end keeps zeros for the block's sum
    int p = a.unit_ptr[u];
    const int p_end = a.unit_ptr[u + 1];
    const int e_beg = a.piece_ptr[p];
    const int e_end = a.piece_ptr[p_end];
    int pe = 0;  // the current piece's end
    float gv[C][VEC], go[C], dn[C], rdn[C], dsum[C];

    // piece p's destination terms: g_d, den_d + 1e-9, its reciprocal and
    // godot_d at this lane's chunks, and de_sum restarted; the next row's g
    // and out prefetched
    auto begin = [&]() {
      pe = a.piece_ptr[p + 1];
      const int o = piece_dest(a.piece_out, p);
      const long long row = o >= 0 ? o : a.erow[a.piece_ptr[p]];  // split rows' pieces hold entries
      float t[1][C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int ch = c0 + 32 * c;
        dsum[c] = 0.f;
        t[0][c] = 0.f;
        if (live[c]) {
          load_f32_once<VEC>(a.g + row * a.ld + ch * VEC, gv[c]);
          dn[c] = a.den[row * H + head[c]] + EPS;
          rdn[c] = 1.f / dn[c];
          if (row + 1 < a.n) {
            prefetch_l2(a.g + (row + 1) * a.ld + ch * VEC);
            prefetch_l2(a.out + (row + 1) * a.ld + ch * VEC);
          }
          if constexpr (!GIVEN) {
            float ov[VEC];
            load_f32_once<VEC>(a.out + row * a.ld + ch * VEC, ov);
#pragma unroll
            for (int k = 0; k < VEC; ++k) t[0][c] += gv[c][k] * ov[k];
          }
        } else {
#pragma unroll
          for (int k = 0; k < VEC; ++k) gv[c][k] = 0.f;
          dn[c] = 1.f;
          rdn[c] = 1.f;
        }
      }
      if constexpr (GIVEN) {
        const float go_row = a.godot_in[row];
#pragma unroll
        for (int c = 0; c < C; ++c) go[c] = go_row;
      } else {
        head_sums(t, head, gmask, a.red, merge);
#pragma unroll
        for (int c = 0; c < C; ++c) go[c] = t[0][c];
      }
    };
    // write piece p's sums, then start the next piece
    auto next = [&]() {
      const int o = piece_dest(a.piece_out, p);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        if (!first[c]) continue;
        if (o >= 0) {
          if (a.de_sum != nullptr) a.de_sum[static_cast<long long>(o) * H + head[c]] = dsum[c];
          if (a.godot != nullptr) a.godot[static_cast<long long>(o) * H + head[c]] = go[c];
        } else if (a.de_sum != nullptr) {
          float* slot = a.scratch + (-1LL - o) * 2 * H;
          slot[head[c]] = dsum[c];
          slot[H + head[c]] = go[c];
        }
      }
      if (++p < p_end) begin();
    };

    begin();
    for (int e = e_beg; e < e_end; e += EDGE_ILP) {
      const int nq = min(EDGE_ILP, e_end - e);
      float xv[EDGE_ILP][C][VEC];
#pragma unroll
      for (int q = 0; q < EDGE_ILP; ++q) {
        const T* r = a.hs + static_cast<long long>(q < nq ? s_src[e + q - b.e0] : 0) * a.ld;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (q < nq && live[c]) {
            RowVec<T>::load(r + (c0 + 32 * c) * VEC, xv[q][c]);
          } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) xv[q][c][k] = 0.f;
          }
        }
      }
      for (int q0 = 0; q0 < nq;) {
        while (e + q0 == pe) next();  // the piece (and any empty ones after it) ended
        const int q1 = min(nq, pe - e);  // entries q0 .. q1 - 1 of the batch lie in this piece
        float pq[EDGE_ILP][C];
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            pq[q][c] = 0.f;
            if constexpr (GIVEN) {
              if (q >= q0 && q < q1) pq[q][c] = s_p[e + q - b.e0];
            } else if (q >= q0 && q < q1) {
#pragma unroll
              for (int k = 0; k < VEC; ++k) pq[q][c] += gv[c][k] * xv[q][c][k];
            }
          }
        }
        if constexpr (!GIVEN) head_sums(pq, head, gmask, a.red, merge);
#pragma unroll
        for (int q = 0; q < EDGE_ILP; ++q) {
          if (q >= q0 && q < q1) {
            const int i = e + q - b.e0;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const int k = head[c];
              const float m = a.mask != nullptr ? s_m[k * st + i] : 1.f;
              const float x = m * pq[q][c] - go[c];
              const float q0 = x * rdn[c];  // x / dn, then one FMA correction
              const float de = fmaf(fmaf(-q0, dn[c], x), rdn[c], q0) * s_deriv[k * st + i];
              dsum[c] += de;
#pragma unroll
              for (int v = 0; v < VEC; ++v) pacc[c][v] += de * xv[q][c][v];
            }
          }
        }
        q0 = q1;
      }
    }
    while (p < p_end) next();  // the last piece, then trailing empty ones
  }

  // the block's partial row of d a_src: its groups' rows summed in group order
  __syncthreads();  // every group's walk is done: the entry arrays are free
  float* s_acc = reinterpret_cast<float*>(smem);  // [WALK_UNITS][W]
  const int w = a.nc * VEC;
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (live[c]) store_f32(s_acc + gid * w + (c0 + 32 * c) * VEC, pacc[c]);
  __syncthreads();
  float* prow = a.partial + blockIdx.x * a.ld;
  for (int col = threadIdx.x; col < w; col += blockDim.x) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < WALK_UNITS; ++j) s += s_acc[j * w + col];
    prow[col] = s;
  }
}

// de_sum (and godot, unless null) of each split row from its scratch slots:
// de summed in piece order, godot from the first piece (every piece formed
// the same bits); one thread per (split row, head)
__global__ void bwd_dst_combine(const float* __restrict__ scratch, const int* __restrict__ split_rows,
                                const int* __restrict__ split_ptr, float* __restrict__ de_sum,
                                float* __restrict__ godot, int n_split, int heads) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_split * heads) return;
  const int r = i / heads;
  const int k = i - r * heads;
  float s = 0.f;
  for (int sl = split_ptr[r]; sl < split_ptr[r + 1]; ++sl)
    s += scratch[static_cast<long long>(sl) * 2 * heads + k];
  const long long row = split_rows[r];
  de_sum[row * heads + k] = s;
  if (godot != nullptr)
    godot[row * heads + k] = scratch[static_cast<long long>(split_ptr[r]) * 2 * heads + heads + k];
}

template <typename T, bool GIVEN>
cudaError_t launch_walk(const WalkArgs<T>& a, size_t smem, cudaStream_t st) {
  const dim3 block(32 * WALK_UNITS / a.groups);
  const dim3 grid((a.n_units + WALK_UNITS - 1) / WALK_UNITS);
  cudaError_t err = cudaErrorInvalidValue;
  switch ((a.nc + 31) / 32) {
#define PPT_CASE(C)                                                              \
  case C:                                                                        \
    if constexpr (C * RowVec<T>::kElems <= (GIVEN ? 16 : 32)) { /* strips <= 512 */ \
      err = allow_smem(bwd_dst_walk<T, C, GIVEN>, smem);                         \
      if (err != cudaSuccess) return err;                                        \
      bwd_dst_walk<T, C, GIVEN><<<grid, block, smem, st>>>(a);                   \
      err = cudaGetLastError();                                                  \
    }                                                                            \
    break;
    PPT_CASE(1) PPT_CASE(2) PPT_CASE(3) PPT_CASE(4) PPT_CASE(5) PPT_CASE(6) PPT_CASE(7)
    PPT_CASE(8)
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

// The backward's arguments, as ppt_gat_bwd_dst takes them.
struct BwdArgs {
  const void* hs;
  const float *gs, *gd, *g, *out, *den;
  const int *piece_ptr, *piece_out, *unit_ptr, *row_ptr, *src, *erow;
  const float* mask;
  float *de_sum, *godot, *partial, *scratch;
  const int *split_rows, *split_ptr;
  int n, heads, d, n_edges, n_units, n_split, stride;
  float* ghs;
};

// for one head wider than STRIP, row_dots over the full rows first; then
// the walk over the whole [H * D] row or once per strip, and the combine
template <typename T>
cudaError_t backward(const BwdArgs& f, cudaStream_t st) {
  constexpr int VEC = RowVec<T>::kElems;
  const T* hs = static_cast<const T*>(f.hs);
  const int width = f.heads * f.d;
  const bool strips = f.heads == 1 && f.d > STRIP;
  cudaError_t err = cudaSuccess;
  if (strips) {
    const dim3 block(32 * WARPS_PER_BLOCK);
    const dim3 grid((f.n + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
    row_dots<float, T><<<grid, block, 0, st>>>(f.g, hs, f.out, f.row_ptr, f.src, f.ghs, f.godot, f.n,
                                               f.d, f.d, f.d);
    err = cudaGetLastError();
  }
  const int strip = strips ? STRIP : width;
  const size_t words = 1 + f.heads * (f.mask != nullptr ? 2 : 1) + (strips ? 1 : 0);
  for (int c0 = 0; c0 < width && err == cudaSuccess; c0 += strip) {
    const int w = width - c0 < strip ? width - c0 : strip;  // this pass's columns
    const int nc = w / VEC;
    const int span = span_of(nc);
    const int per_head = nc / f.heads;  // chunks of one head
    const WalkArgs<T> a{hs + c0, f.g + c0, f.out + c0, f.gs, f.gd, f.den, f.piece_ptr,
                        f.piece_out, f.unit_ptr, f.src, f.erow, f.mask,
                        strips ? f.ghs : nullptr, strips ? f.godot : nullptr,
                        c0 == 0 ? f.de_sum : nullptr, strips ? nullptr : f.godot, f.partial + c0,
                        f.scratch, f.n, f.n_units, f.n_edges, f.heads, w / f.heads, width, nc, span,
                        32 / span, f.heads == 1 || per_head > span ? span : per_head, f.stride};
    const size_t smem_entries = static_cast<size_t>(f.stride) * 4 * words;
    const size_t smem_rows = static_cast<size_t>(WALK_UNITS) * w * 4;
    const size_t smem = smem_entries > smem_rows ? smem_entries : smem_rows;
    err = strips ? launch_walk<T, true>(a, smem, st) : launch_walk<T, false>(a, smem, st);
    if (err == cudaSuccess && c0 == 0 && f.n_split > 0) {
      const int threads = f.n_split * f.heads;
      bwd_dst_combine<<<(threads + 255) / 256, 256, 0, st>>>(
          f.scratch, f.split_rows, f.split_ptr, f.de_sum, strips ? nullptr : f.godot, f.n_split,
          f.heads);
      err = cudaGetLastError();
    }
  }
  return err;
}

}  // namespace

// hs [n, heads, d] rows (bf16 if hs_bf16, else f32), 16-byte aligned;
// gs/gd/den [n, heads] f32; g/out [n, heads, d] f32, 16-byte aligned; the
// plan of row_ptr (piece_ptr, piece_out, unit_ptr, as spmm_csr.cu takes
// it); row_ptr [n + 1], src [E] and erow [E] int32 (CSR by destination,
// each entry's destination); mask [heads, E] f32 over canonical ids or
// null. Writes de_sum [n, heads], godot [n, heads] and partial [blocks,
// heads * d] f32, blocks = ceil(n_units / WALK_UNITS). scratch [slots, 2,
// heads] f32; split_rows [n_split], split_ptr [n_split + 1] int32. stride:
// an odd number of entries >= the most entries a block's WALK_UNITS units
// hold. One head: d a positive multiple of 32; above 512, ghs is an [E] f32
// scratch buffer (per-edge g_d . hs_s), else unused. 2 <= heads <= 8: d a
// power of two in [32, 512], heads * d <= 1024.
PPT_EXPORT int ppt_gat_bwd_dst(const void* hs, int hs_bf16, const float* gs, const float* gd,
                               const float* g, const float* out, const float* den,
                               const int* piece_ptr, const int* piece_out, const int* unit_ptr,
                               const int* row_ptr, const int* src, const int* erow,
                               const float* mask, float* de_sum, float* godot, float* partial,
                               float* scratch, const int* split_rows, const int* split_ptr, int n,
                               int heads, int d, int n_edges, int n_units, int n_split, int stride,
                               float* ghs, void* stream) {
  const bool one = heads == 1 && d > 0 && d % 32 == 0;
  const bool packed = heads >= 2 && heads <= 8 && d >= 32 && d <= 512 && (d & (d - 1)) == 0 &&
                      heads * d <= 1024;
  if ((!one && !packed) || stride % 2 == 0 || (one && d > STRIP && ghs == nullptr) ||
      (n_split > 0 && (piece_out == nullptr || scratch == nullptr)))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const BwdArgs f{hs, gs, gd, g, out, den, piece_ptr, piece_out, unit_ptr, row_ptr, src, erow,
                  mask, de_sum, godot, partial, scratch, split_rows, split_ptr, n, heads, d,
                  n_edges, n_units, n_split, stride, ghs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return hs_bf16 ? backward<__nv_bfloat16>(f, st) : backward<float>(f, st);
}
