"""Fused GAT attention, forward and backward, at 1 to 8 heads: CUDA kernels,
their plain versions, and the one autograd op over them.

Counterpart of `plotpointe_tpu/ops/gat_fused.py` (`attention_v3`,
`attention_v3_mh`) and its kernels:
  forward     `_fwd_kernel`     -> `csrc/gat_fwd.cu`       (`attention_fwd`)
  B1          `_bwd_kernel`     -> `csrc/gat_bwd_dst.cu`   (`attention_bwd_dst`)
  B2          `_bwd2_kernel`    -> `csrc/gat_bwd_src.cu`   (`attention_bwd_src`)
  fence       `_gather_fence`   -> `csrc/gather_fence.cu`  (`gather_fence`)
  mh forward  `_fwd_kernel_mh`  -> `csrc/gat_fwd.cu`       (`attention_fwd_mh`)
  mh B1       `_bwd_kernel_mh`  -> `csrc/gat_bwd_dst.cu`   (`attention_bwd_dst_mh`)
  reduce      `_reduce_kernel`  -> `csrc/spmm_csr.cu`, pre-gathered rows and
                                   unit weights (`segment_sum_rows`)
Each `*_plain` function is the same function in plain PyTorch, used for CPU
tensors and as the reference its kernel is held to on the card. A wrapper
launches its kernel for CUDA tensors (or raises) and counts the launch.

`Attention` is the one autograd op, h [N, H, D] -> [N, H, D] at 1 to 8
heads: kernel 1 (one head) or 8 (2-8 heads) forward, then B1 for every head
in one launch (kernel 2 or 9) and B2 once a head, on that head's rows of
the [N, H, D] tensors read with a row stride (no per-head copies). One head
takes D a multiple of 32 at any width (the kernels run rows wider than 512
in column strips); 2-8 heads take the packed rule, D a power of two in
[32, 512] and H * D <= 1,024. `attention_v3` (one head) and
`attention_v3_mh` (2-8 heads) are its JAX names. Inside
`reference_versions()` (the package root's switch, re-exported here) it runs
the plain versions on any device, for checks that hold a kernel path
against its reference on the card.

Kernels 1, 8, 2 (B1) and 9 walk the cached piece plan of `row_ptr`, and B2
that of `t_ptr` (`spmm_kernel.cached_walk`). Kernels 1 and 8 are one C
entry (`csrc/gat_fwd.cu`) behind one wrapper (`_fwd`), and so are kernels 2
and 9 (`csrc/gat_bwd_dst.cu`, `_bwd_dst`); each kernel counts on its own
counter. They read rows in 16-byte loads: their wrappers raise where a row
view they would pass does not start 16-byte aligned, or its rows are not a
multiple of 16 bytes apart. `attention_fwd_mh_pieces` (kernel 1 at one head,
kernel 8 at more), `attention_bwd_dst_pieces` (kernel 2 at one head, kernel
9 at more) and `attention_bwd_src_pieces` are the functions in the walks'
order of sums, for the tests.

Rounding matches the TPU kernels: source rows are rounded to `hs_dtype`
(for the source logit term gs = round(h) . a_src, the aggregation and the
backward's row products), the destination term gd = h . a_dst uses the f32
rows, and every sum is f32. The dropout mask multiplies the numerator of the
output only; the denominator sums the unmasked numerators. In the backward,
B1 uses the f32 cotangent g; B2 uses g rounded to `hs_dtype` (for its row
product and its alpha * g term) and recomputes de from it, so in bf16 mode
B1 and B2 see slightly different de, as in `attn_bwd`.

Dropout: head k masks with `hash_mask(seed, eid + id_offset + k * 2**27,
rate)` over canonical edge ids, one seed for all heads, as the JAX package
does; `id_offset` lets one single-head pass draw head k's mask, and a
shard's local graph pass the canonical id of its first edge.

The training step does not call `gather_fence`: on the TPU it orders two
XLA row gathers of the backward, and the port's kernels gather rows
themselves, so no such pair remains.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from plotpointe_tpu_torch import reference_active, reference_versions  # noqa: F401 (re-exported)
from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops import cuda_build as cb
from plotpointe_tpu_torch.ops.segment import EPS, LEAKY_SLOPE, LOGIT_CLAMP, edge_numerators
from plotpointe_tpu_torch.ops.spmm_kernel import (
    CAP, WALK_UNITS, cached_walk, piece_order_sum, piece_plan, spmm_gathered, spmm_gathered_plain)

LAUNCHES = cb.COUNTERS["gat_fwd"]
BWD_DST_LAUNCHES = cb.COUNTERS["gat_bwd_dst"]
BWD_SRC_LAUNCHES = cb.COUNTERS["gat_bwd_src"]
FENCE_LAUNCHES = cb.COUNTERS["gather_fence"]
MH_LAUNCHES = cb.COUNTERS["gat_fwd_mh"]
MH_BWD_DST_LAUNCHES = cb.COUNTERS["gat_bwd_dst_mh"]
ONEHOT_LAUNCHES = cb.COUNTERS["onehot_reduce"]
STRIP = 512  # rows wider than this run in column strips in the kernels (csrc/attention.cuh)
MAX_PACKED_HEADS = 8
MAX_PACKED_WIDTH = 1024  # heads * D the head-packed kernels hold in registers
HEAD_ID_STRIDE = 1 << 27  # head k's mask hashes canonical id + k * 2**27
_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32


def hash_mask(seed: int, ids: torch.Tensor, rate: float) -> torch.Tensor:
    """Stateless per-edge dropout mask, bit-exact to the JAX package's
    `_hash_mask`: a splitmix32-style hash of the canonical edge id xor a
    uint32 seed decides keep (1 / (1 - rate)) or drop (0). uint32 arithmetic
    is emulated in int64 with `& 0xFFFFFFFF`."""
    x = (ids.to(torch.int64) & _M32) ^ (int(seed) & _M32)
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    x = x ^ (x >> 16)
    thresh = min(int((1.0 - rate) * 4294967296.0), 4294967295)
    return (x < thresh).to(torch.float32) * (1.0 / (1.0 - rate))


def dropout_mask_mh(graph: Graph, rate: float, seed: Optional[int], heads: int,
                    device, id_offset: int = 0) -> Optional[torch.Tensor]:
    """[heads, E] hash masks, head k over canonical ids + `id_offset` + k *
    2**27, or None without dropout. A graph that holds the edges from
    canonical id e_lo on (a shard's local graph) passes id_offset = e_lo."""
    if rate <= 0.0 or seed is None:
        return None
    ids = torch.arange(graph.n_edges, device=device) + id_offset
    if heads > 1:
        ids = ids + torch.arange(0, heads * HEAD_ID_STRIDE, HEAD_ID_STRIDE, device=device)[:, None]
    return hash_mask(seed, ids.view(heads, -1), rate)


def dropout_mask(graph: Graph, rate: float, seed: Optional[int], device,
                 id_offset: int = 0) -> Optional[torch.Tensor]:
    """`dropout_mask_mh` at one head: the mask [E], or None."""
    mask = dropout_mask_mh(graph, rate, seed, 1, device, id_offset)
    return None if mask is None else mask[0]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def node_terms_plain(h2: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                     hs_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h2 [N, D] f32 -> (rows [N, D] at hs_dtype, gs = rows . a_src,
    gd = h2 . a_dst), the per-node terms every kernel reads."""
    rows = h2.to(hs_dtype)
    return rows, rows.float() @ a_src[0], h2 @ a_dst[0]


def _aggregate_plain(rows, gs, gd, graph, mask):
    num = edge_numerators(gs, gd, graph)  # [E]
    dst = graph.dst.long()
    den = torch.zeros(graph.n_nodes, dtype=torch.float32, device=rows.device).index_add_(0, dst, num)
    w = num if mask is None else num * mask
    acc = torch.zeros(rows.shape, dtype=torch.float32, device=rows.device)
    acc.index_add_(0, dst, w[:, None] * rows.float()[graph.src.long()])
    return acc / (den[:, None] + EPS), den


def attention_fwd_plain(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                        mask: Optional[torch.Tensor] = None,
                        hs_dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """h [N, 1, D] f32, a_src/a_dst [1, D] -> (out [N, 1, D], den [N])."""
    rows, gs, gd = node_terms_plain(h[:, 0, :].float(), a_src, a_dst, hs_dtype)
    out, den = _aggregate_plain(rows, gs, gd, graph, mask)
    return out[:, None, :], den


def _check_tensor(name, t, dtype, device, shape=None):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} on {device}; got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}; got {tuple(t.shape)}")


def _check_width(d):
    if d % 32 != 0:
        raise ValueError(f"the attention kernels take D a multiple of 32; got D={d}")


def _check_mask(mask, graph, device):
    if mask is not None and (mask.shape != (graph.n_edges,) or mask.dtype != torch.float32
                             or mask.device != device):
        raise ValueError(f"mask must be float32 [{graph.n_edges}] on {device}")


def _check_rows_aligned(name, t):
    """The walk kernels (1, 8 and B2) read rows in 16-byte loads: the first
    row and the row stride of `t` must be 16-byte aligned."""
    if t.data_ptr() % 16 or t.stride(0) * t.element_size() % 16:
        raise ValueError(f"{name} rows must start 16-byte aligned, 16 bytes apart or a multiple of "
                         f"that: the kernel reads them in 16-byte loads (address % 16 = "
                         f"{t.data_ptr() % 16}, row stride {t.stride(0)} elements)")


def _check_packed_shape(heads, d):
    if not (2 <= heads <= MAX_PACKED_HEADS and 32 <= d <= 512 and not d & (d - 1)
            and heads * d <= MAX_PACKED_WIDTH):
        raise ValueError(f"the head-packed kernels take 2 to {MAX_PACKED_HEADS} heads, D a power "
                         f"of two in [32, 512] and heads * D <= {MAX_PACKED_WIDTH}; got "
                         f"heads={heads}, D={d}")


def _check(h, a_src, a_dst, graph, mask, hs_dtype):
    """The forward's inputs at 1 to 8 heads: h [N, H, D] f32, a_src/a_dst
    [H, D] f32, mask [H, E] f32 or None. One head takes D a multiple of 32,
    more heads the packed rule."""
    n, heads, d = h.shape
    if heads == 1:
        _check_width(d)
    else:
        _check_packed_shape(heads, d)
    if n != graph.n_nodes:
        raise ValueError(f"h has {n} rows but the graph has {graph.n_nodes} nodes")
    if hs_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hs_dtype must be float32 or bfloat16; got {hs_dtype}")
    for name, t, dt, shape in (("h", h, torch.float32, None),
                               ("a_src", a_src, torch.float32, (heads, d)),
                               ("a_dst", a_dst, torch.float32, (heads, d)),
                               ("src", graph.src, torch.int32, None),
                               ("row_ptr", graph.row_ptr, torch.int32, None)):
        _check_tensor(name, t, dt, h.device, shape)
    if mask is not None:
        _check_tensor("mask", mask, torch.float32, h.device, (heads, graph.n_edges))


def _one_head(name, h, mask=None):
    """A single-head wrapper's guard: h [N, 1, D]. Returns its mask [E] as
    `_check` takes it, [1, E]."""
    if h.shape[1] != 1:
        raise ValueError(f"{name} is single-head; got heads={h.shape[1]}")
    return None if mask is None else mask[None]


def _fwd(h, a_src, a_dst, graph, mask, hs_dtype, counter, plain=False):
    """h [N, H, D] f32, a_src/a_dst [H, D], mask [H, E] or None -> (out
    [N, H, D], den [N, H], rows, gs, gd): the output plus the per-node terms
    the backward reads. Kernel 1 at one head, kernel 8 at 2-8; a launch
    counts on `counter`."""
    n, heads, d = h.shape
    if plain or h.is_cpu:
        rows, gs, gd = node_terms_mh_plain(h, a_src, a_dst, hs_dtype)
        parts = [_aggregate_plain(rows[:, k], gs[:, k], gd[:, k], graph,
                                  None if mask is None else mask[k]) for k in range(heads)]
        return (torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1),
                rows, gs, gd)
    dev = h.device
    h = h.contiguous()
    bf16 = hs_dtype == torch.bfloat16
    if not bf16:
        _check_rows_aligned("h", h.view(n, heads * d))  # the f32 rows are h itself
    a_s, a_d = a_src.contiguous(), a_dst.contiguous()
    m = None if mask is None else mask.contiguous()
    (piece_ptr, piece_out, unit_ptr, n_slots, split_rows, split_ptr, n_units, n_split), erow, most = \
        cached_walk(graph.row_ptr)
    hs = torch.empty((n, heads, d), dtype=torch.bfloat16, device=dev) if bf16 else None
    gs = torch.empty((n, heads), dtype=torch.float32, device=dev)
    gd, den = torch.empty_like(gs), torch.empty_like(gs)
    out = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    # split rows' partial sums; one head runs column strips (<= 512) one at a time
    cols = min(d, STRIP) if heads == 1 else heads * d
    scratch = torch.empty((n_slots, cols), dtype=torch.float32, device=dev) if n_split else None
    scratch_den = torch.empty((n_slots, heads), dtype=torch.float32, device=dev) if n_split else None
    cb.launch("gat_fwd", dev, *map(cb.ptr, (h, a_s, a_d)), piece_ptr, piece_out, unit_ptr,
              *map(cb.ptr, (graph.src, erow, m, hs, gs, gd, out, den, scratch, scratch_den)),
              split_rows, split_ptr, n, heads, d, graph.n_edges, n_units, n_split, most | 1)
    counter.bump()
    return out, den, (h if hs is None else hs), gs, gd


def attention_fwd(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                  mask: Optional[torch.Tensor] = None,
                  hs_dtype: torch.dtype = torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention forward. h [N, 1, D] f32 (D a multiple of 32),
    a_src/a_dst [1, D] f32, mask [E] f32 over canonical edge ids or None.
    Returns (out [N, 1, D] f32, den [N] f32). Launches the CUDA kernel for
    CUDA tensors; runs `attention_fwd_plain` for CPU tensors."""
    m = _one_head("attention_fwd", h, mask)
    _check(h, a_src, a_dst, graph, m, hs_dtype)
    if h.is_cpu:
        return attention_fwd_plain(h, a_src, a_dst, graph, mask, hs_dtype)
    out, den = _fwd(h, a_src, a_dst, graph, m, hs_dtype, LAUNCHES)[:2]
    return out, den[:, 0]


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _edge_terms(gs, gd, src, dst):
    """Per edge: num = exp(clamp(lrelu(x))) and d num / d x, x = gs[src] + gd[dst]."""
    x = gs[src] + gd[dst]
    lx = torch.where(x > 0, x, LEAKY_SLOPE * x)
    num = torch.exp(torch.clamp(lx, -LOGIT_CLAMP, LOGIT_CLAMP))
    inside = (lx > -LOGIT_CLAMP) & (lx < LOGIT_CLAMP)
    deriv = num * inside.to(num.dtype) * torch.where(x > 0, 1.0, LEAKY_SLOPE)
    return num, deriv


def _bwd_dst_terms(rows, gs, gd, g, out, den, graph: Graph, mask: Optional[torch.Tensor]):
    """One head of B1, per edge: (de [E], godot [N] = g . out, the source
    rows [E, D] in f32). rows [N, D] at the row type; gs/gd/den [N]; g/out
    [N, D] f32; mask [E] or None."""
    src, dst = graph.src.long(), graph.dst.long()
    hs = rows.float()[src]
    _, deriv = _edge_terms(gs, gd, src, dst)
    ghs = (g[dst] * hs).sum(1)
    godot = (g * out).sum(1)
    m = 1.0 if mask is None else mask
    return ((m * ghs - godot[dst]) / (den[dst] + EPS)) * deriv, godot, hs


def attention_bwd_dst_plain(rows, gs, gd, g, out, den, graph: Graph,
                            mask: Optional[torch.Tensor] = None):
    """B1's function. rows [N, D] at the row type; gs/gd/den [N]; g/out
    [N, D] f32. Returns (de_sum [N], godot [N] = g . out, da_src [1, D] =
    sum_e de_e * rows[src_e])."""
    de, godot, hs = _bwd_dst_terms(rows, gs, gd, g, out, den, graph, mask)
    de_sum = torch.zeros(graph.n_nodes, dtype=torch.float32, device=rows.device).index_add_(
        0, graph.dst.long(), de)
    return de_sum, godot, (de[:, None] * hs).sum(0, keepdim=True)


def attention_bwd_src_plain(rows, gh, a_src, gs, gd, den, godot, graph: Graph,
                            mask: Optional[torch.Tensor] = None):
    """B2's function. gh [N, D] is the cotangent at the row type. Returns
    dh [N, D] = sum over each source's out-edges of alpha_e * gh[dst_e] +
    de_e * a_src, with alpha and de recomputed from gh."""
    src, dst = graph.src.long(), graph.dst.long()
    hs, ghf = rows.float(), gh.float()
    num, deriv = _edge_terms(gs, gd, src, dst)
    ghd = ghf[dst]
    ghs = (ghd * hs[src]).sum(1)
    den_e = den[dst] + EPS
    m = 1.0 if mask is None else mask
    de = ((m * ghs - godot[dst]) / den_e) * deriv
    contrib = (m * num / den_e)[:, None] * ghd + de[:, None] * a_src.reshape(1, -1)
    return torch.zeros(rows.shape, dtype=torch.float32, device=rows.device).index_add_(0, src, contrib)


def _check_bwd(rows, graph, mask, **f32):
    n, d = rows.shape
    _check_width(d)
    if n != graph.n_nodes:
        raise ValueError(f"rows has {n} rows but the graph has {graph.n_nodes} nodes")
    if rows.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rows must be float32 or bfloat16; got {rows.dtype}")
    for name, t in f32.items():
        _check_tensor(name, t, torch.float32, rows.device, (n, d) if t.dim() == 2 else (n,))
    _check_mask(mask, graph, rows.device)


def _edge_scratch(graph: Graph, d: int, device) -> Optional[torch.Tensor]:
    """The backward kernels' [E] f32 buffer of per-edge dot products over
    the full row, which rows wider than one column strip (512) need; None
    below."""
    return torch.empty(max(1, graph.n_edges), dtype=torch.float32, device=device) \
        if d > STRIP else None


def _bwd_dst(rows, gs, gd, g, out, den, graph: Graph, mask, counter):
    """B1 at 1 to 8 heads on the card: rows [N, H, D] at the row type,
    gs/gd/den [N, H], g/out [N, H, D] f32, mask [H, E] or None -> (de_sum
    [N, H], godot [N, H], da_src [H, D]). One call of `csrc/gat_bwd_dst.cu`
    (kernel 2 at one head, kernel 9 at more), counted on `counter`; the
    kernel writes one partial row of d a_src a block, summed here."""
    n, heads, d = rows.shape
    dev = rows.device
    rows = rows.contiguous()
    _check_rows_aligned("rows", rows.view(n, heads * d))
    g, out = cb.aligned(g), cb.aligned(out)  # read in 16-byte loads
    gs, gd, den = (t.contiguous() for t in (gs, gd, den))
    m = None if mask is None else mask.contiguous()
    (piece_ptr, piece_out, unit_ptr, n_slots, split_rows, split_ptr, n_units, n_split), erow, most = \
        cached_walk(graph.row_ptr)
    de_sum = torch.empty((n, heads), dtype=torch.float32, device=dev)
    godot = torch.empty_like(de_sum)
    partial = torch.empty((-(-n_units // WALK_UNITS), heads * d), dtype=torch.float32, device=dev)
    # split rows' piece sums of de and their godot
    scratch = torch.empty((n_slots, 2 * heads), dtype=torch.float32, device=dev) if n_split else None
    ghs = _edge_scratch(graph, d, dev) if heads == 1 else None  # held until the launch is queued
    cb.launch("gat_bwd_dst", dev, cb.ptr(rows), int(rows.dtype == torch.bfloat16),
              *map(cb.ptr, (gs, gd, g, out, den)), piece_ptr, piece_out, unit_ptr,
              *map(cb.ptr, (graph.row_ptr, graph.src, erow, m, de_sum, godot, partial, scratch)),
              split_rows, split_ptr, n, heads, d, graph.n_edges, n_units, n_split, most | 1, cb.ptr(ghs))
    counter.bump()
    return de_sum, godot, partial.sum(0).view(heads, d)


def attention_bwd_dst(rows, gs, gd, g, out, den, graph: Graph,
                      mask: Optional[torch.Tensor] = None):
    """B1: `attention_bwd_dst_plain`'s function; launches `csrc/gat_bwd_dst.cu`
    at one head for CUDA tensors (rows that do not start 16-byte aligned
    raise). The kernel writes one partial row of d a_src per block; they are
    summed here."""
    _check_bwd(rows, graph, mask, gs=gs, gd=gd, g=g, out=out, den=den)
    if rows.is_cpu:
        return attention_bwd_dst_plain(rows, gs, gd, g, out, den, graph, mask)
    de_sum, godot, da_src = _bwd_dst(rows.unsqueeze(1), gs[:, None], gd[:, None], g, out, den[:, None],
                                     graph, None if mask is None else mask[None], BWD_DST_LAUNCHES)
    return de_sum[:, 0], godot[:, 0], da_src


def attention_bwd_src(rows, gh, a_src, gs, gd, den, godot, graph: Graph,
                      mask: Optional[torch.Tensor] = None):
    """B2: `attention_bwd_src_plain`'s function; launches `csrc/gat_bwd_src.cu`
    for CUDA tensors. rows and gh may be row-strided views (one head's rows
    of an [N, H, D] tensor): the kernel reads them in place."""
    _check_bwd(rows, graph, mask, gs=gs, gd=gd, den=den, godot=godot)
    n, d = rows.shape
    if gh.dtype != rows.dtype or tuple(gh.shape) != (n, d) or gh.device != rows.device:
        raise ValueError(f"gh must be {rows.dtype} [{n}, {d}] on {rows.device}")
    _check_tensor("a_src", a_src, torch.float32, rows.device, (1, d))
    if rows.is_cpu:
        return attention_bwd_src_plain(rows, gh, a_src, gs, gd, den, godot, graph, mask)
    dev = rows.device
    if rows.stride(1) != 1 or gh.stride() != rows.stride():
        rows, gh = rows.contiguous(), gh.contiguous()
    _check_rows_aligned("rows", rows)
    _check_rows_aligned("gh", gh)
    (piece_ptr, piece_out, unit_ptr, n_slots, split_rows, split_ptr, n_units, n_split), erow, most = \
        cached_walk(graph.t_ptr)
    dh = torch.empty((n, d), dtype=torch.float32, device=dev)
    w = min(d, STRIP)
    scratch = torch.empty((n_slots, w), dtype=torch.float32, device=dev) if n_split else None
    scratch_de = torch.empty(n_slots, dtype=torch.float32, device=dev) if n_split else None
    tables = [t.contiguous() for t in (gs, gd, den, godot)]
    a_s = cb.aligned(a_src.reshape(d))  # read in 16-byte loads
    m = None if mask is None else mask.contiguous()
    ghs = _edge_scratch(graph, d, dev)  # held until the launch is queued
    cb.launch("gat_bwd_src", dev, cb.ptr(rows), cb.ptr(gh), int(rows.dtype == torch.bfloat16),
              cb.ptr(a_s), *map(cb.ptr, tables), piece_ptr, piece_out, unit_ptr,
              *map(cb.ptr, (graph.t_ptr, graph.t_dst, graph.t_eid, erow, m, dh, scratch, scratch_de)),
              split_rows, split_ptr, n, d, rows.stride(0), n_units, n_split, most | 1, cb.ptr(ghs))
    BWD_SRC_LAUNCHES.bump()
    return dh


def attention_bwd_src_pieces(rows, gh, a_src, gs, gd, den, godot, graph: Graph,
                             mask: Optional[torch.Tensor] = None, cap: int = CAP):
    """B2's function in the kernel's order of sums: each piece of the
    transpose CSR's `piece_plan(t_ptr, cap)` sums (alpha_e * gh_d, de_e) in
    entry order, a split row's pieces are added in piece order, then
    dh = sum + (sum de) * a_src. For the tests of that order."""
    eid, dst = graph.t_eid.long(), graph.t_dst.long()
    src = graph.src.long()[eid]
    num, deriv = _edge_terms(gs, gd, src, dst)
    ghd = gh.float()[dst]
    ghs = (ghd * rows.float()[src]).sum(1)
    den_e = den[dst] + EPS
    m = 1.0 if mask is None else mask[eid]
    de = ((m * ghs - godot[dst]) / den_e) * deriv
    sums = piece_order_sum(torch.cat([(m * num / den_e)[:, None] * ghd, de[:, None]], 1), graph.t_ptr, cap)
    return sums[:, :-1] + sums[:, -1:] * a_src.reshape(1, -1)


# ---------------------------------------------------------------------------
# head-packed multi-head attention (2 <= heads <= 8)
# ---------------------------------------------------------------------------


def node_terms_mh_plain(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                        hs_dtype: torch.dtype):
    """h [N, H, D] f32 -> (rows [N, H, D] at hs_dtype, gs [N, H] =
    rows . a_src, gd [N, H] = h . a_dst): `node_terms_plain` per head."""
    terms = [node_terms_plain(h[:, k], a_src[k:k + 1], a_dst[k:k + 1], hs_dtype)
             for k in range(h.shape[1])]
    return tuple(torch.stack(t, 1) for t in zip(*terms))


def attention_fwd_mh_plain(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                           graph: Graph, mask: Optional[torch.Tensor] = None,
                           hs_dtype: torch.dtype = torch.bfloat16):
    """h [N, H, D] f32, a_src/a_dst [H, D], mask [H, E] or None -> (out
    [N, H, D], den [N, H]): kernel 1's function for each head."""
    return _fwd(h, a_src, a_dst, graph, mask, hs_dtype, MH_LAUNCHES, plain=True)[:2]


def attention_fwd_mh_pieces(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                            graph: Graph, mask: Optional[torch.Tensor] = None,
                            hs_dtype: torch.dtype = torch.bfloat16, cap: int = CAP):
    """The forward walk's function in its order of sums (kernel 1 at one
    head, h [N, 1, D] and mask [1, E]; kernel 8 at more): each piece of
    `piece_plan(row_ptr, cap)` sums (w_e * hs_src [H, D], num_e [H]) in entry
    order, a split row's pieces are added in piece order, then out = sum /
    (den + 1e-9). Column strips do not change it: each column's sum is the
    same. For the tests of that order."""
    n, heads, d = h.shape
    rows, gs, gd = node_terms_mh_plain(h, a_src, a_dst, hs_dtype)
    num = torch.stack([edge_numerators(gs[:, k], gd[:, k], graph) for k in range(heads)], 1)
    w = num if mask is None else num * mask.T
    msg = torch.cat([(w[:, :, None] * rows.float()[graph.src.long()]).reshape(-1, heads * d), num], 1)
    sums = piece_order_sum(msg, graph.row_ptr, cap)
    den = sums[:, heads * d:]
    return sums[:, :heads * d].view(n, heads, d) / (den[:, :, None] + EPS), den


def attention_fwd_mh(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                     mask: Optional[torch.Tensor] = None,
                     hs_dtype: torch.dtype = torch.bfloat16):
    """Head-packed attention forward (kernel 8): h [N, H, D] f32 with
    2 <= H <= 8, D a power of two in [32, 512], H * D <= 1024; a_src/a_dst
    [H, D] f32; mask [H, E] f32 or None. Returns (out [N, H, D] f32, den
    [N, H] f32). Launches `csrc/gat_fwd.cu` for CUDA tensors; runs
    `attention_fwd_mh_plain` for CPU tensors."""
    _check_packed_shape(*h.shape[1:])
    _check(h, a_src, a_dst, graph, mask, hs_dtype)
    return _fwd(h, a_src, a_dst, graph, mask, hs_dtype, MH_LAUNCHES)[:2]


def attention_bwd_dst_mh_plain(rows, gs, gd, g, out, den, graph: Graph,
                               mask: Optional[torch.Tensor] = None):
    """B1 per head. rows [N, H, D] at the row type; gs/gd/den [N, H]; g/out
    [N, H, D] f32; mask [H, E] or None. Returns (de_sum [N, H], godot
    [N, H], da_src [H, D])."""
    parts = [attention_bwd_dst_plain(rows[:, k], gs[:, k], gd[:, k], g[:, k], out[:, k],
                                     den[:, k], graph, None if mask is None else mask[k])
             for k in range(rows.shape[1])]
    return (torch.stack([p[0] for p in parts], 1), torch.stack([p[1] for p in parts], 1),
            torch.cat([p[2] for p in parts], 0))


def attention_bwd_dst_mh(rows, gs, gd, g, out, den, graph: Graph,
                         mask: Optional[torch.Tensor] = None):
    """Kernel 9: `attention_bwd_dst_mh_plain`'s function; launches
    `csrc/gat_bwd_dst.cu` at 2-8 heads for CUDA tensors (rows that do not
    start 16-byte aligned raise). The kernel writes one partial row of
    d a_src per block; they are summed here."""
    n, heads, d = rows.shape
    _check_packed_shape(heads, d)
    if n != graph.n_nodes or rows.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"rows must be float32 or bfloat16 [{graph.n_nodes}, H, D]")
    dev = rows.device
    for name, t in (("gs", gs), ("gd", gd), ("den", den)):
        _check_tensor(name, t, torch.float32, dev, (n, heads))
    for name, t in (("g", g), ("out", out)):
        _check_tensor(name, t, torch.float32, dev, (n, heads, d))
    if mask is not None:
        _check_tensor("mask", mask, torch.float32, dev, (heads, graph.n_edges))
    if rows.is_cpu:
        return attention_bwd_dst_mh_plain(rows, gs, gd, g, out, den, graph, mask)
    return _bwd_dst(rows, gs, gd, g, out, den, graph, mask, MH_BWD_DST_LAUNCHES)


def attention_bwd_dst_pieces(rows, gs, gd, g, out, den, graph: Graph,
                             mask: Optional[torch.Tensor] = None, cap: int = CAP):
    """B1 and kernel 9 in the walk's order of sums, at 1 to 8 heads: rows
    [N, H, D] at the row type, gs/gd/den [N, H], g/out [N, H, D] f32, mask
    [H, E] or None -> (de_sum [N, H], godot [N, H], da_src [H, D]). de_sum
    sums each piece of `piece_plan(row_ptr, cap)` in entry order and a split
    row's pieces in piece order; d a_src sums each unit's entries in entry
    order (one lane's run), a block's WALK_UNITS units in unit order, then
    the blocks. For the tests of that order."""
    heads, d = rows.shape[1:]
    dev = rows.device
    terms = [_bwd_dst_terms(rows[:, k], gs[:, k], gd[:, k], g[:, k], out[:, k], den[:, k], graph,
                            None if mask is None else mask[k]) for k in range(heads)]
    de = torch.stack([t[0] for t in terms], 1)
    msg = torch.cat([t[0][:, None] * t[2] for t in terms], 1)  # [E, H * D]
    plan = piece_plan(graph.row_ptr, cap)
    piece_ptr = graph.row_ptr if plan.piece_ptr is None else plan.piece_ptr
    piece_unit = torch.repeat_interleave(torch.arange(plan.n_units, device=dev),
                                         (plan.unit_ptr[1:] - plan.unit_ptr[:-1]).long(),
                                         output_size=plan.n_pieces)
    entry_unit = torch.repeat_interleave(piece_unit, (piece_ptr[1:] - piece_ptr[:-1]).long(),
                                         output_size=graph.n_edges)
    units = torch.zeros((plan.n_units, heads * d), device=dev).index_add_(0, entry_unit, msg)
    blocks = torch.zeros((-(-plan.n_units // WALK_UNITS), heads * d), device=dev).index_add_(
        0, torch.arange(plan.n_units, device=dev) // WALK_UNITS, units)
    return (piece_order_sum(de, graph.row_ptr, cap), torch.stack([t[1] for t in terms], 1),
            blocks.sum(0).view(heads, d))


# ---------------------------------------------------------------------------
# the autograd op (1 to 8 heads)
# ---------------------------------------------------------------------------


def _backward(h, a_src, a_dst, graph, g, out, den, rows, gs, gd, mask, plain):
    """(dh [N, H, D], da_src [H, D], da_dst [H, D]) of JAX `attn_bwd` at 1 to
    8 heads: B1 for every head at once (kernel 2 at one head, kernel 9 at
    more), then B2 once a head on that head's rows (row-strided views) and
    the cotangent rounded to the row type; dh adds de_sum * a_dst and
    da_dst = sum_n de_sum * h (f32 rows)."""
    heads = h.shape[1]
    plain = plain or h.is_cpu
    if plain:
        de_sum, godot, da_src = attention_bwd_dst_mh_plain(rows, gs, gd, g, out, den, graph, mask)
    else:
        de_sum, godot, da_src = _bwd_dst(rows, gs, gd, g, out, den, graph, mask,
                                         BWD_DST_LAUNCHES if heads == 1 else MH_BWD_DST_LAUNCHES)
    bwd_src = attention_bwd_src_plain if plain else attention_bwd_src
    gh = g.to(rows.dtype)
    dh = [bwd_src(rows[:, k], gh[:, k], a_src[k:k + 1], gs[:, k].contiguous(), gd[:, k].contiguous(),
                  den[:, k].contiguous(), godot[:, k].contiguous(), graph,
                  None if mask is None else mask[k]) for k in range(heads)]
    if heads == 1:  # no stacking copy; da_dst as JAX's single-head `attn_bwd` forms it
        dh, da_dst = dh[0][:, None], de_sum[:, 0][None, :] @ h[:, 0]
    else:
        dh, da_dst = torch.stack(dh, 1), torch.einsum("nh,nhd->hd", de_sum, h)
    return dh + de_sum[:, :, None] * a_dst, da_src, da_dst


def attention_bwd_mh_plain(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                           graph: Graph, g: torch.Tensor, out: torch.Tensor, den: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           hs_dtype: torch.dtype = torch.bfloat16):
    """The explicit backward of `Attention` in plain PyTorch: h, g, out
    [N, H, D] f32, den [N, H] -> (dh [N, H, D], da_src [H, D], da_dst
    [H, D]). The reference kernels 2, 9 and B2 are held to (not autograd of
    the golden)."""
    rows, gs, gd = node_terms_mh_plain(h, a_src, a_dst, hs_dtype)
    return _backward(h, a_src, a_dst, graph, g, out, den, rows, gs, gd, mask, plain=True)


def attention_bwd_plain(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                        g: torch.Tensor, out: torch.Tensor, den: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        hs_dtype: torch.dtype = torch.bfloat16):
    """`attention_bwd_mh_plain` at one head: den [N], mask [E]."""
    return attention_bwd_mh_plain(h, a_src, a_dst, graph, g, out, den[:, None],
                                  None if mask is None else mask[None], hs_dtype)


class Attention(torch.autograd.Function):
    """The fused attention at 1 to 8 heads, h [N, H, D] -> [N, H, D], with
    JAX `attn_bwd` as its backward: kernel 1 (one head) or 8, then B1 for
    every head (kernel 2 or 9) and B2 once a head; their plain versions for
    CPU tensors, or on any device when the forward ran inside
    `reference_versions()`. The masks are rebuilt in the backward from the
    seed and id offset."""

    @staticmethod
    def forward(ctx, h, a_src, a_dst, graph, dropout_rate, seed, hs_dtype, id_offset):
        plain = reference_active()
        heads = h.shape[1]
        mask = dropout_mask_mh(graph, dropout_rate, seed, heads, h.device, id_offset)
        _check(h, a_src, a_dst, graph, mask, hs_dtype)
        h = h.contiguous()
        out, den, rows, gs, gd = _fwd(h, a_src, a_dst, graph, mask, hs_dtype,
                                      LAUNCHES if heads == 1 else MH_LAUNCHES, plain)
        ctx.save_for_backward(h, a_src, a_dst, out, den, rows, gs, gd)
        ctx.graph, ctx.dropout_rate, ctx.seed, ctx.plain = graph, dropout_rate, seed, plain
        ctx.id_offset = id_offset
        return out

    @staticmethod
    def backward(ctx, g):
        h, a_src, a_dst, out, den, rows, gs, gd = ctx.saved_tensors
        mask = dropout_mask_mh(ctx.graph, ctx.dropout_rate, ctx.seed, h.shape[1], h.device,
                               ctx.id_offset)
        dh, da_src, da_dst = _backward(h, a_src, a_dst, ctx.graph, g.contiguous(), out, den,
                                       rows, gs, gd, mask, ctx.plain)
        return dh, da_src, da_dst, None, None, None, None, None


def attention_v3(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                 dropout_rate: float = 0.0, seed: Optional[int] = None,
                 hs_dtype: torch.dtype = torch.bfloat16, id_offset: int = 0) -> torch.Tensor:
    """`Attention` at one head, h [N, 1, D] -> [N, 1, D] (D a multiple of
    32). With dropout_rate > 0 and a uint32 `seed`, the hash mask over
    canonical edge ids + `id_offset` drops attention weights (the JAX package
    draws its seed as `jax.random.bits(rng, (), uint32)`; head k of a packed
    call offsets the ids by k * HEAD_ID_STRIDE)."""
    _one_head("attention_v3", h)
    return Attention.apply(h, a_src, a_dst, graph, float(dropout_rate), seed, hs_dtype,
                           int(id_offset))


def attention_v3_mh(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    hs_dtype: torch.dtype = torch.bfloat16, id_offset: int = 0) -> torch.Tensor:
    """`Attention` at 2 to 8 heads, h [N, H, D] -> [N, H, D] (D a power of
    two in [32, 512], H * D <= 1024). With dropout_rate > 0 and a uint32
    `seed`, head k drops with the hash mask over canonical ids + `id_offset`
    + k * 2**27."""
    _check_packed_shape(*h.shape[1:])
    return Attention.apply(h, a_src, a_dst, graph, float(dropout_rate), seed, hs_dtype,
                           int(id_offset))


# ---------------------------------------------------------------------------
# gather fence
# ---------------------------------------------------------------------------


def gather_fence_plain(x: torch.Tensor) -> torch.Tensor:
    """[M, D] -> [8, 128] f32, every entry the f32 sum of x[:8, :min(128, D)]."""
    blk = x[:8, : min(128, x.shape[1])].float()
    return blk.sum(0).sum().expand(8, 128).clone()


def gather_fence(x: torch.Tensor) -> torch.Tensor:
    """`_gather_fence`'s function; launches `csrc/gather_fence.cu` for CUDA
    tensors. x [M, D] f32 or bf16, M, D >= 1."""
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"gather_fence takes a non-empty [M, D] tensor; got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gather_fence takes float32 or bfloat16; got {x.dtype}")
    if x.is_cpu:
        return gather_fence_plain(x)
    x = x.contiguous()
    out = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    cb.launch("gather_fence", x.device, cb.ptr(x), int(x.dtype == torch.bfloat16), x.shape[0],
              x.shape[1], cb.ptr(out))
    FENCE_LAUNCHES.bump()
    return out


# ---------------------------------------------------------------------------
# unweighted segment reduce of pre-gathered rows
# ---------------------------------------------------------------------------


def segment_sum_rows_plain(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """[E, W] f32 rows in canonical edge order -> [N, W] f32: each
    destination's sum of its in-edges' rows."""
    return spmm_gathered_plain(x, None, graph.row_ptr)


def segment_sum_rows(x: torch.Tensor, graph: Graph) -> torch.Tensor:
    """The function of `_reduce_kernel` (`_reduce_call`): an unweighted
    per-destination sum of rows gathered per edge, x [E, W] f32 in canonical
    (dst, src) order -> [N, W] f32. JAX reads the rows in its aligned
    layout; the port reads them in canonical order, which groups each
    destination's edges as one CSR row. Launches `csrc/spmm_csr.cu` in its
    pre-gathered, unit-weight mode for CUDA tensors (counted on
    `ONEHOT_LAUNCHES`); runs the plain version for CPU tensors."""
    if x.dim() != 2 or x.shape[0] != graph.n_edges:
        raise ValueError(f"x must be [{graph.n_edges}, W]; got {tuple(x.shape)}")
    return spmm_gathered(x, None, graph.row_ptr, ONEHOT_LAUNCHES)
