"""HGT edge attention (Hu, Dong, Wang and Sun 2020, "Heterogeneous Graph
Transformer"; PyG's `HGTConv`): the scaled dot-product softmax over a
target's in-edges of every relation, forward and backward, as CUDA kernels,
their plain versions and the autograd op.

Port-only. Over a typed graph (`graphs/hetero.py`), with q [N, H, D] f32
(each target's query), kv [S, 2, H, D] the relation-stacked table of K' and
V' rows (the source's key and value under its edge's relation, rounded to
the row type: bf16 on the card, f32 for the export and on the CPU), the
prior p [3, H] and scale = 1 / sqrt(D); per edge e = s -> t of relation r
and head h:
  ps      = p[r, h] * scale
  s_e     = ps * (q_t . K'_s)
  lse_t   = m_t + log(sum_e exp(s_e - m_t))      m_t the largest s_e of t
  alpha_e = exp(s_e - lse_t)                     one softmax over all of t's
                                                 in-edges, every relation
  out_t   = sum_e alpha_e V'_s                   0 for a target with none
The backward, g the cotangent of out:
  ds_e    = alpha_e (g_t . V'_s - g_t . out_t)
  c_e     = ds_e ps
  dq_t    = sum_e c_e K'_s
  dp[r,h] = sum over r's edges of ds_e (q_t . K'_s) scale
  dK'_s   = sum_e c_e q_t,  dV'_s = sum_e alpha_e g_t
The gradient passes the rounding of K' and V' unchanged (straight through);
q and g stay f32.

Kernels (`csrc/hgt_*.cu`, on `walk.cuh`'s piece/unit plan and `gatv2.cuh`'s
lane layout, no atomics, the same bits on every run):
  forward  `hgt_fwd.cu`      a destination-order walk, an online softmax
                             within each piece, split rows combined in piece
                             order: out, lse
  B1       `hgt_bwd_dst.cu`  a destination-order walk: dq, the blocks'
                             partial rows of dp, per edge (c, alpha) [E, 2H]
  B2       `hgt_bwd_src.cu`  a source-order walk over the transpose CSR:
                             dkv [S, 2, H, D] f32
They take H * D of 256 or 512 and D a power of two from 8 to 128;
`hgt_attention` pads D with zero columns to such a width (exact: a zero
column adds nothing to a dot and gives zero output columns, and the scale is
the unpadded D's). Each `*_plain` function is the same function in plain
PyTorch: it runs for CPU tensors and inside `reference_versions()`, and the
card tests hold each kernel to it. Each launch counts on its own counter.

The op's forward and backward are the spans `attn.forward` and
`attn.backward` (device intervals; layer, heads, the edges of each relation,
kind "hgt").
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from plotpointe_tpu_torch import reference_active
from plotpointe_tpu_torch.graphs.hetero import RELATIONS, HeteroGraph
from plotpointe_tpu_torch.ops import cuda_build as cb
from plotpointe_tpu_torch.ops.spmm_kernel import WALK_UNITS, cached_walk
from plotpointe_tpu_torch.utils import tracing

FWD_LAUNCHES = cb.COUNTERS["hgt_fwd"]
BWD_DST_LAUNCHES = cb.COUNTERS["hgt_bwd_dst"]
BWD_SRC_LAUNCHES = cb.COUNTERS["hgt_bwd_src"]
WIDTHS = (256, 512)  # H * D a kernel's row holds
N_REL = len(RELATIONS)


def _edges(graph: HeteroGraph):
    return graph.src.long(), graph.dst.long(), graph.rel.long()


def hgt_fwd_plain(q: torch.Tensor, kv: torch.Tensor, p: torch.Tensor, graph: HeteroGraph,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [N, H, D] f32, kv [S, 2, H, D] at the row type, p [3, H] -> (out
    [N, H, D] f32, lse [N, H] f32; -inf for a target without in-edges)."""
    n, heads, d = q.shape
    src, dst, rel = _edges(graph)
    qk = (q[dst] * kv[:, 0].float()[src]).sum(-1)
    s = qk * (p[rel] * scale)
    m = torch.full((n, heads), -math.inf, dtype=torch.float32, device=q.device)
    m = m.scatter_reduce(0, dst[:, None].expand(-1, heads), s, "amax")
    num = torch.exp(s - m[dst])
    den = torch.zeros((n, heads), dtype=torch.float32, device=q.device).index_add_(0, dst, num)
    acc = torch.zeros((n, heads, d), dtype=torch.float32, device=q.device)
    acc.index_add_(0, dst, num[:, :, None] * kv[:, 1].float()[src])
    out = torch.where(den[:, :, None] > 0, acc / den.clamp_min(1.0)[:, :, None], torch.zeros_like(acc))
    return out, m + torch.log(den)


def hgt_bwd_dst_plain(q, kv, p, g, out, lse, graph: HeteroGraph, scale: float):
    """B1's function: (dq [N, H, D], dp [3, H], edge [E, 2H] = (c | alpha))."""
    n, heads, d = q.shape
    src, dst, rel = _edges(graph)
    k, v = kv[:, 0].float()[src], kv[:, 1].float()[src]
    ps = p[rel] * scale  # [E, H]
    qk = (q[dst] * k).sum(-1)
    alpha = torch.exp(qk * ps - lse[dst])
    go = (g * out).sum(-1)
    ds = alpha * ((g[dst] * v).sum(-1) - go[dst])
    c = ds * ps
    dq = torch.zeros((n, heads, d), dtype=torch.float32, device=q.device).index_add_(0, dst, c[:, :, None] * k)
    dp = torch.zeros((N_REL, heads), dtype=torch.float32, device=q.device).index_add_(0, rel, ds * qk * scale)
    return dq, dp, torch.cat([c, alpha], 1)


def hgt_bwd_src_plain(q: torch.Tensor, g: torch.Tensor, edge: torch.Tensor,
                      graph: HeteroGraph) -> torch.Tensor:
    """B2's function: q, g [N, H, D] f32 and B1's edge [E, 2H] -> dkv [S, 2,
    H, D] f32."""
    _, heads, d = q.shape
    src, dst, _ = _edges(graph)
    dkv = torch.zeros((graph.n_rows, 2, heads, d), dtype=torch.float32, device=q.device)
    dkv[:, 0].index_add_(0, src, edge[:, :heads, None] * q[dst])
    dkv[:, 1].index_add_(0, src, edge[:, heads:, None] * g[dst])
    return dkv


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def check_shape(heads: int, d: int) -> None:
    if not (heads * d in WIDTHS and 8 <= d <= 128 and not d & (d - 1)):
        raise ValueError(f"the HGT kernels take heads * D in {WIDTHS} and D a power of two from 8 to "
                         f"128; got heads={heads}, D={d}")


def _rows(name: str, t: torch.Tensor, shape, dtypes) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {' or '.join(map(str, dtypes))} {tuple(shape)}; "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned: the kernels read rows in 16-byte loads")


def _plan(ptr: torch.Tensor):
    (piece_ptr, piece_out, unit_ptr, n_slots, split_rows, split_ptr, n_units, n_split), erow, most = \
        cached_walk(ptr)
    return (piece_ptr, piece_out, unit_ptr), (split_rows, split_ptr), n_slots, n_units, n_split, erow, most


def _checked(q, kv, p, graph: HeteroGraph):
    n, heads, d = q.shape
    check_shape(heads, d)
    _rows("q", q, (graph.n_nodes, heads, d), (torch.float32,))
    _rows("kv", kv, (graph.n_rows, 2, heads, d), (torch.bfloat16, torch.float32))
    _rows("p", p, (N_REL, heads), (torch.float32,))
    return n, heads, d


def hgt_fwd(q: torch.Tensor, kv: torch.Tensor, p: torch.Tensor, graph: HeteroGraph,
            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """`hgt_fwd_plain`'s function; launches `csrc/hgt_fwd.cu` for CUDA
    tensors."""
    if q.is_cpu:
        return hgt_fwd_plain(q, kv, p, graph, scale)
    n, heads, d = _checked(q, kv, p, graph)
    dev = q.device
    plan, split, n_slots, n_units, n_split, erow, most = _plan(graph.row_ptr)
    out = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    lse = torch.empty((n, heads), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_slots, heads * d), dtype=torch.float32, device=dev) if n_split else None
    scratch_ml = torch.empty((n_slots, 2, heads), dtype=torch.float32, device=dev) if n_split else None
    off = graph.offsets
    cb.launch("hgt_fwd", dev, q.data_ptr(), kv.data_ptr(), int(kv.dtype == torch.bfloat16), p.data_ptr(),
              *plan, graph.src.data_ptr(), erow.data_ptr(), out.data_ptr(), lse.data_ptr(),
              cb.ptr(scratch), cb.ptr(scratch_ml), *split, n, heads, d, n_units, n_split, most | 1,
              off[1], off[2], float(scale))
    FWD_LAUNCHES.bump()
    return out, lse


def hgt_bwd_dst(q, kv, p, g, out, lse, graph: HeteroGraph, scale: float):
    """`hgt_bwd_dst_plain`'s function; launches `csrc/hgt_bwd_dst.cu` for
    CUDA tensors (the kernel writes one partial row of dp a block, summed
    here)."""
    if q.is_cpu:
        return hgt_bwd_dst_plain(q, kv, p, g, out, lse, graph, scale)
    n, heads, d = _checked(q, kv, p, graph)
    for name, t in (("g", g), ("out", out)):
        _rows(name, t, q.shape, (torch.float32,))
    _rows("lse", lse, (n, heads), (torch.float32,))
    dev = q.device
    plan, split, n_slots, n_units, n_split, erow, most = _plan(graph.row_ptr)
    dq = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    partial = torch.empty((-(-n_units // WALK_UNITS), N_REL, heads), dtype=torch.float32, device=dev)
    edge = torch.empty((graph.n_edges, 2 * heads), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_slots, heads * d), dtype=torch.float32, device=dev) if n_split else None
    off = graph.offsets
    cb.launch("hgt_bwd_dst", dev, q.data_ptr(), kv.data_ptr(), int(kv.dtype == torch.bfloat16),
              *(t.data_ptr() for t in (p, g, out, lse)), *plan, graph.src.data_ptr(), erow.data_ptr(),
              dq.data_ptr(), partial.data_ptr(), edge.data_ptr(), cb.ptr(scratch), *split, n, heads, d,
              n_units, n_split, most | 1, off[1], off[2], float(scale))
    BWD_DST_LAUNCHES.bump()
    return dq, partial.sum(0), edge


def hgt_bwd_src(q: torch.Tensor, g: torch.Tensor, edge: torch.Tensor, graph: HeteroGraph) -> torch.Tensor:
    """`hgt_bwd_src_plain`'s function; launches `csrc/hgt_bwd_src.cu` for
    CUDA tensors."""
    if q.is_cpu:
        return hgt_bwd_src_plain(q, g, edge, graph)
    _, heads, d = q.shape
    check_shape(heads, d)
    for name, t in (("q", q), ("g", g)):
        _rows(name, t, (graph.n_nodes, heads, d), (torch.float32,))
    _rows("edge", edge, (graph.n_edges, 2 * heads), (torch.float32,))
    dev = q.device
    plan, split, n_slots, n_units, n_split, _, most = _plan(graph.t_ptr)
    dkv = torch.empty((graph.n_rows, 2, heads, d), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_slots, 2 * heads * d), dtype=torch.float32, device=dev) if n_split else None
    cb.launch("hgt_bwd_src", dev, q.data_ptr(), g.data_ptr(), edge.data_ptr(), *plan,
              graph.t_dst.data_ptr(), graph.t_eid.data_ptr(), dkv.data_ptr(), cb.ptr(scratch), *split,
              graph.n_rows, heads, d, n_units, n_split, most | 1)
    BWD_SRC_LAUNCHES.bump()
    return dkv


# ---------------------------------------------------------------------------
# the autograd op
# ---------------------------------------------------------------------------


class HGTAttention(torch.autograd.Function):
    """The forward kernel, then B1 and B2 (their plain versions for CPU
    tensors, or on any device when the forward ran inside
    `reference_versions()`). kv comes in f32 and is rounded to `rows_dtype`
    here, so its gradient passes the rounding unchanged."""

    @staticmethod
    def forward(ctx, q, kv, p, graph, scale, rows_dtype, layer):
        plain = reference_active()
        meta = dict(layer=layer, heads=q.shape[1], edges=list(graph.rel_edges), kind="hgt")
        with tracing.span("attn.forward", device=q.device, **meta):
            q, p = q.contiguous(), p.contiguous()
            rows = kv.to(rows_dtype).contiguous()
            out, lse = (hgt_fwd_plain if plain else hgt_fwd)(q, rows, p, graph, scale)
        ctx.save_for_backward(q, rows, p, out, lse)
        ctx.graph, ctx.scale, ctx.plain, ctx.meta = graph, scale, plain, meta
        return out

    @staticmethod
    def backward(ctx, g):
        q, rows, p, out, lse = ctx.saved_tensors
        with tracing.span("attn.backward", device=q.device, **ctx.meta):
            bwd_dst = hgt_bwd_dst_plain if ctx.plain else hgt_bwd_dst
            bwd_src = hgt_bwd_src_plain if ctx.plain else hgt_bwd_src
            g = g.contiguous()
            dq, dp, edge = bwd_dst(q, rows, p, g, out, lse, ctx.graph, ctx.scale)
            dkv = bwd_src(q, g, edge, ctx.graph)
        return dq, dkv, dp, None, None, None, None


def kernel_width(heads: int, d: int) -> int:
    """The D the kernels run `heads` heads of width `d` at: the smallest
    power of two >= max(d, 8) with heads * D >= 256."""
    w = max(8, 1 << (d - 1).bit_length())
    while heads * w < WIDTHS[0]:
        w *= 2
    return w


def hgt_attention(q: torch.Tensor, kv: torch.Tensor, p: torch.Tensor, graph: HeteroGraph,
                  rows_dtype: torch.dtype = torch.bfloat16, layer: int = 0) -> torch.Tensor:
    """Differentiable HGT attention: q [N, H, D], kv [S, 2, H, D] f32 (K' and
    V' of the stacked table), p [3, H] -> [N, H, D]. On the card D is
    zero-padded to `kernel_width`."""
    heads, d = q.shape[1], q.shape[2]
    scale = 1.0 / math.sqrt(d)
    width = d if q.is_cpu else kernel_width(heads, d)
    if width != d:
        pad = (0, width - d)
        q, kv = torch.nn.functional.pad(q, pad), torch.nn.functional.pad(kv, pad)
    out = HGTAttention.apply(q, kv, p, graph, scale, rows_dtype, int(layer))
    return out[..., :d] if width != d else out
