"""GATv2 attention (Brody, Alon and Yahav 2022, "How Attentive are Graph
Attention Networks?"): the dynamic logit, forward and backward, as CUDA
kernels, their plain versions and the autograd op.

Port-only: the JAX package runs the original GAT alone. Per head k, with
xl = x W_l and xr = x W_r ([N, H, D] f32) and each edge s -> d (canonical
id e, the destination CSR's order):
  z_e     = rl_s + xr_d             rl: xl rounded to the row type
  score_e = a_k . lrelu(z_e, 0.2)   D-wide per edge: no per-node terms
  num_e   = exp(clamp(score_e, -10, 10))
  den_d   = sum num_e               (unmasked)
  out_d   = sum m_e num_e rl_s / (den_d + 1e-9)
with the port's GAT conventions: the clamp instead of a running maximum,
den + 1e-9, and m_e the hash dropout of `gat_fused.dropout_mask_mh` (head k
over canonical ids + k * 2**27, one seed a layer). The backward, g the
cotangent of out:
  dnum_e  = (m_e g_d . rl_s - g_d . out_d) / (den_d + 1e-9)
  ds_e    = dnum_e num_e 1[-10 < score_e < 10]
  al_e    = m_e num_e / (den_d + 1e-9)
  dxr_d   = a * sum_e ds_e lrelu'(z_e)           (lrelu' = 1 where z > 0, else 0.2)
  da      = sum_e ds_e lrelu(z_e)
  dxl_s   = sum_e al_e g_d + ds_e lrelu'(z_e) * a
The gradient passes the rounding of xl unchanged (straight through); g
stays f32 (GAT's B2 rounds it to the row type; here nothing but the rows is
rounded). Rows are bf16 for training (`attn_impl` pallas, and auto on CUDA)
and f32 for the export.

Kernels (`csrc/gatv2_*.cu`, on `walk.cuh`'s piece/unit plan, no atomics,
the same bits on every run):
  forward  `gatv2_fwd.cu`      a destination-order walk: out, den
  B1       `gatv2_bwd_dst.cu`  a destination-order walk: dxr, the blocks'
                               partial rows of da, per edge (al, ds) [E, H, 2]
                               and the signs of z, packed (`pack_signs`)
  B2       `gatv2_bwd_src.cu`  a source-order walk over the transpose CSR: dxl
The kernels draw the dropout multipliers themselves from the seed (the
hash of `gat_fused.hash_mask`, bit for bit). They take 1 to 8 heads, D a
power of two >= 32 and H * D <= 1,024; `gatv2_attention` pads D with zero
columns to such a width (exact: a zero column adds nothing to a logit) and
runs heads in groups that fit. Each `*_plain` function is the same function
in plain PyTorch: it runs for CPU tensors and inside `reference_versions()`,
and the card tests hold each kernel to it. Each launch counts on its own
counter.

The op's forward and backward are the spans `attn.forward` and
`attn.backward` (device intervals; layer, heads, kind "gatv2").
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from plotpointe_tpu_torch import reference_active
from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops import cuda_build as cb
from plotpointe_tpu_torch.ops.gat_fused import HEAD_ID_STRIDE, dropout_mask_mh
from plotpointe_tpu_torch.ops.segment import EPS, LEAKY_SLOPE, LOGIT_CLAMP
from plotpointe_tpu_torch.ops.spmm_kernel import WALK_UNITS, cached_walk
from plotpointe_tpu_torch.utils import tracing

FWD_LAUNCHES = cb.COUNTERS["gatv2_fwd"]
BWD_DST_LAUNCHES = cb.COUNTERS["gatv2_bwd_dst"]
BWD_SRC_LAUNCHES = cb.COUNTERS["gatv2_bwd_src"]
MAX_HEADS = 8
MAX_WIDTH = 1024  # H * D a kernel's row holds


def vec_of(dtype: torch.dtype) -> int:
    """Values of the row type in one 16-byte chunk: a byte of `signs`."""
    return 8 if dtype == torch.bfloat16 else 4


def pack_signs(pos: torch.Tensor, vec: int) -> torch.Tensor:
    """[E, H, D] bool (z > 0) -> [E, H * D / vec] uint8: bit k of byte j
    is value j * vec + k of the row."""
    e = pos.shape[0]
    bits = pos.reshape(e, -1, vec).to(torch.int32) << torch.arange(vec, device=pos.device, dtype=torch.int32)
    return bits.sum(-1).to(torch.uint8)


def unpack_signs(signs: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    """`pack_signs`' inverse: [E, H * D / vec] uint8 -> [E, H, D] bool."""
    vec = heads * d // signs.shape[1]
    k = torch.arange(vec, device=signs.device, dtype=torch.int32)
    return ((signs.to(torch.int32)[:, :, None] >> k) & 1).bool().reshape(signs.shape[0], heads, d)


def _edges(graph: Graph):
    return graph.src.long(), graph.dst.long()


def _logits(rl: torch.Tensor, xr: torch.Tensor, a: torch.Tensor, graph: Graph):
    """Per edge: z [E, H, D], score [E, H] and num [E, H]."""
    src, dst = _edges(graph)
    z = rl.float()[src] + xr[dst]
    score = (torch.where(z > 0, z, LEAKY_SLOPE * z) * a).sum(-1)
    return z, score, torch.exp(torch.clamp(score, -LOGIT_CLAMP, LOGIT_CLAMP))


def _mask(graph: Graph, rate: float, seed: Optional[int], heads: int, device, id_offset: int):
    """[E, H] dropout multipliers, or None."""
    m = dropout_mask_mh(graph, rate, seed, heads, device, id_offset)
    return None if m is None else m.T


def gatv2_fwd_plain(rl: torch.Tensor, xr: torch.Tensor, a: torch.Tensor, graph: Graph,
                    rate: float = 0.0, seed: Optional[int] = None,
                    id_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """rl [N, H, D] at the row type, xr [N, H, D] f32, a [H, D] -> (out
    [N, H, D], den [N, H]); the dropout of `rate` and `seed` over canonical
    ids + `id_offset`."""
    n, heads, d = rl.shape
    _, _, num = _logits(rl, xr, a, graph)
    src, dst = _edges(graph)
    m = _mask(graph, rate, seed, heads, rl.device, id_offset)
    den = torch.zeros((n, heads), dtype=torch.float32, device=rl.device).index_add_(0, dst, num)
    w = num if m is None else num * m
    acc = torch.zeros((n, heads, d), dtype=torch.float32, device=rl.device)
    acc.index_add_(0, dst, w[:, :, None] * rl.float()[src])
    return acc / (den[:, :, None] + EPS), den


def gatv2_bwd_dst_plain(rl, xr, a, g, out, den, graph: Graph, rate: float = 0.0,
                        seed: Optional[int] = None, id_offset: int = 0):
    """B1's function: (dxr [N, H, D], da [H, D], edge [E, H, 2] = (al, ds),
    signs [E, H * D / vec] uint8)."""
    n, heads, d = rl.shape
    src, dst = _edges(graph)
    z, score, num = _logits(rl, xr, a, graph)
    m = _mask(graph, rate, seed, heads, rl.device, id_offset)
    m = torch.ones_like(num) if m is None else m
    ghs = (g[dst] * rl.float()[src]).sum(-1)
    godot = (g * out).sum(-1)
    den_e = den[dst] + EPS
    inside = (score > -LOGIT_CLAMP) & (score < LOGIT_CLAMP)
    ds = torch.where(inside, (m * ghs - godot[dst]) / den_e * num, torch.zeros_like(num))
    pos = z > 0
    slope = torch.where(pos, ds[:, :, None], LEAKY_SLOPE * ds[:, :, None])
    dxr = a * torch.zeros((n, heads, d), dtype=torch.float32, device=rl.device).index_add_(0, dst, slope)
    da = (ds[:, :, None] * torch.where(pos, z, LEAKY_SLOPE * z)).sum(0)
    edge = torch.stack([m * num / den_e, ds], -1)
    return dxr, da, edge, pack_signs(pos, vec_of(rl.dtype))


def gatv2_bwd_src_plain(g: torch.Tensor, a: torch.Tensor, edge: torch.Tensor, signs: torch.Tensor,
                        graph: Graph) -> torch.Tensor:
    """B2's function: g [N, H, D] f32, a [H, D], edge and signs as B1 gives
    them -> dxl [N, H, D] f32."""
    n, heads, d = g.shape
    src, dst = _edges(graph)
    pos = unpack_signs(signs, heads, d)
    al, ds = edge[:, :, 0:1], edge[:, :, 1:2]
    contrib = al * g[dst] + torch.where(pos, ds, LEAKY_SLOPE * ds) * a
    return torch.zeros((n, heads, d), dtype=torch.float32, device=g.device).index_add_(0, src, contrib)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------


def check_shape(heads: int, d: int) -> None:
    if not (1 <= heads <= MAX_HEADS and 32 <= d and not d & (d - 1) and heads * d <= MAX_WIDTH):
        raise ValueError(f"the GATv2 kernels take 1 to {MAX_HEADS} heads, D a power of two >= 32 and "
                         f"heads * D <= {MAX_WIDTH}; got heads={heads}, D={d}")


def _rows(name: str, t: torch.Tensor, shape, dtypes) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype not in dtypes or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {' or '.join(map(str, dtypes))} {tuple(shape)}; "
                         f"got {t.dtype} {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start 16-byte aligned: the kernels read rows in 16-byte loads")


def _drop(rate: float, seed: Optional[int], id_offset: int) -> tuple:
    """The kernels' dropout arguments: masked, seed, threshold, scale (f32)
    and id offset, as `gat_fused.hash_mask` draws them."""
    if rate <= 0.0 or seed is None:
        return 0, 0, 0, 0.0, 0
    thresh = min(int((1.0 - rate) * 4294967296.0), 4294967295)
    scale = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    return 1, int(seed) & 0xFFFFFFFF, thresh, scale, int(id_offset)


def _plan(ptr: torch.Tensor):
    (piece_ptr, piece_out, unit_ptr, n_slots, split_rows, split_ptr, n_units, n_split), erow, most = \
        cached_walk(ptr)
    return (piece_ptr, piece_out, unit_ptr), (split_rows, split_ptr), n_slots, n_units, n_split, erow, most


def gatv2_fwd(rl: torch.Tensor, xr: torch.Tensor, a: torch.Tensor, graph: Graph, rate: float = 0.0,
              seed: Optional[int] = None, id_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """`gatv2_fwd_plain`'s function; launches `csrc/gatv2_fwd.cu` for CUDA
    tensors."""
    n, heads, d = rl.shape
    if rl.is_cpu:
        return gatv2_fwd_plain(rl, xr, a, graph, rate, seed, id_offset)
    check_shape(heads, d)
    _rows("rl", rl, (graph.n_nodes, heads, d), (torch.bfloat16, torch.float32))
    _rows("xr", xr, rl.shape, (torch.float32,))
    _rows("a", a, (heads, d), (torch.float32,))
    dev = rl.device
    plan, split, n_slots, n_units, n_split, erow, most = _plan(graph.row_ptr)
    out = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    den = torch.empty((n, heads), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_slots, heads * d), dtype=torch.float32, device=dev) if n_split else None
    scratch_den = torch.empty((n_slots, heads), dtype=torch.float32, device=dev) if n_split else None
    cb.launch("gatv2_fwd", dev, rl.data_ptr(), int(rl.dtype == torch.bfloat16), xr.data_ptr(),
              a.data_ptr(), *plan, graph.src.data_ptr(), erow.data_ptr(), out.data_ptr(),
              den.data_ptr(), cb.ptr(scratch), cb.ptr(scratch_den), *split, n, heads, d, n_units,
              n_split, most | 1, *_drop(rate, seed, id_offset))
    FWD_LAUNCHES.bump()
    return out, den


def gatv2_bwd_dst(rl, xr, a, g, out, den, graph: Graph, rate: float = 0.0,
                  seed: Optional[int] = None, id_offset: int = 0):
    """`gatv2_bwd_dst_plain`'s function; launches `csrc/gatv2_bwd_dst.cu`
    for CUDA tensors (the kernel writes one partial row of da a block,
    summed here)."""
    n, heads, d = rl.shape
    if rl.is_cpu:
        return gatv2_bwd_dst_plain(rl, xr, a, g, out, den, graph, rate, seed, id_offset)
    check_shape(heads, d)
    _rows("rl", rl, (graph.n_nodes, heads, d), (torch.bfloat16, torch.float32))
    for name, t in (("xr", xr), ("g", g), ("out", out)):
        _rows(name, t, rl.shape, (torch.float32,))
    _rows("a", a, (heads, d), (torch.float32,))
    _rows("den", den, (n, heads), (torch.float32,))
    dev = rl.device
    plan, split, n_slots, n_units, n_split, erow, most = _plan(graph.row_ptr)
    dxr = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    partial = torch.empty((-(-n_units // WALK_UNITS), heads * d), dtype=torch.float32, device=dev)
    edge = torch.empty((graph.n_edges, heads, 2), dtype=torch.float32, device=dev)
    signs = torch.empty((graph.n_edges, heads * d // vec_of(rl.dtype)), dtype=torch.uint8, device=dev)
    scratch = torch.empty((n_slots, heads * d), dtype=torch.float32, device=dev) if n_split else None
    cb.launch("gatv2_bwd_dst", dev, rl.data_ptr(), int(rl.dtype == torch.bfloat16),
              *(t.data_ptr() for t in (xr, a, g, out, den)), *plan, graph.src.data_ptr(),
              erow.data_ptr(), *(t.data_ptr() for t in (dxr, partial, edge, signs)), cb.ptr(scratch),
              *split, n, heads, d, n_units, n_split, most | 1, *_drop(rate, seed, id_offset))
    BWD_DST_LAUNCHES.bump()
    return dxr, partial.sum(0).view(heads, d), edge, signs


def gatv2_bwd_src(g: torch.Tensor, a: torch.Tensor, edge: torch.Tensor, signs: torch.Tensor,
                  graph: Graph) -> torch.Tensor:
    """`gatv2_bwd_src_plain`'s function; launches `csrc/gatv2_bwd_src.cu`
    for CUDA tensors. The signs' width (a byte per 8 values for bf16 rows,
    per 4 for f32) sets the kernel's chunks."""
    n, heads, d = g.shape
    if g.is_cpu:
        return gatv2_bwd_src_plain(g, a, edge, signs, graph)
    check_shape(heads, d)
    _rows("g", g, (graph.n_nodes, heads, d), (torch.float32,))
    _rows("a", a, (heads, d), (torch.float32,))
    _rows("edge", edge, (graph.n_edges, heads, 2), (torch.float32,))
    widths = {heads * d // 8: 8, heads * d // 4: 4}
    if signs.dtype != torch.uint8 or signs.dim() != 2 or signs.shape[0] != graph.n_edges \
            or signs.shape[1] not in widths or not signs.is_contiguous():
        raise ValueError(f"signs must be contiguous uint8 [{graph.n_edges}, {heads * d} / 4 or 8]; "
                         f"got {signs.dtype} {tuple(signs.shape)}")
    vec = widths[signs.shape[1]]
    dev = g.device
    plan, split, n_slots, n_units, n_split, _, most = _plan(graph.t_ptr)
    dxl = torch.empty((n, heads, d), dtype=torch.float32, device=dev)
    scratch = torch.empty((n_slots, heads * d), dtype=torch.float32, device=dev) if n_split else None
    cb.launch("gatv2_bwd_src", dev, g.data_ptr(), int(vec == 8), a.data_ptr(),
              edge.data_ptr(), signs.data_ptr(), *plan, graph.t_dst.data_ptr(),
              graph.t_eid.data_ptr(), dxl.data_ptr(), cb.ptr(scratch), *split, n, heads, d, n_units,
              n_split, most | 1)
    BWD_SRC_LAUNCHES.bump()
    return dxl


# ---------------------------------------------------------------------------
# the autograd op
# ---------------------------------------------------------------------------


class GATv2Attention(torch.autograd.Function):
    """One group of heads: the forward kernel, then B1 and B2 (their plain
    versions for CPU tensors, or on any device when the forward ran inside
    `reference_versions()`). The dropout is drawn again from the seed in
    the backward."""

    @staticmethod
    def forward(ctx, xl, xr, a, graph, rate, seed, hs_dtype, id_offset, layer):
        plain = reference_active()
        heads = xl.shape[1]
        with tracing.span("attn.forward", device=xl.device, layer=layer, heads=heads, kind="gatv2"):
            rl = xl.to(hs_dtype).contiguous()
            xr = xr.contiguous()
            fwd = gatv2_fwd_plain if plain else gatv2_fwd
            out, den = fwd(rl, xr, a.contiguous(), graph, rate, seed, id_offset)
        ctx.save_for_backward(rl, xr, a, out, den)
        ctx.graph, ctx.rate, ctx.seed, ctx.id_offset, ctx.plain = graph, rate, seed, id_offset, plain
        ctx.layer = layer
        return out

    @staticmethod
    def backward(ctx, g):
        rl, xr, a, out, den = ctx.saved_tensors
        with tracing.span("attn.backward", device=rl.device, layer=ctx.layer, heads=rl.shape[1],
                          kind="gatv2"):
            bwd_dst = gatv2_bwd_dst_plain if ctx.plain else gatv2_bwd_dst
            bwd_src = gatv2_bwd_src_plain if ctx.plain else gatv2_bwd_src
            g = g.contiguous()
            dxr, da, edge, signs = bwd_dst(rl, xr, a.contiguous(), g, out, den, ctx.graph, ctx.rate,
                                           ctx.seed, ctx.id_offset)
            dxl = bwd_src(g, a.contiguous(), edge, signs, ctx.graph)
        return dxl, dxr, da, None, None, None, None, None, None


def gatv2_attention(xl: torch.Tensor, xr: torch.Tensor, a: torch.Tensor, graph: Graph,
                    dropout_rate: float = 0.0, seed: Optional[int] = None,
                    hs_dtype: torch.dtype = torch.bfloat16, layer: int = 0) -> torch.Tensor:
    """Differentiable GATv2 attention: xl, xr [N, H, D] f32, a [H, D] ->
    [N, H, D]. With dropout_rate > 0 and a uint32 `seed`, head k drops with
    the hash mask over canonical ids + k * 2**27. D is zero-padded to a
    power of two >= 32 and the heads run in groups of at most
    1,024 / that width (one op each, head k's ids offset as above)."""
    heads, d = xl.shape[1], xl.shape[2]
    width = max(32, 1 << (d - 1).bit_length())
    if width > MAX_WIDTH:
        raise ValueError(f"GATv2 takes D <= {MAX_WIDTH}; got D={d}")
    if width != d:
        pad = (0, width - d)
        xl, xr, a = (torch.nn.functional.pad(t, pad) for t in (xl, xr, a))
    step = min(MAX_HEADS, MAX_WIDTH // width)
    outs = [GATv2Attention.apply(xl[:, k:k + step], xr[:, k:k + step], a[k:k + step], graph,
                                 float(dropout_rate), seed, hs_dtype, k * HEAD_ID_STRIDE, int(layer))
            for k in range(0, heads, step)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, 1)
    return out[..., :d] if width != d else out
