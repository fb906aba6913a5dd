"""Attention dispatch: the counterpart of the JAX package's
`segment_softmax_attention_pallas` (`gat_kernel.py:230-292`), and its legacy
contracts `_attention_v1` / `_attention_v2` with their kernels:
  v1 reduce   `_reduce_kernel`       -> `csrc/spmm_csr.cu`, pre-gathered rows
                                        (`fused_segment_reduce`, kernel 13)
  v2 layer    `_fused_layer_kernel`  -> `csrc/gat_fwd.cu` with an explicit
                                        mask (`fused_layer`, kernel 14)
and v1's unweighted reduce at heads > 1, `gat_fused.segment_sum_rows`
(kernel 15). Each keeps a launch counter of its own.

A graph marked by `with_tiling()` takes the legacy contracts, as a JAX graph
with chunk tiling and no aligned layout does:
  1 head, D % 128 == 0  v2: kernel 1's forward at bf16 rows with the mask as
                        an explicit stream (column strips above 512);
  otherwise             v1: alpha in plain ops, source rows gathered in f32;
                        kernel 13 sums alpha * rows at 1 head; above, rows
                        are pre-scaled per head and kernel 15 sums them.
Both backwards are the autograd of the golden at f32 rows with the same
mask, as JAX's `custom_vjp` takes `jax.vjp` of its XLA golden. Dropout is a
Bernoulli keep mask [E, H] on alpha (the golden's), drawn once per call from
a `torch.Generator` seeded by the layer's seed (one generator per head,
seeded by that head's seed, above 8 heads); forward and backward share it.

Any other graph runs the one fused op `gat_fused.Attention` (kernel 1 or
8 forward, kernel 2 or 9 and B2 a head backward), in passes of a group of
heads:
  route         pass                  D zero-padded to
  1 head        the head              a multiple of 32 (the kernels run
                                      rows wider than 512 in column strips)
  2 to 8 heads  all heads, packed     a power of two >= 32
  too wide      each head alone       a multiple of 32
  above 8       each head alone, with its own seed
"Too wide" is 2 to 8 heads whose padded width times the heads exceeds what
the packed kernels hold (1,024). A pass over heads k.. masks head k with
the ids + k * 2**27, so a too-wide H computes the packed op's function. Zero
columns add nothing to the logits and are sliced off afterwards, as the JAX
dispatch pads D to the TPU's 128 lanes.

Dropout seeds: one uint32 `seed` for up to 8 heads; above 8 heads one seed
per head (a sequence), which the JAX package derives as
`bits(fold_in(rng, head))` and the port's `GATModel.dropout_seeds` draws
from the trainer's generator.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.nn.functional as F

from plotpointe_tpu_torch import reference_active
from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops import cuda_build as cb
from plotpointe_tpu_torch.ops.gat_fused import (
    HEAD_ID_STRIDE, MAX_PACKED_HEADS, MAX_PACKED_WIDTH, _check, _fwd, _one_head,
    attention_fwd_plain, attention_v3, attention_v3_mh, segment_sum_rows, segment_sum_rows_plain)
from plotpointe_tpu_torch.ops.segment import (
    attention_weights, bernoulli_mask, resolve_attn_impl, segment_softmax_attention)
from plotpointe_tpu_torch.ops.spmm_kernel import spmm_gathered, spmm_gathered_plain

FUSED_REDUCE_LAUNCHES = cb.COUNTERS["fused_segment_reduce"]
FUSED_LAYER_LAUNCHES = cb.COUNTERS["fused_layer"]
Seed = Optional[Union[int, Sequence[int]]]


def resolve_hs_dtype(impl: str, device) -> torch.dtype:
    """The row type an `attn_impl` (or LightGCN `spmm_impl`) value means on
    `device`: `pallas`, and `auto` on CUDA, round gathered rows to bf16 (the
    JAX trainer's kernel path); `xla`, and `auto` on the CPU, keep them f32
    (the JAX golden's function). There is no separate golden path on the
    card."""
    if impl not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown impl {impl!r} (expected auto|xla|pallas)")
    return torch.bfloat16 if resolve_attn_impl(impl, device) == "pallas" else torch.float32


def _pad_width(h, a_src, a_dst, width):
    pad = width - h.shape[-1]
    if not pad:
        return h, a_src, a_dst
    return F.pad(h, (0, pad)), F.pad(a_src, (0, pad)), F.pad(a_dst, (0, pad))


def segment_softmax_attention_kernel(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                                     graph: Graph, dropout_rate: float = 0.0, seed: Seed = None,
                                     hs_dtype: torch.dtype = torch.bfloat16,
                                     id_offset: int = 0) -> torch.Tensor:
    """h [N, H, D], a_src/a_dst [H, D] -> [N, H, D]. hs_dtype: the type the
    kernels round source rows to (the legacy contracts fix their own: v2
    bf16, v1 f32). dropout_rate and a uint32 seed (one per head above 8
    heads) draw the hash masks over canonical edge ids + `id_offset` (a
    shard's local graph passes the canonical id of its first edge), or on a
    tiled graph the Bernoulli mask."""
    heads, d = h.shape[1], h.shape[2]
    if graph.tiling is not None:
        if id_offset:
            raise ValueError("a tiled graph draws the Bernoulli mask: it takes no id offset")
        mask = legacy_mask(graph, heads, dropout_rate, seed, h.device)
        if heads == 1 and d % 128 == 0:
            return attention_v2(h, a_src, a_dst, graph, mask)
        return attention_v1(h, a_src, a_dst, graph, mask)
    if heads > MAX_PACKED_HEADS:
        seeds = [None] * heads
        if dropout_rate > 0.0 and seed is not None:
            if isinstance(seed, int) or len(seed) != heads:
                raise ValueError(f"{heads} heads (> {MAX_PACKED_HEADS}) take one dropout seed per head")
            seeds = list(seed)
        return torch.cat([segment_softmax_attention_kernel(
            h[:, k:k + 1], a_src[k:k + 1], a_dst[k:k + 1], graph, dropout_rate, seeds[k], hs_dtype,
            id_offset) for k in range(heads)], dim=1)
    packed = max(32, 1 << (d - 1).bit_length())
    if heads > 1 and heads * packed <= MAX_PACKED_WIDTH:
        op, width, one_pass = attention_v3_mh, packed, True  # all heads in one pass
    else:
        op, width, one_pass = attention_v3, -(-d // 32) * 32, heads == 1  # a pass a head
    hp, sp, dp = _pad_width(h, a_src, a_dst, width)
    # one pass takes the whole tensors: a slice of a_src would add a fill and a copy to the backward
    passes = [(0, hp, sp, dp)] if one_pass else [(k, hp[:, k:k + 1], sp[k:k + 1], dp[k:k + 1])
                                                 for k in range(heads)]
    outs = [op(x, s, t, graph, dropout_rate=dropout_rate, seed=seed, hs_dtype=hs_dtype,
               id_offset=id_offset + k * HEAD_ID_STRIDE) for k, x, s, t in passes]
    out = outs[0] if one_pass else torch.cat(outs, dim=1)
    return out[..., :d] if width != d else out


# ---------------------------------------------------------------------------
# legacy contracts (graphs marked by `with_tiling()`)
# ---------------------------------------------------------------------------


def legacy_mask(graph: Graph, heads: int, rate: float, seed: Seed, device) -> Optional[torch.Tensor]:
    """The legacy contracts' [E, heads] Bernoulli dropout mask, or None
    without dropout: one generator seeded by `seed`, or with a sequence of
    per-head seeds one generator per head."""
    if rate <= 0.0 or seed is None:
        return None

    def draw(s, k):
        return bernoulli_mask(graph.n_edges, k, rate, torch.Generator(device=device).manual_seed(int(s)))

    if isinstance(seed, int):
        return draw(seed, heads)
    if len(seed) != heads:
        raise ValueError(f"{heads} heads take one dropout seed or one per head; got {len(seed)}")
    return torch.cat([draw(s, 1) for s in seed], dim=1)


def fused_segment_reduce_plain(w: torch.Tensor, hs: torch.Tensor, graph: Graph) -> torch.Tensor:
    """[N, W] f32: out_d = sum over d's in-edges e of w_e * hs_e."""
    return spmm_gathered_plain(hs, w, graph.row_ptr)


def fused_segment_reduce(w: torch.Tensor, hs: torch.Tensor, graph: Graph) -> torch.Tensor:
    """Kernel 13, `_fused_segment_reduce`'s function: out_d = sum over the
    edges e into d of w_e * hs_e, with w [E] f32 and hs [E, W] f32 rows
    gathered per edge, both in canonical (dst, src) order -> [N, W] f32. JAX
    walks `chunk_base` tiles of the padded edge array; the port walks each
    destination's CSR row. Launches `csrc/spmm_csr.cu` in its pre-gathered
    mode (column strips of <= 512) for CUDA tensors, counted on
    `FUSED_REDUCE_LAUNCHES`; runs the plain version for CPU tensors."""
    if hs.dim() != 2 or hs.shape[0] != graph.n_edges:
        raise ValueError(f"hs must be [{graph.n_edges}, W]; got {tuple(hs.shape)}")
    return spmm_gathered(hs, w, graph.row_ptr, FUSED_REDUCE_LAUNCHES)


def fused_layer_plain(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 14's function: kernel 1's forward at bf16 source rows with
    the explicit mask [E] (None: ones) -> out [N, 1, D] f32."""
    return attention_fwd_plain(h, a_src, a_dst, graph, mask, torch.bfloat16)[0]


def fused_layer(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel 14, `_fused_layer`'s function: gs from bf16 rows, gd from the
    f32 rows, den unmasked, out = sum mask * num * hs / (den + 1e-9). h
    [N, 1, D] f32 (D a multiple of 32), a_src/a_dst [1, D], mask [E]
    f32 or None -> out [N, 1, D] f32. Launches `csrc/gat_fwd.cu` for CUDA
    tensors, counted on `FUSED_LAYER_LAUNCHES`; runs the plain version for
    CPU tensors."""
    m = _one_head("fused_layer", h, mask)
    _check(h, a_src, a_dst, graph, m, torch.bfloat16)
    if h.is_cpu:
        return fused_layer_plain(h, a_src, a_dst, graph, mask)
    return _fwd(h, a_src, a_dst, graph, m, torch.bfloat16, FUSED_LAYER_LAUNCHES)[0]


def _v1_forward(h, a_src, a_dst, graph, mask, plain):
    n, heads, d = h.shape
    alpha = attention_weights(h, a_src, a_dst, graph, mask)  # [E, H]
    hs = h[graph.src.long()]  # [E, H, D] f32, gathered before the reduce
    if heads == 1:
        reduce = fused_segment_reduce_plain if plain else fused_segment_reduce
        out = reduce(alpha[:, 0].contiguous(), hs.reshape(-1, d), graph)
    else:  # per-head weights folded into the rows, unit weights in the reduce
        reduce = segment_sum_rows_plain if plain else segment_sum_rows
        out = reduce((hs * alpha[..., None]).reshape(-1, heads * d), graph)
    return out.view(n, heads, d)


def _v2_forward(h, a_src, a_dst, graph, mask, plain):
    m = None if mask is None else mask[:, 0].contiguous()
    return (fused_layer_plain if plain else fused_layer)(h, a_src, a_dst, graph, m)


class _Legacy(torch.autograd.Function):
    """A legacy contract's forward (kernels, or their plain versions for CPU
    tensors and inside `reference_versions()`), with the golden's autograd
    at f32 rows and the same mask as its backward."""

    @staticmethod
    def forward(ctx, h, a_src, a_dst, graph, mask, forward_fn):
        out = forward_fn(h, a_src, a_dst, graph, mask, reference_active())
        ctx.save_for_backward(h, a_src, a_dst, mask)
        ctx.graph = graph
        return out

    @staticmethod
    def backward(ctx, g):
        h, a_src, a_dst, mask = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in (h, a_src, a_dst)]
            out = segment_softmax_attention(*xs, ctx.graph, mask=mask)
            grads = torch.autograd.grad(out, xs, g)
        return (*grads, None, None, None)


def attention_v1(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX `_attention_v1`: h [N, H, D] f32, a_src/a_dst [H, D], mask [E, H]
    (keep-scaled, on alpha) or None -> [N, H, D]; differentiable."""
    return _Legacy.apply(h, a_src, a_dst, graph, mask, _v1_forward)


def attention_v2(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """JAX `_attention_v2`: 1 head, h [N, 1, D] f32, mask [E, 1] or None ->
    [N, 1, D]; differentiable. The forward rounds source rows to bf16."""
    if h.shape[1] != 1:
        raise ValueError(f"attention_v2 is single-head; got heads={h.shape[1]}")
    return _Legacy.apply(h, a_src, a_dst, graph, mask, _v2_forward)
