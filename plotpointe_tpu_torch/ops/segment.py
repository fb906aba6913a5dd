"""Segment ops over the dst-sorted edge layout: the plain PyTorch golden.

Counterpart of `plotpointe_tpu/ops/segment.py` (`segment_softmax_attention`
and `spmm`, LightGCN's propagation). Attention keeps its exact math:
LeakyReLU 0.2, logits clamped to +-10 with NO segment max-subtraction,
softmax denominator eps 1e-9. Any number of heads. Dropout, as in the
JAX golden, is a keep-scaled [E, H] multiplier on alpha after
normalisation (`bernoulli_mask` draws one).

Every sum of the attention golden runs in a fixed order, so its forward
and its autograd give the same bits on every run, as the JAX reference
does: `index_sum_rows` (a stable sort by index, then one segment sum per
index, each in row order) takes the place of `index_add_`, which adds by
float atomics on CUDA, and `gather_rows` (a row gather whose backward is
`index_sum_rows`) the place of `x[idx]`, whose autograd accumulates
duplicate rows in an order that changes from run to run on CUDA, and on
the CPU too. On the CPU `index_sum_rows` gives `index_add_`'s bits.
"""
from __future__ import annotations

from typing import Optional

import torch

from plotpointe_tpu_torch.graphs.csr import Graph

LEAKY_SLOPE = 0.2
LOGIT_CLAMP = 10.0
EPS = 1e-9


def edge_numerators(gs: torch.Tensor, gd: torch.Tensor, graph: Graph) -> torch.Tensor:
    """exp(clamp(lrelu(gs[src] + gd[dst]))) per edge from per-node logit terms."""
    e = gather_rows(gs, graph.src) + gather_rows(gd, graph.dst)
    e = torch.where(e > 0, e, LEAKY_SLOPE * e)
    return torch.exp(torch.clamp(e, -LOGIT_CLAMP, LOGIT_CLAMP))


def bernoulli_mask(n_edges: int, heads: int, rate: float,
                   generator: torch.Generator) -> torch.Tensor:
    """[n_edges, heads] f32 dropout multiplier: 1 / (1 - rate) where a
    uniform draw from `generator` (on its device) is below 1 - rate, else
    0. The JAX golden draws `bernoulli(rng, 1 - rate, [E, H])`; the draws
    differ, so tests hand JAX's keep to both."""
    keep = torch.rand((n_edges, heads), generator=generator, device=generator.device) < 1.0 - rate
    return keep.to(torch.float32) * (1.0 / (1.0 - rate))


def segment_softmax_attention(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                              graph: Graph, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h [N, H, D], a_src/a_dst [H, D] -> [N, H, D]: per edge s -> d and head,
    alpha = exp(e) / sum_{s' -> d} exp(e'), out[d] = sum alpha * h[s]. mask
    [E, H] (or None) multiplies alpha after normalisation."""
    alpha = attention_weights(h, a_src, a_dst, graph, mask)
    return index_sum_rows(alpha[..., None] * gather_rows(h, graph.src), graph.dst, graph.n_nodes)


def attention_weights(h: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor, graph: Graph,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """alpha [E, H] of `segment_softmax_attention`, times `mask` if given."""
    gs = torch.einsum("nhd,hd->nh", h, a_src)
    gd = torch.einsum("nhd,hd->nh", h, a_dst)
    num = edge_numerators(gs, gd, graph)  # [E, H]
    den = index_sum_rows(num, graph.dst, graph.n_nodes)
    alpha = num / (gather_rows(den, graph.dst) + EPS)
    return alpha if mask is None else alpha * mask


def spmm(graph: Graph, values: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[d] = sum over edges s -> d of values_e * x[s]; x [N, F] -> [N, F], f32
    sums. `values` [E] in canonical (dst, src) order."""
    msg = values[:, None] * x[graph.src.long()]
    return torch.zeros(x.shape, dtype=msg.dtype, device=x.device).index_add_(0, graph.dst.long(), msg)


def index_sum_rows(rows: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """out[k] = sum of rows[t] over t with idx[t] == k, out [n, ...], summed
    in a fixed order: a stable sort by index, then one segment sum per
    index. Differentiable."""
    order = torch.argsort(idx, stable=True)
    uniq, counts = torch.unique_consecutive(idx[order], return_counts=True)
    sums = torch.segment_reduce(rows[order], "sum", lengths=counts, axis=0)
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    out[uniq.long()] = sums  # distinct indices: no accumulation
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return index_sum_rows(g, idx, ctx.n), None


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along dim 0, with a deterministic backward (`index_sum_rows`)."""
    return _GatherRows.apply(x, idx.long())
