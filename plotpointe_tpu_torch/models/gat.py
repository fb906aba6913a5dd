"""GAT recommender tower: a learned user table plus an item feature
projection into one node space, then L stacked segment-softmax attention
layers.

Counterpart of `plotpointe_tpu/models/gat.py::GATModel`. Parameters keep the
JAX layouts and names, so `state_dict()` keys are the JAX checkpoint's
key-paths with dots (`['layers'][0]['a_src']` <-> `layers.0.a_src`):
`user_emb [U, H]`, `item_proj.w [F, H]`, `item_proj.b [H]`,
`layers.l.w [H, heads, D]`, `layers.l.a_src / a_dst [heads, D]`, and
`layers.l.b [D]` with `use_bias`.

`hs_dtype` is the type attention rounds source rows to: float32 is the
function the JAX export computes; bfloat16 is what the JAX trainer's kernel
path computes (`attention_v3`'s default).

Dropout seeds (`dropout_seeds`): the model draws one uint32 a layer for a
step, as the attention op masks all of a layer's heads from one seed. Above
the op's packed limit (8 heads) a layer runs one pass a head, and the model
draws one seed a head a layer.

`attention="gatv2"` (port-only) swaps each layer for GATv2 (Brody et al.
2022; PyG's `GATv2Conv` with `concat=False`, `add_self_loops=False`,
`share_weights=False`, no bias): `layers.l.w_l`, `layers.l.w_r [H, heads,
D]` and `layers.l.a [heads, D]`, the logit a . LeakyReLU(x_j W_l + x_i W_r)
per edge j -> i (`ops/gatv2.py`), then the head-mean. `config_dict` records
`attention`; a config without it is the original GAT.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from plotpointe_tpu_torch.graphs.csr import Graph
from plotpointe_tpu_torch.ops.gat_fused import MAX_PACKED_HEADS
from plotpointe_tpu_torch.ops.gat_kernel import segment_softmax_attention_kernel
from plotpointe_tpu_torch.ops.gatv2 import gatv2_attention

ATTENTIONS = ("gat", "gatv2")


class ItemProjection(nn.Module):
    def __init__(self, feat_dim: int, hidden: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(feat_dim, hidden))
        self.b = nn.Parameter(torch.zeros(hidden))

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        return feats @ self.w + self.b


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (2.0 * u - 1.0) * bound


class GATLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, use_bias: bool):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(hidden, heads, hidden))
        self.a_src = nn.Parameter(torch.zeros(heads, hidden))
        self.a_dst = nn.Parameter(torch.zeros(heads, hidden))
        self.b = nn.Parameter(torch.zeros(hidden)) if use_bias else None

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """xavier-uniform w, a_src and a_dst, in that order; a zero bias."""
        h, d = self.w.shape[0], self.w.shape[2]
        self.w.copy_(_uniform(self.w.shape, math.sqrt(6.0 / (h + d)), generator))
        self.a_src.copy_(_uniform(self.a_src.shape, math.sqrt(6.0 / (1 + d)), generator))
        self.a_dst.copy_(_uniform(self.a_dst.shape, math.sqrt(6.0 / (1 + d)), generator))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x: torch.Tensor, graph: Graph, drop: float, seed, hs_dtype: torch.dtype,
                li: int) -> torch.Tensor:
        h = torch.einsum("nf,fhd->nhd", x, self.w)  # [N, heads, D]
        out = segment_softmax_attention_kernel(h, self.a_src, self.a_dst, graph, dropout_rate=drop,
                                               seed=seed, hs_dtype=hs_dtype)
        x = out.mean(dim=1)  # head-mean; identity for heads == 1
        return x if self.b is None else x + self.b


class GATv2Layer(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        self.w_l = nn.Parameter(torch.zeros(hidden, heads, hidden))
        self.w_r = nn.Parameter(torch.zeros(hidden, heads, hidden))
        self.a = nn.Parameter(torch.zeros(heads, hidden))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """xavier-uniform w_l, w_r and a, in that order, at the GAT's
        bounds (not GATv2Conv's glorot over heads x D)."""
        h, d = self.w_l.shape[0], self.w_l.shape[2]
        for w in (self.w_l, self.w_r):
            w.copy_(_uniform(w.shape, math.sqrt(6.0 / (h + d)), generator))
        self.a.copy_(_uniform(self.a.shape, math.sqrt(6.0 / (1 + d)), generator))

    def forward(self, x: torch.Tensor, graph: Graph, drop: float, seed, hs_dtype: torch.dtype,
                li: int) -> torch.Tensor:
        xl = torch.einsum("nf,fhd->nhd", x, self.w_l)
        xr = torch.einsum("nf,fhd->nhd", x, self.w_r)
        return gatv2_attention(xl, xr, self.a, graph, dropout_rate=drop, seed=seed, hs_dtype=hs_dtype,
                               layer=li).mean(dim=1)


class GATModel(nn.Module):
    """Full-graph GAT forward -> node embeddings [n_nodes, hidden]."""

    def __init__(self, n_users: int, n_items: int, feat_dim: int, hidden_dim: int = 128,
                 n_layers: int = 2, heads: int = 1, attn_dropout: float = 0.1,
                 use_bias: bool = False, hs_dtype: torch.dtype = torch.float32,
                 attention: str = "gat"):
        super().__init__()
        if attention not in ATTENTIONS:
            raise ValueError(f"unknown attention {attention!r} (expected gat|gatv2)")
        if attention == "gatv2" and (use_bias or not 1 <= heads <= 8):
            raise ValueError(f"GATv2 takes 1 to 8 heads and no bias; got heads={heads}, "
                             f"use_bias={use_bias}")
        self.n_users, self.n_items, self.feat_dim = n_users, n_items, feat_dim
        self.hidden_dim, self.n_layers, self.heads = hidden_dim, n_layers, heads
        self.attn_dropout, self.use_bias, self.hs_dtype = attn_dropout, use_bias, hs_dtype
        self.attention = attention
        self.user_emb = nn.Parameter(torch.zeros(n_users, hidden_dim))
        self.item_proj = ItemProjection(feat_dim, hidden_dim)
        self.layers = nn.ModuleList(
            GATv2Layer(hidden_dim, heads) if attention == "gatv2" else GATLayer(hidden_dim, heads, use_bias)
            for _ in range(n_layers))

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The JAX package's init distributions: user_emb N(0, 0.1),
        item_proj.w U(+-1/sqrt(F)), xavier-uniform layer w, a_src and a_dst,
        zero biases; GATv2: xavier-uniform w_l, w_r and a, in that order,
        layer by layer. Draws on the generator's device."""
        self.user_emb.copy_(0.1 * torch.randn(self.user_emb.shape, generator=generator,
                                              device=generator.device))
        self.item_proj.w.copy_(_uniform(self.item_proj.w.shape, 1.0 / math.sqrt(self.feat_dim),
                                        generator))
        self.item_proj.b.zero_()
        for layer in self.layers:
            layer.init_(generator)

    def node_features(self, item_feats: torch.Tensor) -> torch.Tensor:
        """concat([user_emb, item_proj(item_feats)]) -> [n_nodes, hidden]."""
        return torch.cat([self.user_emb, self.item_proj(item_feats)], dim=0)

    def dropout_seeds(self, generator: torch.Generator) -> Optional[list]:
        """One training step's uint32 attention-dropout seeds, drawn from
        `generator`: one a layer, or [layers][heads] above 8 heads; None
        without dropout."""
        if self.attn_dropout <= 0:
            return None
        shape = (self.n_layers, self.heads) if self.heads > MAX_PACKED_HEADS else (self.n_layers,)
        return torch.randint(0, 1 << 32, shape, generator=generator, device=generator.device,
                             dtype=torch.int64).tolist()

    def forward(self, item_feats: torch.Tensor, graph: Graph, train: bool = False,
                seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """train=True applies attention dropout `attn_dropout`, with the
        seeds of `dropout_seeds`."""
        drop = self.attn_dropout if train else 0.0
        x = self.node_features(item_feats)
        for li, layer in enumerate(self.layers):
            seed = seeds[li] if (seeds is not None and drop > 0) else None
            x = layer(x, graph, drop, seed, self.hs_dtype, li)
        return x

    def config_dict(self) -> Dict[str, Any]:
        return {
            "model_family": "gat",
            "n_users": self.n_users,
            "n_items": self.n_items,
            "feat_dim": self.feat_dim,
            "hidden_dim": self.hidden_dim,
            "n_layers": self.n_layers,
            "heads": self.heads,
            "attn_dropout": self.attn_dropout,
            "use_bias": self.use_bias,
            "attention": self.attention,
        }

    @staticmethod
    def from_config(d: Dict[str, Any]) -> "GATModel":
        return GATModel(
            n_users=int(d["n_users"]),
            n_items=int(d["n_items"]),
            feat_dim=int(d["feat_dim"]),
            hidden_dim=int(d.get("hidden_dim", 128)),
            n_layers=int(d.get("n_layers", 2)),
            heads=int(d.get("heads", 1)),
            attn_dropout=float(d.get("attn_dropout", 0.1)),
            use_bias=bool(d.get("use_bias", False)),
            attention=str(d.get("attention", "gat")),
        )
