"""HGT recommender tower (Hu, Dong, Wang and Sun 2020, "Heterogeneous Graph
Transformer", arXiv:2003.01332; the layer of PyG's `HGTConv`), port-only.

The inputs are the GAT's (`GATModel.node_features`): the learned user table
and the item features projected to the hidden width, x = [users | items]
[N, F]. Each layer, over the typed graph of `graphs/hetero.py` (node types
user and item; relations rates, rated_by, similar), with H heads of D = F /
H:
  [K | Q | V]_t = x_t W^kqv_t + b^kqv_t            per node type t, [F, 3F]
  K'_r, V'_r    = K_src(r) W^k_r,h, V_src(r) W^v_r,h  per relation and head,
                                                    [D, D], no bias
  out           = the softmax over each target's in-edges of every relation
                  of p[r, h] q . K' / sqrt(D), summing V'  (`ops/hgt.py`)
  y_t           = GELU(out_t) W^out_t + b^out_t
  x'_t          = sigmoid(skip_t) y_t + (1 - sigmoid(skip_t)) x_t
No dropout and no relative temporal encoding (PyG's `HGTConv` has neither).
K' and V' are rounded to `hs_dtype` (bf16 on the card's training path) and
gathered so by the kernels; everything else is f32. K and V serve only
through the relation transforms, so the transforms are folded into the
typed product's weights (W_k A_r, b_k A_r: one batched product a relation
over the heads, [F, D] x [D, D] each) and one product a node type gives Q
and every relation's K' and V' of its rows: users [F, 3F] (Q, rates),
items [F, 5F] (Q, rated_by, similar). The same function as (x W_k + b_k)
A_r with the products in another order; the activations never pass through
a [D, D] product, whose weight gradient (a reduction over every row into a
D x D output) runs far below the card's f32 rate. The typed products run
on `ops/dense.linear_into`, which lays their columns straight into the q and
kv tables, and the output products on `ops/dense.linear`: on the card three
TF32 tensor-core passes over a hi/lo split, f32-faithful
(`csrc/dense_3xtf32.cu`; 12 products a forward, 24 more a backward, counted
on `COUNTERS["dense_3xtf32"]`; F a multiple of 128 there, ValueError
otherwise), on the CPU `torch.addmm`, `split` and `cat`.

Parameters (`state_dict` order): `user_emb [U, F]`, `item_proj.w [feat, F]`,
`item_proj.b [F]`, and per layer l `layers.l.k_rel`, `layers.l.v_rel [3, H,
D, D]`, `layers.l.p_rel [3, H]`, `layers.l.kqv.{user,item}.w [F, 3F]` and
`.b [3F]`, `layers.l.out.{user,item}.w [F, F]` and `.b [F]`,
`layers.l.skip.{user,item} [1]`. `init_params` draws them in that order:
the user table N(0, 0.1), the projection U(+-1/sqrt(feat)) and a zero bias
(the GAT's), then every layer weight and bias U(+-1/sqrt(fan_in)) (fan_in D
for the relation transforms, F for the rest), p_rel and skip ones (PyG's
`ones`).

Spans (device intervals, meta `layer` and `pass`): `hgt.project` (the typed
K/Q/V products and the relation transforms) and `hgt.update` (GELU, the
output products and the gated skip), each in the forward and, while spans
record, in the backward too (opened when the block's output gradient
arrives, closed when its input gradient leaves).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from plotpointe_tpu_torch.graphs.hetero import RELATIONS, HeteroGraph
from plotpointe_tpu_torch.models.gat import ItemProjection, _uniform
from plotpointe_tpu_torch.ops.dense import Plan, linear, linear_into
from plotpointe_tpu_torch.ops.hgt import hgt_attention
from plotpointe_tpu_torch.utils import tracing

TYPES = ("user", "item")
TYPE_RELS = (("user", (0,)), ("item", (1, 2)))  # each node type and the relations its rows are the sources of


class _Open(torch.autograd.Function):
    """Identity on a block's outputs; its backward opens the block's
    backward span."""

    @staticmethod
    def forward(ctx, box, name, meta, *ys):
        ctx.box, ctx.name, ctx.meta = box, name, meta
        return tuple(y.view_as(y) for y in ys)

    @staticmethod
    def backward(ctx, *gs):
        ctx.box.append(tracing.span(ctx.name, device=gs[0].device, **ctx.meta))
        return (None, None, None, *gs)


class _Close(torch.autograd.Function):
    """Identity on a block's inputs; its backward closes the span `_Open`
    opened."""

    @staticmethod
    def forward(ctx, box, *xs):
        ctx.box = box
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.box:
            ctx.box.pop().end()
        return (None, *gs)


class _Block:
    """A span around a block of ops in the forward and, while spans record
    and autograd is on, around the same ops' backward."""

    def __init__(self, name: str, device, **meta):
        self.name, self.device, self.meta = name, device, meta
        self.marked = tracing.active() and torch.is_grad_enabled()
        self.box: list = []

    def inputs(self, *xs):
        return _Close.apply(self.box, *xs) if self.marked else xs

    def outputs(self, *ys):
        return _Open.apply(self.box, self.name, dict(self.meta, **{"pass": "backward"}), *ys) \
            if self.marked else ys

    def span(self):
        return tracing.span(self.name, device=self.device, **self.meta, **{"pass": "forward"})


def typed_plan(graph: HeteroGraph, f: int) -> Plan:
    """`linear_into`'s plan of a layer's typed products: the tables q [N, F]
    (node order) and kv [S, 2F] (the stacked source table); each node type's
    rows give their Q rows, then K' | V' under each relation they are the
    sources of, at that relation's first stacked row."""
    u, n = graph.n_users, graph.n_nodes
    rows = {"user": (0, u), "item": (u, n)}
    parts = tuple((*rows[t], ((0, rows[t][0]),) + tuple((1, graph.offsets[r]) for r in rels))
                  for t, rels in TYPE_RELS)
    return ((n, f), (graph.n_rows, 2 * f)), parts


class HGTLayer(nn.Module):
    def __init__(self, hidden: int, heads: int):
        super().__init__()
        d = hidden // heads
        self.heads, self.d = heads, d
        self.k_rel = nn.Parameter(torch.zeros(len(RELATIONS), heads, d, d))
        self.v_rel = nn.Parameter(torch.zeros(len(RELATIONS), heads, d, d))
        self.p_rel = nn.Parameter(torch.zeros(len(RELATIONS), heads))
        # per-type weights w [in, out] and b, as the GAT's item projection holds them
        self.kqv = nn.ModuleDict({t: ItemProjection(hidden, 3 * hidden) for t in TYPES})
        self.out = nn.ModuleDict({t: ItemProjection(hidden, hidden) for t in TYPES})
        self.skip = nn.ParameterDict()
        for t in TYPES:  # one at a time: a ParameterDict built from a dict sorts its keys
            self.skip[t] = nn.Parameter(torch.zeros(1))

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """U(+-1/sqrt(fan_in)) weights and biases, p_rel and skip ones, in
        `state_dict` order."""
        for name, t in self.named_parameters():
            if name.startswith("skip.") or name == "p_rel":
                t.fill_(1.0)
            else:
                fan_in = self.d if name in ("k_rel", "v_rel") else self.kqv["user"].w.shape[0]
                t.copy_(_uniform(t.shape, 1.0 / math.sqrt(fan_in), generator))

    def _folded(self, t: str, rels) -> tuple:
        """The node type's product weight and bias [F, (1 + 2 len(rels)) F]:
        Q's columns, then for each relation r of `rels` the K and V columns
        times the relation's transforms (W_k A_r | W_v M_r), heads kept
        apart."""
        lin, heads, d = self.kqv[t], self.heads, self.d
        f = lin.w.shape[0]
        w, b = lin.w.view(f, 3, heads, d), lin.b.view(3, heads, d)
        ws, bs = [w[:, 1].reshape(f, f)], [b[1].reshape(f)]
        for r in rels:
            for j, rel in ((0, self.k_rel[r]), (2, self.v_rel[r])):
                ws.append(torch.einsum("fhd,hde->fhe", w[:, j], rel).reshape(f, f))
                bs.append(torch.einsum("hd,hde->he", b[j], rel).reshape(f))
        return torch.cat(ws, 1), torch.cat(bs)

    def forward(self, x: torch.Tensor, graph: HeteroGraph, rows_dtype: torch.dtype, li: int) -> torch.Tensor:
        u, heads, d = graph.n_users, self.heads, self.d
        f = heads * d
        project = _Block("hgt.project", x.device, layer=li)
        with project.span():
            (xp,) = project.inputs(x)
            wbs = [wb for t, rels in TYPE_RELS for wb in self._folded(t, rels)]
            q, kv = linear_into(xp, typed_plan(graph, f), *wbs)
            q, kv = project.outputs(q.view(-1, heads, d), kv.view(-1, 2, heads, d))
        m = hgt_attention(q, kv, self.p_rel, graph, rows_dtype, layer=li)
        update = _Block("hgt.update", x.device, layer=li)
        with update.span():
            m, xs = update.inputs(m, x)
            out = []
            for t, mt, xt in zip(TYPES, (m[:u], m[u:]), (xs[:u], xs[u:])):
                lin = self.out[t]
                y = linear(torch.nn.functional.gelu(mt.reshape(mt.shape[0], -1)), lin.w, lin.b)
                a = torch.sigmoid(self.skip[t])
                out.append(a * y + (1 - a) * xt)
            (x,) = update.outputs(torch.cat(out))
        return x


class HGTModel(nn.Module):
    """Full-graph HGT forward -> node embeddings [n_nodes, hidden]."""

    def __init__(self, n_users: int, n_items: int, feat_dim: int, hidden_dim: int = 256,
                 n_layers: int = 3, heads: int = 8, hs_dtype: torch.dtype = torch.float32):
        super().__init__()
        if heads < 1 or hidden_dim % heads:
            raise ValueError(f"HGT needs hidden_dim a multiple of heads; got {hidden_dim}, {heads}")
        self.n_users, self.n_items, self.feat_dim = n_users, n_items, feat_dim
        self.hidden_dim, self.n_layers, self.heads, self.hs_dtype = hidden_dim, n_layers, heads, hs_dtype
        self.user_emb = nn.Parameter(torch.zeros(n_users, hidden_dim))
        self.item_proj = ItemProjection(feat_dim, hidden_dim)
        self.layers = nn.ModuleList(HGTLayer(hidden_dim, heads) for _ in range(n_layers))

    @property
    def n_nodes(self) -> int:
        return self.n_users + self.n_items

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """The draws stated in the module docstring, on the generator's
        device."""
        self.user_emb.copy_(0.1 * torch.randn(self.user_emb.shape, generator=generator,
                                              device=generator.device))
        self.item_proj.w.copy_(_uniform(self.item_proj.w.shape, 1.0 / math.sqrt(self.feat_dim), generator))
        self.item_proj.b.zero_()
        for layer in self.layers:
            layer.init_(generator)

    def node_features(self, item_feats: torch.Tensor) -> torch.Tensor:
        """concat([user_emb, item_proj(item_feats)]) -> [n_nodes, hidden], as
        `GATModel.node_features`."""
        return torch.cat([self.user_emb, self.item_proj(item_feats)], dim=0)

    def dropout_seeds(self, generator: torch.Generator) -> Optional[list]:
        """None: HGT has no dropout, so a step draws nothing more."""
        return None

    def forward(self, item_feats: torch.Tensor, graph: HeteroGraph, train: bool = False,
                seeds: Optional[Sequence[int]] = None) -> torch.Tensor:
        """`GATModel.forward`'s signature over the typed graph; `train` and
        `seeds` change nothing."""
        x = self.node_features(item_feats)
        for li, layer in enumerate(self.layers):
            x = layer(x, graph, self.hs_dtype, li)
        return x

    def config_dict(self) -> Dict[str, Any]:
        return {
            "model_family": "hgt",
            "n_users": self.n_users,
            "n_items": self.n_items,
            "feat_dim": self.feat_dim,
            "hidden_dim": self.hidden_dim,
            "n_layers": self.n_layers,
            "heads": self.heads,
        }

    @staticmethod
    def from_config(d: Dict[str, Any]) -> "HGTModel":
        return HGTModel(n_users=int(d["n_users"]), n_items=int(d["n_items"]), feat_dim=int(d["feat_dim"]),
                        hidden_dim=int(d.get("hidden_dim", 256)), n_layers=int(d.get("n_layers", 3)),
                        heads=int(d.get("heads", 8)))
